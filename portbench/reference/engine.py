# Frozen copy of the port's plain formulation (src/repro_torch/netsim/engine.py), imports
# rewritten to this package; the benchmark's reference.  Do not edit.
"""Discrete-time packet-level fat-tree simulator (counterpart of
``repro.netsim.engine``).

One tick runs five stages in the reference's order (the order is part of
the model):

  1. feedback  — ACK/NACK events due now update transport (inflight, rtx),
                 congestion control and the load balancer;
  2. RTO       — per-packet timeouts mark retransmits, report timeouts to
                 the load balancer (REPS freezing) and shrink the window;
  3. service   — every queue dequeues <= 1 packet (degraded links serve on
                 even ticks only; failed links blackhole); final-hop dequeues
                 deliver, dedupe through the receive bitmap, coalesce ACKs;
  4. arrivals  — packets due now enqueue at their next hop with FIFO
                 ranking, RED/ECN marking and tail drop;
  5. injection — each host injects <= 1 packet (round robin over its
                 eligible connections, window-limited); the load balancer
                 stamps the EV (REPS Algorithm 2).

Every size, every draw and every rounding is the reference's, so a port
state equals the JAX state leaf for leaf after every tick.  How the port
gets there with PyTorch:

  * Sentinels.  jnp's ``.at[...]`` modes ``"fill"`` (gather) and ``"drop"``
    (scatter) have no torch counterpart.  Gathers clamp the index and select
    the fill value with ``where``; scatters send dropped lanes to an extra
    sentinel row or column that is never read: the packet table is
    ``(PF, NP + 1)``, the bitmaps ``(NC + 1, MSG)``, the queue buffer
    ``(NQ + 1, QCAP)``, the free list ``(NP + 1,)``.  ``netsim.interop``
    slices them off when handing a state to numpy.
  * Duplicate-index scatters.  ``index_put_`` with repeated indices is
    nondeterministic on CUDA.  Every ``.set`` below writes unique indices
    (a served packet, an accepted queue slot, one allocation per host, one
    pick per connection); only the sentinel repeats.  The one scatter-max
    (bitmap OR) writes the constant ``True``.
  * Float rounding.  XLA on the CPU contracts the DCTCP update
    ``(1-g)*alpha + g*ecn`` into one fused multiply-add and flushes
    subnormal inputs and results to zero, while it rounds the delay-CC
    ``cwnd - beta*x`` twice; it also turns a division by a constant into a
    multiplication by the float32 reciprocal (the RED ramp, the delay
    target).  ``_fma_f32`` and the reciprocals below reproduce exactly
    that, the same way on the CPU and on the card
    (tests/test_torch_netsim.py holds each site against the jitted
    reference).
  * No host syncs.  Nothing in a tick reads a device value on the host:
    compaction is ``searchsorted`` over a running count, every shape is
    static.  The failure windows are host data, so the per-queue fault
    masks are recomputed on the host and uploaded only when the set of
    active windows changes.
  * The random draws depend on the tick, not on the state, so ``run`` makes
    them for a chunk of ticks at once (``tick_draws``), the load balancer's
    ``choose_ev`` / ``on_ack`` / ``on_timeout`` draws included; a tick
    stepped alone draws for itself and gets the same bits.  The chunk is
    ``DRAW_CHUNK`` ticks, fewer where rows x connections are many
    (``Simulator.draw_chunk``: at 10**6 connections a 256-tick chunk of
    REPS's EV draws alone would be ~1 GB).
  * Scale mode (``SimConfig(conn_sharding=True)``, the reference's sparse
    active set).  The packet table is sized by slot lifetime, not by
    connection count (NP = min(the connection rule, the lifetime bound),
    ``_active_bound``), and stages 1, 2, 4 and 6 scan it through the
    ascending active set ``as_idx (B, A)`` (``as_count (B,)`` real entries)
    instead of all NP slots: compaction runs over positions in ``as_idx``
    and maps back through it, so the compacted slot sequences are the dense
    path's; writes go through ``as_idx`` with the sentinel column taking
    the padding; injection is gated by ``as_count + rank < A``; the free
    list is pushed by position; at the tick's end the freed slots leave the
    set, the tick's allocations join it and it is sorted again.  With A ==
    NP every leaf but ``as_idx`` / ``as_count`` equals dense mode.
  * Kernels.  The segment sums and ranks, the arrivals enqueue, the ECMP
    hash and REPS's update go through ``repro_torch.kernels.ops``: on a
    CUDA device the hand-written kernel runs, on the CPU its plain version
    in ``kernels/ref.py``.  Nothing else chooses between the two.
  * Rows.  There is one tick body, ``Simulator.step_rows``, over state with a
    leading row axis B: B runs (a seed each, one load balancer) step in
    lock-step, and every kernel is one launch per tick whatever B is.  By
    default the rows share the simulator's scenario (one workload, one
    failure schedule, one watch list); given a ``ScenarioArrays`` with a
    leading row axis (``scn``), each row has its own, at the simulator's
    shapes.  Per-row gathers and scatters are one advanced index with a
    precomputed row index beside the tick's own, reductions run over the
    last axis, and the load balancer sees the rows as more connections.
    ``Simulator.run``, ``step_scenario`` and ``tick_fn`` are its B = 1 case
    (the row axis added and dropped as views);
    ``repro_torch.netsim.fleet.FleetRunner`` is its B > 1 case:

        fleet = FleetRunner(cfg, wl, make_lb("reps"), seeds=range(64))  # on the card
        states, traces = fleet.run(4000)       # leaves (64, ...), traces (4000, 64, ...)
        scn = stack_scenarios([Simulator(cfg, w, lb, failures=f).scn for w, f in rows])
        states, tel = fleet.run_summary(4000, scn=scn)   # one scenario per row

  * Events.  ``step_rows(..., events=True)`` (``step_scenario(...,
    emit_events=True)``, ``step_events``, ``step_events_rows``) also returns
    the tick's ``TickEvents`` for the flight recorder
    (``repro_torch.netsim.tracer``): each row's load-balancer decision
    counts from the traced ``LoadBalancer.step`` and the failure windows
    that open this tick.  Observation only: the state and the probe are
    bit-identical with events on or off.

  * The connection axis (scale mode over several ranks;
    ``step_rows(..., conn_axis=)``, ``step_scenario(conn_axis=)``; reference
    ``engine.py:858-903, 966-985, 1541-1552``).  ``conn_axis`` is a 1-D
    ``DeviceMesh`` (``mesh["conns"]`` of ``sharding.sweep_conn_mesh``) or a
    process group; rank ``r`` of its ``n`` owns connections ``[r * NC / n,
    (r + 1) * NC / n)``.  The nine small per-connection leaves arrive as
    that block (``(B, NC / n)``) and are all-gathered to full shape at entry
    (one packed collective) and sliced back at exit; the scenario's five
    connection tables are gathered once per scenario object and kept
    (``conn_scenario``; the reference gathers them every tick).  The
    ``(NC, MSG)`` ``c_rtx`` / ``c_rcv`` bitmaps stay with their rank as
    ``(B, NC / n + 1, MSG)``, the block plus this rank's own drop row, and
    every access goes through the ``_bm_*`` helpers: a read answers for the
    owned rows and one all-reduce (sum, ``> 0``) ORs the ranks' answers, a
    write drops on rows the rank does not own.  ``lb_state`` and every draw
    keep their full shape on every rank, so a conn-sharded run is
    bit-identical to ``conn_axis=None``.  ``shard_conn_state`` and
    ``gather_conn_state`` move a state between the two layouts; a gathered
    bitmap's drop row is False (each rank's own drop row is scratch).
    Collectives per tick: one all-gather and, without trimming, three
    all-reduces (RTO, delivery, the injection's retransmit rows; one more
    with trimming).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from . import rng
from .load_balancers import LoadBalancer
from .device import resolve_device
from . import ops as kernel_ops
from .config import INT32_MAX, SimConfig, checked_auto_pkt_slots
from .topology import Topology
from .tree import tree_map

# packet states
FREE, FLYING, QUEUED, IN_ACK, IN_NACK, LOST_WAIT = 0, 1, 2, 3, 4, 5

BIG = 2**30

# packed packet-table rows: pkt[field, slot], all int32 (bools 0/1)
PS, PCONN, PEV, PSEQ, PHOP, PCURQ, PSEND, PEVT, PECN, PORPH, PACK = range(11)
PF = 11

# fused stats vector indices
(
    ST_DROPS_CONG, ST_DROPS_FAIL, ST_TIMEOUTS, ST_DELIVERED, ST_ECN,
    ST_INJECTED, ST_UNPROC, ST_ALLOC_FAIL,
) = range(8)
N_STATS = 8

I32 = torch.int32
F32 = torch.float32
DRAW_CHUNK = 256  # ticks whose random inputs ``run`` draws in one pass, at most
DRAW_ELEMS = 2**26  # per-connection draws (ticks x rows x conns x kinds) per pass, at most
SCN_TABLES = 16  # rows' scenarios whose prepared tables a simulator keeps
# the per-connection leaves a conn axis splits (the bitmaps apart), and the
# scenario's connection tables
CONN_LEAVES = ("c_inflight", "c_next_new", "c_delivered", "c_rx_pending", "c_done",
               "c_done_tick", "c_rtx_count", "c_cwnd", "c_alpha")
SCN_CONN_TABLES = ("conn_src", "conn_dst", "conn_msg", "conn_start", "conn_dep")


@dataclasses.dataclass(frozen=True)
class Workload:
    """Static connection table (built by ``repro_torch.netsim.workloads``)."""

    src: np.ndarray  # (NC,) int32 source host
    dst: np.ndarray  # (NC,) int32 destination host
    msg_pkts: np.ndarray  # (NC,) int32 message size in packets
    start: np.ndarray  # (NC,) int32 start tick
    dep: np.ndarray  # (NC,) int32 index of prerequisite conn or -1
    name: str = "custom"

    @property
    def n_conns(self) -> int:
        return len(self.src)


# failure kind codes (FailureSchedule.kind)
K_DOWN, K_DEGRADED, K_GRAY = 0, 1, 2
KNOWN_KINDS = {K_DOWN: "down", K_DEGRADED: "degraded", K_GRAY: "gray_loss"}
GRAY_SCALE = 65536  # gray-loss drop probability is param / GRAY_SCALE


@dataclasses.dataclass(frozen=True)
class FailureSchedule:
    """Link events: kind 0 = down (blackhole), 1 = degraded to half rate,
    2 = gray loss (silent per-packet drop with probability ``param /
    GRAY_SCALE``).  A row is active at tick ``t`` iff ``start <= t < end``.
    Rows are real windows (``end > start``) or inert pads (all zero); a
    window's ``end`` is never clipped, which would resurrect the link."""

    queue: np.ndarray  # (F,) int32 queue id
    start: np.ndarray  # (F,) int32 tick
    end: np.ndarray  # (F,) int32 tick
    kind: np.ndarray  # (F,) int32
    param: np.ndarray | None = None  # (F,) int32 kind parameter

    def __post_init__(self) -> None:
        if self.param is None:
            object.__setattr__(self, "param", np.zeros((len(self.queue),), np.int32))

    def __len__(self) -> int:
        return len(self.queue)

    @staticmethod
    def none() -> "FailureSchedule":
        z = np.zeros((0,), np.int32)
        return FailureSchedule(z, z, z, z, z)

    @staticmethod
    def concat(*scheds: "FailureSchedule") -> "FailureSchedule":
        return FailureSchedule(
            *(np.concatenate([getattr(s, f) for s in scheds]).astype(np.int32)
              for f in ("queue", "start", "end", "kind", "param"))
        )

    def pad_to(self, f: int) -> "FailureSchedule":
        """Append inert rows (start == end == 0) up to ``f`` rows in total."""
        extra = f - len(self.queue)
        if extra < 0:
            raise ValueError(
                f"cannot pad a {len(self.queue)}-event schedule down to {f} rows; "
                "drop provably-dead events first (failures.truncate_dead)"
            )
        if extra == 0:
            return self
        z = np.zeros((extra,), np.int32)
        return FailureSchedule(
            *(np.concatenate([getattr(self, f).astype(np.int32), z])
              for f in ("queue", "start", "end", "kind", "param"))
        )

    def validate(self, n_queues: int | None = None) -> None:
        """Raise ``ValueError`` naming the first offending row: neither a
        real window nor an inert pad, a negative start, an unknown kind, a
        bad gray-loss parameter or a queue outside the topology."""
        s, e, q, k, p = (np.asarray(getattr(self, f))
                         for f in ("start", "end", "queue", "kind", "param"))
        live = e > s
        inert = (s == 0) & (e == 0) & (q == 0) & (k == 0) & (p == 0)
        bad = ~(live | inert)
        if bad.any():
            i = int(np.nonzero(bad)[0][0])
            raise ValueError(
                "failure rows must be real windows (end > start) or inert "
                "pads (queue == start == end == kind == param == 0); "
                f"offending rows {np.nonzero(bad)[0].tolist()} (first: row "
                f"{i} queue={int(q[i])} start={int(s[i])} end={int(e[i])} "
                f"kind={int(k[i])}) look like a clipped/truncated schedule, "
                "which would resurrect the link at the clip boundary"
            )
        if (s < 0).any():
            i = int(np.nonzero(s < 0)[0][0])
            raise ValueError(
                f"failure row {i} (queue {int(q[i])}) starts at tick "
                f"{int(s[i])}: windows cannot start before tick 0"
            )
        unknown = live & ~np.isin(k, list(KNOWN_KINDS))
        if unknown.any():
            i = int(np.nonzero(unknown)[0][0])
            raise ValueError(
                f"failure row {i} (queue {int(q[i])}, [{int(s[i])}, {int(e[i])})) "
                f"has unknown kind {int(k[i])}; known kinds: "
                + ", ".join(f"{c}={n}" for c, n in sorted(KNOWN_KINDS.items()))
            )
        bad_p = live & (
            ((k == K_GRAY) & ((p <= 0) | (p > GRAY_SCALE))) | ((k != K_GRAY) & (p != 0))
        )
        if bad_p.any():
            i = int(np.nonzero(bad_p)[0][0])
            raise ValueError(
                f"failure row {i} (queue {int(q[i])}, kind {int(k[i])}) has "
                f"param {int(p[i])}: gray-loss rows need 0 < param <= "
                f"{GRAY_SCALE}; other kinds take param == 0"
            )
        if n_queues is not None:
            bad_q = live & ((q < 0) | (q >= n_queues))
            if bad_q.any():
                i = int(np.nonzero(bad_q)[0][0])
                raise ValueError(
                    f"failure row {i} targets queue {int(q[i])}, outside "
                    f"the topology's [0, {n_queues}) queue range"
                )

    def merge(
        self, delta: "FailureSchedule", at_tick: int = 0, n_queues: int | None = None
    ) -> "FailureSchedule":
        """Append ``delta``'s live rows to this schedule after checking them:
        no row may start before ``at_tick``, overlap a down window on the
        same queue (its end would resurrect the link) or overlap a same-kind
        window (a double-scheduled event).  Rows of ``self`` are kept as
        they are, so the result equals the pre-declared composite."""
        delta.validate(n_queues)
        self.validate(n_queues)
        d_s = np.asarray(delta.start, np.int64)
        d_e = np.asarray(delta.end, np.int64)
        d_live = d_e > d_s
        if not np.all(d_s[d_live] >= at_tick):
            bad = np.nonzero(d_live & (d_s < at_tick))[0].tolist()
            raise ValueError(
                f"delta rows {bad} start before tick {at_tick}: events "
                "cannot be injected into the already-simulated past"
            )
        b_q, b_s, b_e, b_k = (np.asarray(getattr(self, f), np.int64)
                              for f in ("queue", "start", "end", "kind"))
        b_live = b_e > b_s
        d_q = np.asarray(delta.queue, np.int64)
        d_k = np.asarray(delta.kind, np.int64)
        for i in np.nonzero(d_live)[0]:
            overlap = b_live & (b_q == d_q[i]) & (b_s < d_e[i]) & (d_s[i] < b_e)
            if np.any(overlap & (b_k == K_DOWN)):
                j = np.nonzero(overlap & (b_k == K_DOWN))[0].tolist()
                raise ValueError(
                    f"delta row {int(i)} (queue {int(d_q[i])}, "
                    f"[{int(d_s[i])}, {int(d_e[i])})) overlaps existing "
                    f"down window(s) {j}: the link is already dead there, "
                    "and the delta's end tick would resurrect it"
                )
            if np.any(overlap & (b_k == d_k[i])):
                j = np.nonzero(overlap & (b_k == d_k[i]))[0].tolist()
                raise ValueError(
                    f"delta row {int(i)} (queue {int(d_q[i])}) overlaps "
                    f"same-kind window(s) {j}: double-scheduled event"
                )
            # accepted rows join the base, so a delta overlapping itself fails too
            b_q, b_s, b_e, b_k = (np.append(a, v[i]) for a, v in
                                  ((b_q, d_q), (b_s, d_s), (b_e, d_e), (b_k, d_k)))
            b_live = np.append(b_live, True)
        live_delta = FailureSchedule(
            *(np.asarray(getattr(delta, f), np.int32)[d_live]
              for f in ("queue", "start", "end", "kind", "param"))
        )
        merged = FailureSchedule.concat(self, live_delta)
        merged.validate(n_queues)
        return merged


class ScenarioArrays(NamedTuple):
    """A scenario's arrays: what rows of one simulator's shapes may vary
    (workload, failure schedule, watch list), as the reference's
    ``ScenarioArrays``.  ``Simulator.scn`` holds the simulator's own; a
    ``ScenarioArrays`` whose leaves have a leading row axis B
    (``stack_scenarios``) gives each row of ``step_rows`` its own."""

    conn_src: torch.Tensor  # (NC,) int32
    conn_dst: torch.Tensor  # (NC,) int32
    conn_msg: torch.Tensor  # (NC,) int32
    conn_start: torch.Tensor  # (NC,) int32
    conn_dep: torch.Tensor  # (NC,) int32
    host_conns: torch.Tensor  # (NH, CPH) int32, -1 padded
    watch: torch.Tensor  # (W,) int32 queue ids traced per tick
    f_queue: torch.Tensor  # (F,) int32
    f_start: torch.Tensor  # (F,) int32
    f_end: torch.Tensor  # (F,) int32
    f_kind: torch.Tensor  # (F,) int32
    f_param: torch.Tensor  # (F,) int32


def stack_scenarios(scns) -> ScenarioArrays:
    """Rows' scenarios (each a ``Simulator(...).scn`` at one set of pinned
    shapes: ``SimConfig.msg_slots``, ``conns_per_host`` and
    ``failure_slots``, one watch-list length) as one ``ScenarioArrays`` with
    a leading row axis."""
    return tree_map(lambda *leaves: torch.stack(leaves), *scns)


@dataclasses.dataclass(frozen=True)
class SimState:
    """Per-run dynamic state; field order and dtypes are the reference's.

    Four leaves carry one extra sentinel slot that absorbs dropped scatter
    lanes and is never read: ``pkt`` is ``(PF, NP + 1)``, ``qbuf`` ``(NQ +
    1, QCAP)``, ``c_rtx``/``c_rcv`` ``(NC + 1, MSG)`` and ``fl`` ``(NP +
    1,)``.  ``as_idx``/``as_count`` are the scale mode's active set
    (``(A,)`` ascending slots padded with NP, and their count); dense mode
    carries the reference's placeholders (empty and 0), so the leaf sets
    match.

    The shapes below are one run's.  The tick itself (``Simulator.step_rows``)
    takes B runs of one scenario at once: then every leaf, the load
    balancer's included, has a leading row axis B (``fl_head`` ``(B,)``,
    ``s_stats`` ``(B, N_STATS)``, ...)."""

    pkt: torch.Tensor  # (PF, NP + 1) int32 packed packet table
    qbuf: torch.Tensor  # (NQ + 1, QCAP) int32
    q_head: torch.Tensor  # (NQ,) int32
    q_len: torch.Tensor
    q_served: torch.Tensor  # cumulative serve count per queue
    c_inflight: torch.Tensor  # (NC,) int32
    c_next_new: torch.Tensor
    c_delivered: torch.Tensor
    c_rx_pending: torch.Tensor
    c_done: torch.Tensor  # (NC,) bool
    c_done_tick: torch.Tensor
    c_rtx_count: torch.Tensor
    c_rtx: torch.Tensor  # (NC + 1, MSG) bool
    c_rcv: torch.Tensor  # (NC + 1, MSG) bool
    c_cwnd: torch.Tensor  # (NC,) float32
    c_alpha: torch.Tensor  # (NC,) float32
    h_rr: torch.Tensor  # (NH,) int32
    lb_state: Any
    fl: torch.Tensor  # (NP + 1,) int32 free-slot ring
    fl_head: torch.Tensor  # () int32
    fl_count: torch.Tensor  # () int32
    s_stats: torch.Tensor  # (N_STATS,) int32 cumulative stats
    as_idx: torch.Tensor  # (A,) int32 active slots, ascending, NP-padded (dense: (0,))
    as_count: torch.Tensor  # () int32

    def replace(self, **kw) -> "SimState":
        return dataclasses.replace(self, **kw)

    @property
    def s_drops_cong(self):
        return self.s_stats[..., ST_DROPS_CONG]

    @property
    def s_drops_fail(self):
        return self.s_stats[..., ST_DROPS_FAIL]

    @property
    def s_timeouts(self):
        return self.s_stats[..., ST_TIMEOUTS]

    @property
    def s_delivered(self):
        return self.s_stats[..., ST_DELIVERED]

    @property
    def s_ecn_marks(self):
        return self.s_stats[..., ST_ECN]

    @property
    def s_injected(self):
        return self.s_stats[..., ST_INJECTED]

    @property
    def s_unprocessed(self):
        return self.s_stats[..., ST_UNPROC]

    @property
    def s_alloc_fail(self):
        return self.s_stats[..., ST_ALLOC_FAIL]


STATE_FIELDS = tuple(f.name for f in dataclasses.fields(SimState))


class TickTrace(NamedTuple):
    max_qlen: torch.Tensor
    sum_qlen: torch.Tensor
    drops: torch.Tensor
    timeouts: torch.Tensor
    delivered: torch.Tensor
    injected: torch.Tensor
    watch_qlen: torch.Tensor  # (W,)
    watch_served: torch.Tensor  # (W,) int32 0/1


class Probe(NamedTuple):
    """What a tick's telemetry reduces over (``repro_torch.netsim.telemetry``),
    derived from the rows' state before and after the tick
    (``Simulator.probe``); fields as the reference's ``Probe``, with a
    leading row axis B, except ``now``, the tick, a host int shared by the
    rows.  A quiescent tick gives an all-zero probe."""

    now: int  # the tick just executed
    q_len: torch.Tensor  # (B, NQ) int32 occupancy after the tick
    served: torch.Tensor  # (B, NQ) int32 0/1: dequeued this tick
    watch_qlen: torch.Tensor  # (B, W) int32 occupancy of watched queues
    watch_served: torch.Tensor  # (B, W) int32 0/1 for watched queues
    stats_delta: torch.Tensor  # (B, N_STATS) int32 counter increments this tick
    done_now: torch.Tensor  # (B, NC) bool: conns that completed this tick
    fct: torch.Tensor  # (B, NC) int32: done tick - start where done_now, else 0


class TickEvents(NamedTuple):
    """A tick's decision-event counts for the flight recorder
    (``repro_torch.netsim.tracer``), fields as the reference's
    ``TickEvents`` with a leading row axis B.  Observation only, and
    all-zero on a quiescent tick, like ``Probe``."""

    lb: torch.Tensor  # (B, N_TRACE_KINDS) int32 LB decision counts this tick
    fail_start: torch.Tensor  # (B,) int32: queues whose failure window opens now


class TickDraws(NamedTuple):
    """Every random input of a run of ticks, drawn from the tick keys ahead
    of the ticks (leading axis T; a fleet's draws have the row axis after it,
    see ``Simulator.tick_draws``).  The load balancer's draws are whatever
    its ``draw`` / ``draw_ack`` / ``draw_timeout`` return (``None`` when it
    draws nothing there)."""

    u_red: torch.Tensor  # (T, MAX_ARR) float32, fold 1
    u_gray: torch.Tensor | None  # (T, NQ) float32, fold 3 (None: no gray rows)
    lb: Any  # (T, ...) choose_ev's draw from fold 2
    lb_ack: Any  # (T, R, ...) on_ack's draw per round from fold(fold(tick, 4), round)
    lb_timeout: Any  # (T, ...) on_timeout's draw from fold 5

    def row(self, i: int) -> "TickDraws":
        return tree_map(lambda t: t[i], self)

    def _row_axis(self, fn, lead: int) -> "TickDraws":
        """``fn(t, axis)`` on every tensor, ``axis`` the row axis of a fleet's
        draws: ``lead`` (1 in a chunk ``(T, B, ...)``, 0 in a tick's row), one
        further in ``lb_ack`` (rounds before rows)."""
        f = lambda x, ax: tree_map(lambda t: fn(t, ax), x)
        return TickDraws(u_red=f(self.u_red, lead), u_gray=f(self.u_gray, lead),
                         lb=f(self.lb, lead), lb_ack=f(self.lb_ack, lead + 1),
                         lb_timeout=f(self.lb_timeout, lead))

    def _rows_out(self) -> "TickDraws":
        """A chunk of one row's draws without the row axis (views)."""
        return self._row_axis(lambda t, ax: t.select(ax, 0), 1)

    def _rows_in(self) -> "TickDraws":
        """One run's tick of draws as a one-row tick (views)."""
        return self._row_axis(lambda t, ax: t.unsqueeze(ax), 0)


# ---------------------------------------------------------------------------
# float32 arithmetic as XLA:CPU rounds it
_TINY = 2.0**-126  # smallest normal float32


def _daz(x: torch.Tensor) -> torch.Tensor:
    """Subnormal float32 inputs read as zero (XLA:CPU sets DAZ)."""
    return torch.where(x.abs() < _TINY, 0.0, x)


def _fma_f32(a: float, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * x + c`` rounded once, as XLA contracts it into a fused
    multiply-add, with XLA:CPU's flush of subnormal inputs and results.

    ``a`` is a float32 value, so ``a * x`` is exact in float64 (24 + 24 bits).
    The float64 sum is rounded to odd (TwoSum gives its error; an inexact
    sum with an even last bit steps one ulp toward the error), and a
    float64 rounded to odd rounds to float32 exactly as the exact sum would
    (53 >= 24 + 2 bits).  A result that is tiny before float32 rounding — at
    24 bits with unbounded exponent, the x86 rule — is flushed to zero."""
    x64 = _daz(x).double()
    c64 = _daz(c).double()
    p = x64 * a
    s = p + c64
    pp = s - c64
    err = (p - pp) + (c64 - (s - pp))
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    tiny = (s * 2.0**64).to(F32).abs() < _TINY * 2.0**64
    return torch.where(tiny, 0.0, s.to(F32))


def _f32(v: float) -> float:
    """The float32 value XLA uses for a python float constant."""
    return float(np.float32(v))


def add_rows(x):
    """A one-run state, trace or tick's draws as one row: a leading row axis
    of length 1 on every tensor, as a view."""
    return tree_map(lambda t: t[None], x)


def drop_rows(x):
    """The inverse of ``add_rows``: row 0 of every tensor, as a view."""
    return tree_map(lambda t: t[0], x)


@dataclasses.dataclass(frozen=True)
class ConnShard:
    """This rank's place on a connection axis: the axis's process
    ``group``, the rank's index on it and the axis's size."""

    group: Any
    rank: int
    size: int

    @classmethod
    def of(cls, axis) -> "ConnShard | None":
        """The axis given as a 1-D ``DeviceMesh`` or a process group (or
        None: no axis)."""
        if axis is None or isinstance(axis, ConnShard):
            return axis
        if isinstance(axis, str):
            raise TypeError(f"conn_axis={axis!r}: the port's conn axis is the ranks it spans "
                            "(mesh['conns'] of sharding.sweep_conn_mesh, or a process group), "
                            "not a mesh-axis name")
        import torch.distributed as dist

        group = axis.get_group() if hasattr(axis, "get_group") else axis
        return cls(group, dist.get_rank(group), dist.get_world_size(group))

    def block(self, nc: int) -> tuple[int, int]:
        """``(offset, length)`` of this rank's block of ``nc`` connections."""
        if nc % self.size:
            raise ValueError(f"{nc} connections do not split over {self.size} ranks")
        n = nc // self.size
        return self.rank * n, n


def _pack_i32(xs) -> torch.Tensor:
    """Equal-shape int32 / bool / float32 tensors stacked as int32 (floats
    by their bits), for one collective."""
    return torch.stack([x.view(I32) if x.dtype == F32 else x.to(I32) for x in xs])


def _unpack_i32(packed: torch.Tensor, likes) -> list[torch.Tensor]:
    return [p.view(F32) if l.dtype == F32 else p.to(l.dtype) for p, l in zip(packed, likes)]


def gather_conns(xs, conn_axis) -> list[torch.Tensor]:
    """Connection blocks ``(..., NC / n)`` of equal shape gathered over
    ``conn_axis`` to ``(..., NC)``, in one collective."""
    raise NotImplementedError("the reference runs one rank on the arithmetic fat tree")

    ax = ConnShard.of(conn_axis)
    return _unpack_i32(all_gather_cat(_pack_i32(xs), ax.group, dim=-1), xs)


def shard_conn_state(state: SimState, conn_axis) -> SimState:
    """A full-shape rows state (leaves ``(B, ...)``) as this rank holds it on
    ``conn_axis``: the nine per-connection leaves cut to the rank's block,
    the bitmaps to the block plus a False drop row; every other leaf as it
    is."""
    ax = ConnShard.of(conn_axis)
    nc = state.c_inflight.shape[-1]
    off, n = ax.block(nc)
    cut = {k: getattr(state, k)[..., off:off + n].clone() for k in CONN_LEAVES}

    def bitmap(bm):
        out = torch.zeros((bm.shape[0], n + 1, bm.shape[2]), dtype=bm.dtype, device=bm.device)
        out[:, :n] = bm[:, off:off + n]
        return out

    return state.replace(c_rtx=bitmap(state.c_rtx), c_rcv=bitmap(state.c_rcv), **cut)


def gather_conn_state(state: SimState, conn_axis) -> SimState:
    """The inverse of ``shard_conn_state`` (collective over the axis): every
    rank gets the full-shape state, the bitmaps with a False drop row."""
    raise NotImplementedError("the reference runs one rank on the arithmetic fat tree")

    ax = ConnShard.of(conn_axis)
    full = dict(zip(CONN_LEAVES, gather_conns([getattr(state, k) for k in CONN_LEAVES], ax)))

    def bitmap(bm):
        rows = all_gather_cat(bm[:, :-1].contiguous(), ax.group, dim=1)
        return torch.cat([rows, torch.zeros_like(bm[:, :1])], dim=1)

    return state.replace(c_rtx=bitmap(state.c_rtx), c_rcv=bitmap(state.c_rcv), **full)



def _compact(mask: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """Indices of set bits of each row of ``mask (B, N)`` in ascending order,
    padded with ``N`` (binary search over the running popcount, as the
    reference); ``ranks`` is ``(B, size)`` int32 ``1..size``."""
    cs = torch.cumsum(mask, -1, dtype=I32)
    return torch.searchsorted(cs, ranks, out_int32=True)


def _get(vec: torch.Tensor, idx: torch.Tensor, fill, rows: torch.Tensor) -> torch.Tensor:
    """``vec.at[idx].get(mode="fill", fill_value=fill)`` in each row: ``vec
    (B, N)`` read at ``idx (B, K)`` (``rows``: the row of each element,
    ``_Rows.of``)."""
    n = vec.shape[-1]
    ok = (idx >= 0) & (idx < n)
    return torch.where(ok, vec[rows, idx.clamp(0, n - 1)], fill)


@dataclasses.dataclass(frozen=True)
class _Rows:
    """Index tensors and constants of a tick over ``B`` rows, made once per
    ``B`` (and index width) on the simulator's device.

    A per-row gather or scatter is one advanced index: the tick's int32
    index beside a row index.  The row indices are int64 and materialized at
    the full index shape, contiguous: the index kernel then converts only
    the tick's index (as a one-run index would), and on a CUDA device, where
    advanced indexing makes every index tensor contiguous unless their
    strides all match, nothing else is copied.  The packet table's fields
    are a slice beside the two indices, so they need no index at all."""

    B: int
    device: torch.device
    ranks: dict  # size -> (B, size) int32 1..size, the compaction targets
    inject: tuple  # (FLYING, 0, -1) rows (B, NH) of the injected packets' fixed fields
    own: "_Tables"  # the simulator's own scenario, every row the same (views)
    _index: dict = dataclasses.field(default_factory=dict)

    @staticmethod
    def make(B: int, NH: int, sizes, device, own: "_Tables") -> "_Rows":
        full = lambda v: torch.full((B, NH), v, dtype=I32, device=device)
        return _Rows(
            B=B, device=device,
            ranks={n: torch.arange(1, n + 1, dtype=I32, device=device).repeat(B, 1)
                   for n in sizes},
            inject=(full(FLYING), full(0), full(-1)),
            own=own.expand(B),
        )

    def _iota(self, shape: tuple, axis: int) -> torch.Tensor:
        """``arange(shape[axis])`` along ``axis``, materialized at ``shape``
        (int64, contiguous), made once."""
        t = self._index.get((shape, axis))
        if t is None:
            view = [1] * len(shape)
            view[axis] = shape[axis]
            ar = torch.arange(shape[axis], dtype=torch.int64, device=self.device)
            t = self._index[(shape, axis)] = ar.view(view).expand(shape).contiguous()
        return t

    def of(self, idx: torch.Tensor) -> torch.Tensor:
        """The row of each element of a ``(B, K)`` index."""
        return self._iota((self.B, idx.shape[-1]), 0)

    def col(self, idx: torch.Tensor) -> torch.Tensor:
        """The column of each element of a ``(B, K)`` index."""
        return self._iota((self.B, idx.shape[-1]), 1)

    def pkt_get(self, pkt: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Every field of slots ``idx (B, K)`` of each row's packet table
        ``pkt (B, PF, NP + 1)``: ``(PF, B, K)``, one gather."""
        return pkt.transpose(0, 1)[:, self.of(idx), idx]

    def pkt_set(self, pkt: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> None:
        """``pkt_get``'s scatter, in place: slots unique within a row stay
        unique across rows, and only the sentinel column ``NP`` repeats."""
        pkt.transpose(0, 1)[:, self.of(idx), idx] = rows


@dataclasses.dataclass
class _Tables:
    """A scenario's arrays as the tick reads them, every leaf with a leading
    row axis B: a ``ScenarioArrays`` of B rows, each row's own, or the
    simulator's own scenario as ``(B, ...)`` views of its one row (stride 0
    on the row axis, nothing copied).  Made once per scenario on the
    simulator's device, with the clamped indices int64 for ``torch.gather``
    so that no tick converts or copies them.  The failure schedule stays on
    the host (``f``, numpy ``(n, F)``, n = 1 for the shared scenario, else
    B): the tick's fault masks are recomputed there and uploaded only when
    the active set changes."""

    B: int
    src: torch.Tensor  # (B, NC) int32
    dst: torch.Tensor
    msg: torch.Tensor
    start: torch.Tensor
    no_dep: torch.Tensor  # (B, NC) bool
    dep: torch.Tensor  # (B, NC) int64: the prerequisite, clamped
    hc: torch.Tensor  # (B, NH, CPH) int32, -1 padded
    hc_safe: torch.Tensor  # (B, NH * CPH) int64, clamped
    hc_valid: torch.Tensor  # (B, NH, CPH) bool
    watch: torch.Tensor  # (B, W) int64
    f: tuple  # (queue, start, end, kind, param) numpy int32 (n, F)
    has_gray: bool  # some row has a gray-loss window
    fault_key: bytes | None = None
    faults: tuple | None = None
    fail_starts: dict | None = None  # tick -> (n,) int32 windows opening then, per row

    @staticmethod
    def make(scn: "ScenarioArrays", f: tuple) -> "_Tables":
        """``scn``'s leaves with a leading row axis, ``f`` its host schedule."""
        B, NC = scn.conn_src.shape
        NH, CPH = scn.host_conns.shape[1:]
        clamp = lambda x: x.clamp(0, max(NC - 1, 0)).long()
        return _Tables(
            B=B, src=scn.conn_src, dst=scn.conn_dst, msg=scn.conn_msg,
            start=scn.conn_start, no_dep=scn.conn_dep < 0, dep=clamp(scn.conn_dep),
            hc=scn.host_conns, hc_safe=clamp(scn.host_conns.reshape(B, NH * CPH)),
            hc_valid=scn.host_conns >= 0, watch=scn.watch.long(), f=f,
            has_gray=_has_gray(f),
        )

    def expand(self, B: int) -> "_Tables":
        """A one-row table's leaves as ``(B, ...)`` views, with a fault-mask
        cache of its own."""
        ex = lambda t: t.expand(B, *t.shape[1:])
        return dataclasses.replace(
            self, B=B, fault_key=None, faults=None, fail_starts=None,
            **{k: ex(getattr(self, k)) for k in (
                "src", "dst", "msg", "start", "no_dep", "dep", "hc", "hc_safe",
                "hc_valid", "watch")})


class Simulator:
    """Builds and runs one simulation scenario on one device.

    Static structure (config, topology, connection table, failures, watch
    list) lives on the instance; the per-run state is a ``SimState`` that
    ``tick_fn`` maps to the next one without changing its argument.
    """

    def __init__(
        self,
        cfg: SimConfig,
        workload: Workload,
        lb: LoadBalancer,
        failures: FailureSchedule | None = None,
        watch_queues: np.ndarray | None = None,
        seed: int = 0,
        device=None,
    ):
        self.device = dev = resolve_device(device)
        self.cfg = cfg
        self.topo = Topology.build(cfg)
        self.wl = workload
        self.lb = lb
        self.failures = failures or FailureSchedule.none()
        if cfg.failure_slots:
            self.failures = self.failures.pad_to(cfg.failure_slots)
        self.failures.validate(self.topo.n_queues)
        self.seed = seed

        NC = workload.n_conns
        msg_max = int(workload.msg_pkts.max()) if NC else 1
        if msg_max > cfg.max_msg_pkts:
            raise ValueError(f"message of {msg_max} pkts exceeds max_msg_pkts={cfg.max_msg_pkts}")
        auto_msg = int(min(cfg.max_msg_pkts, max(int(2 ** np.ceil(np.log2(max(msg_max, 2)))), 2)))
        if cfg.msg_slots and cfg.msg_slots < auto_msg:
            raise ValueError(f"msg_slots={cfg.msg_slots} < required bitmap width {auto_msg}")
        self.MSG = int(cfg.msg_slots) if cfg.msg_slots else auto_msg
        self.NQ = self.topo.n_queues
        self.NH = cfg.n_hosts
        if cfg.conn_sharding:
            # scale mode: live slots are bounded by slot lifetime (injection
            # admits <= NH per tick, each slot frees within one lifetime), not
            # by NC * max_cwnd; at figure sizes the connection rule is smaller
            bound = self._active_bound()
            conn_auto = int(2 ** np.ceil(np.log2(NC * cfg.max_cwnd_pkts + 4 * self.NH + 64)))
            self.NP = int(cfg.pkt_slots) if cfg.pkt_slots else min(conn_auto, bound)
            if self.NP > INT32_MAX:
                raise ValueError(
                    f"pkt_slots={self.NP} exceeds the int32 slot namespace (max {INT32_MAX})")
            self.A = min(int(cfg.active_slots) if cfg.active_slots else bound, self.NP)
        else:
            # dense mode: the connection rule, checked against int32 in python ints
            self.NP = checked_auto_pkt_slots(NC, cfg.max_cwnd_pkts, self.NH, pin=cfg.pkt_slots)
            self.A = 0
        # MAX_ARR sets the shape of the per-arrival RED draw: kept exactly
        self.MAX_ARR = self.NQ + self.NH
        # tight per-tick event bounds (ACKs come only from the NH final-hop
        # queues; trim NACKs only with trimming) and the free bound
        self.MAX_EV = self.NH + (self.MAX_ARR if cfg.trimming else 0)
        self.MAX_FREE = self.MAX_EV + self.NQ + self.MAX_ARR + self.NH
        widest = max(
            (cfg.feedback_rounds + 1) * (NC + 1),
            (NC + 1) * (self.MAX_EV + 1),
            (self.NQ + 1) * (self.MAX_ARR + 1),
        )
        if widest > INT32_MAX:
            raise ValueError(
                f"per-tick segment-id space overflows int32: n_conns={NC}, "
                f"n_queues={self.NQ} -> widest id {widest} > {INT32_MAX}"
            )

        # host -> local conn table (stable by conn id within each host)
        src = np.asarray(workload.src, np.int64)
        counts = np.bincount(src, minlength=self.NH) if NC else np.zeros(self.NH, np.int64)
        auto_cph = int(max(1, counts.max())) if NC else 1
        if cfg.conns_per_host and cfg.conns_per_host < auto_cph:
            raise ValueError(f"conns_per_host={cfg.conns_per_host} < required {auto_cph}")
        self.CPH = int(cfg.conns_per_host) if cfg.conns_per_host else auto_cph
        hc = np.full((self.NH, self.CPH), -1, np.int32)
        if NC:
            order = np.argsort(src, kind="stable")
            starts = np.zeros(self.NH, np.int64)
            starts[1:] = np.cumsum(counts)[:-1]
            hc[src[order], np.arange(NC) - starts[src[order]]] = order

        t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
        self.host_conns = t(hc)
        self.conn_src = t(workload.src)
        self.conn_dst = t(workload.dst)
        self.conn_msg = t(workload.msg_pkts)
        self.conn_start = t(workload.start)
        self.conn_dep = t(workload.dep)
        if watch_queues is None:
            watch_queues = self.topo.t0_up_queues(0)[: cfg.n_watch_queues]
        self.watch = t(watch_queues)
        fs = self.failures
        self.scn = ScenarioArrays(
            conn_src=self.conn_src, conn_dst=self.conn_dst, conn_msg=self.conn_msg,
            conn_start=self.conn_start, conn_dep=self.conn_dep, host_conns=self.host_conns,
            watch=self.watch, f_queue=t(fs.queue), f_start=t(fs.start), f_end=t(fs.end),
            f_kind=t(fs.kind), f_param=t(fs.param),
        )
        f_host = tuple(np.asarray(getattr(fs, k), np.int32)[None]
                       for k in ("queue", "start", "end", "kind", "param"))
        self._own = _Tables.make(add_rows(self.scn), f_host)  # one row; _Rows expands it
        # id(scn) -> (scn, its _Tables): rows' scenarios given to the tick,
        # the newest SCN_TABLES of them, so that a caller alternating a few
        # prepares each once
        self._scn_tables: dict[int, tuple] = {}
        self._conn_scns: dict[int, tuple] = {}

        # constants reused every tick
        self._qid = torch.arange(self.NQ, dtype=I32, device=dev)
        self._cph = torch.arange(self.CPH, dtype=I32, device=dev)
        self._ones_nc = torch.ones((NC,), dtype=F32, device=dev)
        # scatter values on the device: a Python scalar would be copied from
        # the host, and that copy synchronizes the stream
        self._true = torch.ones((), dtype=torch.bool, device=dev)
        self._false = torch.zeros((), dtype=torch.bool, device=dev)
        self._zero = torch.zeros((), dtype=I32, device=dev)
        self._red_rcp = _f32(np.float32(1.0) / np.float32(cfg.kmax - cfg.kmin))

        self._row_consts: dict[int, _Rows] = {}  # B -> the tick's row indices
        self._event_zero: dict[int, torch.Tensor] = {}  # B -> (B,) int32 zeros

        self.base_key = rng.PRNGKey(seed, device=dev)

    # ------------------------------------------------------------------
    def _active_bound(self) -> int:
        """Power-of-two bound on the slots allocated at once in scale mode:
        injection admits <= NH packets per tick and a slot frees within one
        lifetime of its send (RTO, the ACK and NACK delays, and per hop the
        latency plus a full queue at degraded half rate), as the
        reference's.  LOST_WAIT slots of finished connections can outlive
        it; then injection alloc-fails, counted in ``s_alloc_fail``."""
        cfg = self.cfg
        lifetime = (cfg.rto_ticks + cfg.ack_delay_ticks + cfg.nack_delay_ticks
                    + self.topo.diameter * (cfg.hop_latency_ticks + 2 * cfg.queue_capacity))
        raw = self.NH * lifetime + 4 * self.NH + 64
        return int(2 ** np.ceil(np.log2(max(raw, 2))))

    def draw_chunk(self, B: int) -> int:
        """Ticks whose random inputs ``run_rows`` (and the fleet's and the
        sweep's loops) draw in one pass for ``B`` rows: ``DRAW_CHUNK``, fewer
        where the per-connection draws of one pass would pass
        ``DRAW_ELEMS``.  Every draw is keyed by its tick, so the chunk
        changes no bit."""
        per_tick = max(B, 1) * max(self.wl.n_conns, 1) * (self.cfg.feedback_rounds + 2)
        return max(1, min(DRAW_CHUNK, DRAW_ELEMS // per_tick))

    def init_state(self, key: torch.Tensor | None = None, device=None) -> SimState:
        dev = self.device if device is None else resolve_device(device)
        if dev != self.device:
            raise ValueError(f"this simulator lives on {self.device}, not {dev}")
        NP, NQ, NC, NH, cfg = self.NP, self.NQ, self.wl.n_conns, self.NH, self.cfg
        key = self.base_key if key is None else key
        z = lambda *shape, dtype=I32: torch.zeros(shape, dtype=dtype, device=dev)
        return SimState(
            pkt=z(PF, NP + 1),
            qbuf=z(NQ + 1, cfg.queue_capacity),
            q_head=z(NQ),
            q_len=z(NQ),
            q_served=z(NQ),
            c_inflight=z(NC),
            c_next_new=z(NC),
            c_delivered=z(NC),
            c_rx_pending=z(NC),
            c_done=z(NC, dtype=torch.bool),
            c_done_tick=torch.full((NC,), -1, dtype=I32, device=dev),
            c_rtx_count=z(NC),
            c_rtx=z(NC + 1, self.MSG, dtype=torch.bool),
            c_rcv=z(NC + 1, self.MSG, dtype=torch.bool),
            c_cwnd=torch.full((NC,), float(cfg.init_cwnd_pkts), dtype=F32, device=dev),
            c_alpha=z(NC, dtype=F32),
            h_rr=z(NH),
            lb_state=self.lb.init_state(NC, rng.fold_in(key, 777)),
            fl=torch.arange(NP + 1, dtype=I32, device=dev),
            fl_head=z(),
            fl_count=torch.full((), NP, dtype=I32, device=dev),
            s_stats=z(N_STATS),
            as_idx=torch.full((self.A,), NP, dtype=I32, device=dev),
            as_count=z(),
        )

    # ------------------------------------------------------------------
    def _cc_on_ack(self, cwnd, alpha, mask, ecn, rtt):
        """Per-ACK CC update (DCTCP variant per §4.1 / MPRDMA), rounded as
        XLA rounds the reference (see ``_fma_f32``)."""
        cfg = self.cfg
        inv = lambda num, x: torch.div(self._ones_nc * num, torch.clamp(x, min=1.0))
        if cfg.cc == "dctcp":
            g = cfg.dctcp_g
            # (1-g)*alpha + g*ecn: one FMA in XLA; g*ecn is exact (ecn is 0/1)
            new_alpha = _fma_f32(_f32(1 - g), alpha, ecn.to(F32) * _f32(g))
            alpha = torch.where(mask, new_alpha, alpha)
            up = cwnd + inv(1.0, cwnd)
            down = cwnd - alpha * 0.5  # alpha / 2.0 is exact either way
            cwnd = torch.where(mask, torch.where(ecn, down, up), cwnd)
        elif cfg.cc == "eqds":
            up = cwnd + inv(4.0, cwnd)
            down = cwnd - 0.5
            cwnd = torch.where(mask, torch.where(ecn, down, up), cwnd)
            cwnd = torch.clamp(cwnd, max=float(cfg.init_cwnd_pkts))
        elif cfg.cc == "delay":
            t = float(cfg.delay_target_ticks)
            # (rtt - t) / t: XLA multiplies by the float32 reciprocal of t
            over = (rtt.to(F32) - t) * _f32(np.float32(1.0) / np.float32(t))
            up = cwnd + inv(1.0, cwnd)
            # cwnd - beta * clip(over): XLA keeps the multiply and the
            # subtract apart here (two roundings), unlike the DCTCP add
            down = cwnd - torch.clamp(over, 0.0, 1.0) * _f32(cfg.delay_beta)
            cwnd = torch.where(mask, torch.where(over > 0, down, up), cwnd)
        else:
            raise ValueError(cfg.cc)
        return torch.clamp(cwnd, 1.0, float(cfg.max_cwnd_pkts)), alpha

    # -- (B, NC + 1, MSG) bitmaps with a sentinel row ----------------------
    # On a conn axis (``ax``, a ``ConnShard``) a bitmap is this rank's block
    # ``(B, NC / n + 1, MSG)`` with its own drop row, and the helpers below
    # answer for the whole axis (reference ``engine.py:858-903``); with
    # ``ax`` None each is the dense expression it stands for.
    def _bm_local(self, bmap, conns, ax: ConnShard):
        """Row of ``conns`` in this rank's block (its drop row where it owns
        none) and whether it owns it."""
        n = bmap.shape[1] - 1
        loc = conns - ax.rank * n
        inr = (loc >= 0) & (loc < n)
        return torch.where(inr, loc, n), inr

    def _bm_gets(self, bmaps, conns, seqs, R: _Rows, ax: ConnShard | None = None):
        """``bmap.at[conns, seqs].get(mode="fill", fill_value=True)`` in each
        row, for each of ``bmaps`` (read at the same lanes: on a conn axis
        one all-reduce answers for all of them)."""
        NC, MSG = self.wl.n_conns, self.MSG
        ok = (conns >= 0) & (conns < NC) & (seqs >= 0) & (seqs < MSG)
        s = seqs.clamp(0, MSG - 1)
        if ax is None:
            return tuple(torch.where(ok, bm[R.of(conns), conns.clamp(0, NC), s], True)
                         for bm in bmaps)
        raise NotImplementedError("the reference runs one rank on the arithmetic fat tree")

        loc, inr = self._bm_local(bmaps[0], conns, ax)
        got = torch.stack([bm[R.of(conns), loc, s] & inr for bm in bmaps])
        hit = all_reduce_sum(got, ax.group) > 0
        return tuple(torch.where(ok, h, True) for h in hit)

    def _bm_get(self, bmap, conns, seqs, R: _Rows, ax: ConnShard | None = None):
        return self._bm_gets((bmap,), conns, seqs, R, ax)[0]

    def _bm_or(self, bmap, conns, seqs, vals, R: _Rows, ax: ConnShard | None = None):
        """``bmap.at[conns, seqs].max(vals, mode="drop")`` in place, in each
        row: only the constant True is written, so repeated indices are
        harmless."""
        NC = self.wl.n_conns
        hit = vals & (conns >= 0) & (conns < NC)
        if ax is None:
            row = torch.where(hit, conns, NC)
        else:
            loc, inr = self._bm_local(bmap, conns, ax)
            row = torch.where(hit & inr, loc, bmap.shape[1] - 1)
        bmap[R.of(conns), row, seqs.clamp(0, self.MSG - 1)] = self._true

    def _bm_rows(self, bmap, rows, conns, ax: ConnShard | None = None):
        """``bmap[rows, conns]``: whole ``(..., MSG)`` rows of in-range
        connections (on a conn axis, one all-reduce)."""
        if ax is None:
            return bmap[rows, conns]
        raise NotImplementedError("the reference runs one rank on the arithmetic fat tree")

        loc, inr = self._bm_local(bmap, conns, ax)
        return all_reduce_sum(bmap[rows, loc] & inr[..., None], ax.group) > 0

    def _bm_set_false(self, bmap, rows, conns, seqs, mask, ax: ConnShard | None = None):
        """``bmap.at[conns, seqs].set(False)`` where ``mask`` holds (in-range
        connections), dropped elsewhere and on rows another rank owns."""
        if ax is None:
            row = torch.where(mask, conns, self.wl.n_conns)
        else:
            loc, inr = self._bm_local(bmap, conns, ax)
            row = torch.where(mask & inr, loc, bmap.shape[1] - 1)
        bmap[rows, row, seqs] = self._false

    def conn_scenario(self, scn: ScenarioArrays | None, conn_axis) -> ScenarioArrays | None:
        """``scn`` with its five connection tables at full width: gathered
        over ``conn_axis`` where they are a rank's block (once per ``scn``
        object, kept while it is among the newest ``SCN_TABLES``), as they
        are where they already are full, or None for the simulator's own."""
        if scn is None or scn is self.scn or scn.conn_src.shape[-1] == self.wl.n_conns:
            return scn
        hit = self._conn_scns.pop(id(scn), None)
        if hit is None or hit[0] is not scn:
            ax = ConnShard.of(conn_axis)
            full = gather_conns([getattr(scn, k) for k in SCN_CONN_TABLES], ax)
            hit = (scn, scn._replace(**dict(zip(SCN_CONN_TABLES, full))))
            if len(self._conn_scns) >= SCN_TABLES:
                del self._conn_scns[next(iter(self._conn_scns))]
        self._conn_scns[id(scn)] = hit
        return hit[1]

    # ------------------------------------------------------------------
    def _tables(self, scn: ScenarioArrays | None, B: int) -> _Tables:
        """The tick's view of ``scn`` for ``B`` rows: the simulator's own
        scenario for ``None`` (or ``self.scn``), else ``scn``'s rows (a
        ``ScenarioArrays`` with a leading row axis, or one scenario, taken as
        one row), checked against this simulator's shapes and prepared once
        per ``scn`` object while it is among the newest ``SCN_TABLES``."""
        if scn is None or scn is self.scn:
            return self._rows(B).own
        hit = self._scn_tables.pop(id(scn), None)
        if hit is None or hit[0] is not scn:
            hit = (scn, self._make_tables(scn))
            if len(self._scn_tables) >= SCN_TABLES:
                del self._scn_tables[next(iter(self._scn_tables))]  # the least recent
        self._scn_tables[id(scn)] = hit  # the most recent last
        if hit[1].B != B:
            raise ValueError(f"scn has {hit[1].B} rows, the state {B}")
        return hit[1]

    def _make_tables(self, scn: ScenarioArrays) -> _Tables:
        if not isinstance(scn, ScenarioArrays):
            raise TypeError(f"scn must be a ScenarioArrays, got {type(scn).__name__}")
        if scn.conn_src.dim() == 1:
            scn = add_rows(scn)
        B = scn.conn_src.shape[0]
        NC, NH, CPH = self.wl.n_conns, self.NH, self.CPH
        W, F = self.watch.shape[0], len(self.failures)
        want = dict(conn_src=(NC,), conn_dst=(NC,), conn_msg=(NC,), conn_start=(NC,),
                    conn_dep=(NC,), host_conns=(NH, CPH), watch=(W,), f_queue=(F,),
                    f_start=(F,), f_end=(F,), f_kind=(F,), f_param=(F,))
        for name, shape in want.items():
            x = getattr(scn, name)
            on_dev = x.device.type == self.device.type and self.device.index in (
                None, x.device.index)  # "cuda" without an index: any card
            if x.shape != (B, *shape) or x.dtype != I32 or not on_dev:
                raise ValueError(
                    f"scn.{name}: this simulator's rows take int32 {(B, *shape)} on "
                    f"{self.device} (NC={NC}, NH={NH}, CPH={CPH}, W={W}, F={F}), got "
                    f"{x.dtype} {tuple(x.shape)} on {x.device}; build every row's Simulator at "
                    "the same pinned msg_slots, conns_per_host and failure_slots and one "
                    "watch-list length")
        # one host copy per scenario, never per tick: the message sizes and
        # the failure schedule (the tick's fault masks are made on the host)
        f = tuple(getattr(scn, k).cpu().numpy() for k in
                  ("f_queue", "f_start", "f_end", "f_kind", "f_param"))
        msg_max = int(scn.conn_msg.max()) if NC else 0
        if msg_max > self.MSG:
            raise ValueError(f"scn: a row's message of {msg_max} packets exceeds this "
                             f"simulator's bitmap width MSG={self.MSG} (pin msg_slots)")
        for b in range(B):
            FailureSchedule(*(a[b] for a in f)).validate(self.NQ)
        return _Tables.make(tree_map(torch.Tensor.contiguous, scn), f)

    def _fault_masks(self, now: int, tab: _Tables):
        """Per-queue fault masks of the windows active at ``now``: (down,
        degraded, gray drop parameter or None, adaptive-routing penalty),
        each ``(B, NQ)`` (views of one row for a shared scenario).  Computed
        on the host from the schedule and uploaded only when the active set
        changes."""
        queue, start, end, kind, param = tab.f
        act = (now >= start) & (now < end)
        key = act.tobytes()
        if key != tab.fault_key:
            NQ = self.NQ
            row = np.broadcast_to(np.arange(queue.shape[0])[:, None], queue.shape)
            ok = act & (queue >= 0) & (queue < NQ)

            def mask(code):
                m = np.zeros((queue.shape[0], NQ), bool)
                sel = ok & (kind == code)
                m[row[sel], queue[sel]] = True
                return m

            down, degraded = mask(K_DOWN), mask(K_DEGRADED)
            gray = np.zeros((queue.shape[0], NQ), np.int32)
            g = ok & (kind == K_GRAY)
            np.maximum.at(gray, (row[g], queue[g]), param[g])
            t = lambda a: torch.as_tensor(a, device=self.device).expand(tab.B, NQ)
            tab.faults = (
                t(down) if down.any() else None,
                t(~degraded) if degraded.any() else None,
                t(gray) if tab.has_gray else None,
                t(down.astype(np.int32) * (4 * self.cfg.queue_capacity)),
            )
            tab.fault_key = key
        return tab.faults

    def _fail_start(self, now: int, tab: _Tables) -> torch.Tensor:
        """``TickEvents.fail_start``: per row, the queues whose failure
        window opens at ``now`` (any kind), each queue counted once, as the
        reference's scatter-max over the queue axis.  Computed from the host
        schedule once per scenario; a tick that opens none reads a zero
        tensor kept on the device."""
        if tab.fail_starts is None:
            queue, start, end, _, _ = tab.f
            live = (end > start) & (queue >= 0) & (queue < self.NQ)
            tab.fail_starts = {
                int(t): np.asarray([np.unique(q[on]).size for q, on in
                                    zip(queue, live & (start == t))], np.int32)
                for t in np.unique(start[live])
            }
        counts = tab.fail_starts.get(int(now))
        if counts is None:
            zero = self._event_zero.get(tab.B)
            if zero is None:
                zero = self._event_zero[tab.B] = torch.zeros((tab.B,), dtype=I32,
                                                            device=self.device)
            return zero
        return torch.as_tensor(counts, device=self.device).expand(tab.B)

    def _rows(self, B: int) -> _Rows:
        rows = self._row_consts.get(B)
        if rows is None:
            sizes = {self.MAX_EV, self.NH, self.MAX_ARR, self.MAX_FREE}
            rows = self._row_consts[B] = _Rows.make(B, self.NH, sizes, self.device, self._own)
        return rows

    def tick_draws(self, base_key: torch.Tensor, t0: int, n: int,
                   scn: ScenarioArrays | None = None) -> TickDraws:
        """The random inputs of ticks ``[t0, t0 + n)``, drawn in one pass.

        ``base_key (2,)`` gives one run's draws (leading axis T).  ``base_key
        (B, 2)`` gives B rows', row ``b`` bit for bit what key ``b`` alone
        draws (every draw is elementwise over the key axes), laid out so that
        a tick's slice is a view with the row axis first: ``(T, B, ...)``,
        and ``lb_ack`` ``(T, R, B, ...)`` so that a round is ``(B, ...)``.
        The gray-loss draw is made when the scenario (``scn``, the rows'
        own, as ``step_rows`` will be given it) has a gray-loss window."""
        if base_key.dim() == 1:
            return self.tick_draws(base_key[None], t0, n, scn)._rows_out()
        ticks = torch.arange(t0, t0 + n, dtype=torch.int64, device=self.device)
        keys = rng.fold_in(base_key[None], ticks[:, None])  # (n, B, 2) tick keys
        k_ack = rng.fold_in(rng.fold_in(keys, 4)[:, None], torch.arange(
            self.cfg.feedback_rounds, device=self.device)[None, :, None])  # (n, R, B, 2)
        NC = self.wl.n_conns
        return TickDraws(
            u_red=rng.uniform(rng.fold_in(keys, 1), (self.MAX_ARR,)),
            u_gray=(rng.uniform(rng.fold_in(keys, 3), (self.NQ,))
                    if self._tables(scn, base_key.shape[0]).has_gray
                    else None),
            lb=self.lb.draw(rng.fold_in(keys, 2), NC),
            lb_ack=self.lb.draw_ack(k_ack, NC),
            lb_timeout=self.lb.draw_timeout(rng.fold_in(keys, 5), NC),
        )

    # ------------------------------------------------------------------
    def tick_fn(self, state: SimState, tick: int, draws: TickDraws | None = None):
        return self.step_scenario(state, tick, self.base_key, draws)

    def step_scenario(
        self,
        state: SimState,
        tick: int,
        base_key: torch.Tensor,
        draws: TickDraws | None = None,
        emit_events: bool = False,
        conn_axis: str | None = None,
        scn: ScenarioArrays | None = None,
    ):
        """One tick of one run: returns the next state and the tick's trace,
        and with ``emit_events`` also its ``TickEvents`` (fields without the
        row axis); ``state`` is left unchanged.  ``draws`` is this tick's
        row of ``tick_draws(base_key, ...)`` (drawn here when omitted);
        ``scn`` one scenario at this simulator's shapes (its own by
        default).  The tick is ``step_rows`` on one row, added and dropped
        as views.  ``conn_axis``: ``state``'s per-connection leaves and
        ``scn``'s connection tables are this rank's block of the axis (see
        the module docstring)."""
        now = int(tick)
        if conn_axis is not None:
            scn = self.conn_scenario(scn, conn_axis)
        rows = (self.tick_draws(base_key[None], now, 1, scn).row(0) if draws is None
                else draws._rows_in())
        out = self.step_rows(add_rows(state), now, rows, scn, events=emit_events,
                             conn_axis=conn_axis)
        new_state, trace = drop_rows(out[0]), drop_rows(out[1])
        if not emit_events:
            return new_state, trace
        return new_state, trace, TickEvents(*drop_rows(tuple(out[2])))

    def step_rows(
        self, state: SimState, tick: int, draws: TickDraws,
        scn: ScenarioArrays | None = None, trace: bool = True, events: bool = False,
        conn_axis=None,
    ):
        """One tick of B runs at once: ``state`` has a leading row axis B on
        every leaf (its load balancer's included), ``draws`` is one tick of
        ``tick_draws`` with B base keys.  ``scn`` None: every row runs this
        simulator's scenario; else a ``ScenarioArrays`` with a leading row
        axis B, one scenario per row (``stack_scenarios``).  Every kernel is
        one launch whatever B is; ``now`` is shared.  Returns the next rows'
        state and their trace ``(B, ...)`` (None when ``trace`` is False),
        and with ``events`` a third element, the rows' ``TickEvents`` (the
        load balancer's traced ``step``; nothing else changes).  ``state``
        is left unchanged.  ``conn_axis``: the state's per-connection leaves
        are this rank's block of the axis (``shard_conn_state``), and so may
        ``scn``'s connection tables be; the returned state is laid out the
        same way (see the module docstring)."""
        now = int(tick)
        cfg, topo = self.cfg, self.topo
        NP, NQ, NH, NC = self.NP, self.NQ, self.NH, self.wl.n_conns
        QCAP = cfg.queue_capacity
        st = state
        ax = ConnShard.of(conn_axis)
        if ax is not None:
            # conn-sharded entry: the small per-connection leaves to full
            # shape in one collective; the bitmaps stay this rank's block
            off, n_loc = ax.block(NC)
            if st.c_inflight.shape[-1] != n_loc or st.c_rtx.shape[1] != n_loc + 1:
                raise ValueError(f"conn_axis: the state holds {st.c_inflight.shape[-1]} "
                                 f"connections, this rank's block is {n_loc}")
            st = st.replace(**dict(zip(CONN_LEAVES, gather_conns(
                [getattr(st, k) for k in CONN_LEAVES], ax))))
            scn = self.conn_scenario(scn, ax)
        B = st.q_len.shape[0]
        R = self._rows(B)
        T = self._tables(scn, B)
        if T.has_gray and draws.u_gray is None:
            raise ValueError("the scenario has gray-loss windows: draw with tick_draws(..., scn)")

        pkt = st.pkt.clone()  # every scatter below writes this copy in place
        c_rtx = st.c_rtx.clone()
        c_rcv = st.c_rcv.clone()
        c_inflight, c_rtx_count = st.c_inflight, st.c_rtx_count
        c_cwnd, c_alpha, lb_state = st.c_cwnd, st.c_alpha, st.lb_state
        sparse = cfg.conn_sharding
        if sparse:
            # scale mode: the packet columns of the active set (A slots); a
            # compaction's positions map back through it (``slots``)
            as_idx = st.as_idx
            asx = as_idx.clamp(max=NP - 1)
            as_valid = as_idx < NP
            asg = torch.where(as_valid, as_idx, NP)  # NP: the sentinel column
            P = R.pkt_get(st.pkt, asx)  # (PF, B, A) one gather
            p_state = torch.where(as_valid, P[PS], FREE)
            p_evt, p_conn, p_orph, p_send = P[PEVT], P[PCONN], P[PORPH], P[PSEND]
            # position A (a compaction's padding) maps to slot NP
            as_pad = torch.nn.functional.pad(as_idx, (0, 1), value=NP)
            slots = lambda pos: as_pad[R.of(pos), pos]
        else:
            p_state = st.pkt[:, PS, :NP]
            p_evt, p_conn = st.pkt[:, PEVT, :NP], st.pkt[:, PCONN, :NP]
            p_orph, p_send = st.pkt[:, PORPH, :NP], st.pkt[:, PSEND, :NP]
            slots = lambda idx: idx
        state_at_entry = p_state

        # =============== 1. feedback (ACK / NACK) =====================
        # (an empty entry of the active set reads FREE: it is never due)
        due = ((p_state == IN_ACK) | (p_state == IN_NACK)) & (p_evt == now)
        e_idx = slots(_compact(due, R.ranks[self.MAX_EV]))
        e_valid = e_idx < NP
        E = R.pkt_get(st.pkt, e_idx.clamp(max=NP - 1))  # (PF, B, MAX_EV) one gather
        e_conn = torch.where(e_valid, E[PCONN], NC)  # NC = sentinel segment
        e_is_nack = e_valid & (E[PS] == IN_NACK)
        e_is_ack = e_valid & ~e_is_nack
        e_ev = torch.where(e_valid, E[PEV], 0)
        e_ecn = e_valid & (E[PECN] == 1)
        e_cnt = torch.where(e_valid, E[PACK], 0)
        e_seq = torch.where(e_valid, E[PSEQ], 0)
        e_rtt = torch.where(e_valid, now - E[PSEND], 0)

        # one stacked segment-sum over (ACK round, conn): an ACK's round is
        # its FIFO rank among same-connection ACKs
        R_fb = cfg.feedback_rounds
        ack_seg = torch.where(e_is_ack, e_conn, NC)
        e_rank = kernel_ops.seg_rank(ack_seg, NC + 1)
        ridx = torch.clamp(e_rank, max=R_fb) * (NC + 1) + e_conn
        fields = [  # int32 and bool fields as they are: the kernel takes both
            torch.where(e_is_nack, 1, e_cnt) if cfg.trimming else e_cnt,  # dec
            e_is_ack,
            torch.where(e_is_ack, e_ev, 0),
            e_ecn & e_is_ack,
            torch.where(e_is_ack, e_rtt, 0),
        ]
        if cfg.trimming:
            already, prev_rtx = self._bm_gets((c_rcv, c_rtx), e_conn, e_seq, R, ax)
            need_rtx = e_is_nack & ~already
            self._bm_or(c_rtx, e_conn, e_seq, need_rtx, R, ax)
            fields += [need_rtx & ~prev_rtx, e_is_nack]
        tbl = kernel_ops.seg_sum(ridx, fields, (R_fb + 1) * (NC + 1)).view(
            B, len(fields), R_fb + 1, NC + 1
        )
        fb = tbl.sum(dim=2, dtype=I32)  # rank-independent totals per conn
        c_inflight = c_inflight - fb[:, 0, :NC]
        if cfg.trimming:
            c_rtx_count = c_rtx_count + fb[:, 5, :NC]
            c_cwnd = torch.clamp(c_cwnd - fb[:, 6, :NC].to(F32), 1.0, float(cfg.max_cwnd_pkts))

        # CC: up to feedback_rounds exact rounds of one ACK per conn.  The LB
        # takes the same rounds at injection (``lb.step``): no stage between
        # reads its state, and REPS then applies them all in one launch
        acks = []
        for r in range(R_fb):
            conn_mask = tbl[:, 1, r, :NC] > 0
            conn_ecn = tbl[:, 3, r, :NC] > 0
            c_cwnd, c_alpha = self._cc_on_ack(c_cwnd, c_alpha, conn_mask, conn_ecn,
                                              tbl[:, 4, r, :NC])
            acks.append((conn_mask, tbl[:, 2, r, :NC], conn_ecn, tree_map(lambda t: t[r], draws.lb_ack)))
        unprocessed = (e_is_ack & (e_rank >= R_fb)).sum(dim=-1, dtype=I32)

        # =============== 2. RTO ========================================
        # a packet fires exactly at send + rto and injection admits <= 1 per
        # host per tick, so <= NH fire per tick: compact to NH rows
        p_state = torch.where(due, FREE, p_state)
        p_orphan = p_orph == 1
        active_data = (p_state == FLYING) | (p_state == QUEUED) | (p_state == LOST_WAIT)
        conn_done_of_pkt = st.c_done[R.of(p_conn), p_conn.clamp(0, NC - 1)]
        rto = (
            active_data
            & ~p_orphan
            & ((now - p_send) >= cfg.rto_ticks)
            & ~conn_done_of_pkt
        )
        r_idx = slots(_compact(rto, R.ranks[NH]))
        timeouts_d = rto.sum(dim=-1, dtype=I32)
        r_valid = r_idx < NP
        Rp = R.pkt_get(st.pkt, r_idx.clamp(max=NP - 1))  # (PF, B, NH)
        r_conn = torch.where(r_valid, Rp[PCONN], NC)
        r_seq = torch.where(r_valid, Rp[PSEQ], 0)
        rcv_p, prev_rtx_p = self._bm_gets((c_rcv, c_rtx), r_conn, r_seq, R, ax)
        rto_need = r_valid & ~rcv_p
        self._bm_or(c_rtx, r_conn, r_seq, rto_need, R, ax)
        rsum_rto = kernel_ops.seg_sum(r_conn, (rto_need & ~prev_rtx_p, r_valid), NC + 1)
        c_rtx_count = c_rtx_count + rsum_rto[:, 0, :NC]
        rto_per_conn = rsum_rto[:, 1, :NC]
        c_inflight = c_inflight - rto_per_conn
        c_cwnd = torch.clamp(c_cwnd - rto_per_conn.to(F32), 1.0, float(cfg.max_cwnd_pkts))
        timed_out = rto_per_conn > 0  # the LB's on_timeout mask, taken at injection
        # orphan in-network packets; free LOST_WAIT ones (in scale mode the
        # active set's columns: every other slot is FREE and stays so)
        new_orph = (p_orphan | rto).to(I32)
        new_ps = torch.where(rto & (p_state == LOST_WAIT), FREE, p_state)
        if sparse:
            pkt[:, PORPH][R.of(asg), asg] = new_orph
            pkt[:, PS][R.of(asg), asg] = new_ps
        else:
            pkt[:, PORPH, :NP] = new_orph
            pkt[:, PS, :NP] = new_ps

        # =============== 3. service / dequeue ===========================
        failed_q, not_degraded, gray_p, q_penalty = self._fault_masks(now, T)
        serve = st.q_len > 0
        if not_degraded is not None and now % 2 == 1:
            serve = serve & not_degraded  # degraded links serve on even ticks
        head_pid = st.qbuf[R.of(st.q_head), R.col(st.q_head), st.q_head % QCAP]
        q_head = torch.where(serve, st.q_head + 1, st.q_head)
        q_len = torch.where(serve, st.q_len - 1, st.q_len)
        q_served = st.q_served + serve.to(I32)

        pid = torch.where(serve, head_pid, NP)  # NP = sentinel column
        # gray-dropped serves take the blackhole path (silent loss) but not
        # the adaptive-routing penalty: gray loss is invisible to switches
        lost = failed_q
        if gray_p is not None:
            gray_hit = (draws.u_gray * GRAY_SCALE).to(I32) < gray_p
            lost = gray_hit if lost is None else lost | gray_hit
        blackhole = serve & lost if lost is not None else torch.zeros_like(serve)
        is_final = serve & ~blackhole & (self._qid >= topo.t0_down_base)
        mid = serve & ~blackhole & ~is_final

        D = R.pkt_get(pkt, pid.clamp(max=NP - 1))  # (PF, B, NQ) served-packet rows
        d_orph = serve & (D[PORPH] == 1)
        drops_fail_d = (blackhole & ~d_orph).sum(dim=-1, dtype=I32)

        # deliveries (<= 1 per connection per tick).  Only host downlinks
        # deliver; every other queue's lane holds the sentinel connection NC
        # and zero flags, so the sums run over all NQ lanes of each row
        dconn = torch.where(is_final, D[PCONN], NC)
        dseq = torch.where(is_final, D[PSEQ], 0)
        was_done = _get(st.c_done, dconn, True, R.of(dconn))
        newly = is_final & ~self._bm_get(c_rcv, dconn, dseq, R, ax)
        self._bm_or(c_rcv, dconn, dseq, is_final, R, ax)
        delivered_d = newly.sum(dim=-1, dtype=I32)
        deliver_ackable = is_final & ~d_orph & ~was_done
        msg_of = _get(T.msg, dconn, BIG, R.of(dconn))
        # <= 1 delivery per conn per tick: the post-update counters are the
        # pre-update gathers plus this queue's own contribution
        del_of = _get(st.c_delivered, dconn, 0, R.of(dconn)) + newly.to(I32)
        now_done = del_of >= msg_of
        rxp = _get(st.c_rx_pending, dconn, 0, R.of(dconn)) + deliver_ackable.to(I32)
        emit = deliver_ackable & ((rxp >= cfg.ack_coalesce) | now_done)
        first_done = is_final & now_done & ~was_done
        dsum = kernel_ops.seg_sum(dconn, (newly, deliver_ackable, emit, first_done), NC + 1)
        c_delivered = st.c_delivered + dsum[:, 0, :NC]
        c_rx_pending = torch.where(dsum[:, 2, :NC] > 0, 0, st.c_rx_pending + dsum[:, 1, :NC])
        first_done_c = dsum[:, 3, :NC] > 0
        c_done = st.c_done | first_done_c
        c_done_tick = torch.where(first_done_c, now, st.c_done_tick)

        # served-packet row rewrite (one scatter): blackhole / mid / final
        d_state = torch.where(
            blackhole,
            torch.where(d_orph, FREE, LOST_WAIT),
            torch.where(mid, FLYING, torch.where(emit, IN_ACK, FREE)),
        )
        d_evt = torch.where(
            mid, now + cfg.hop_latency_ticks,
            torch.where(emit, now + cfg.ack_delay_ticks, D[PEVT]),
        )
        # D is a gathered copy; each row is rewritten from its own old value
        D[PS] = d_state
        D[PEVT] = d_evt
        D[PHOP] = torch.where(mid, D[PHOP] + 1, D[PHOP])
        D[PCURQ] = torch.where(mid, self._qid, D[PCURQ])
        D[PACK] = torch.where(emit, rxp, D[PACK])
        R.pkt_set(pkt, pid, D)

        # =============== 4. arrivals / enqueue ==========================
        if sparse:
            at = lambda f: pkt[:, f][R.of(asx), asx]
            arr = as_valid & (at(PS) == FLYING) & (at(PEVT) == now)
        else:
            arr = (pkt[:, PS, :NP] == FLYING) & (pkt[:, PEVT, :NP] == now)
        a_idx = slots(_compact(arr, R.ranks[self.MAX_ARR]))
        a_valid = a_idx < NP
        A = R.pkt_get(pkt, a_idx.clamp(max=NP - 1))  # (PF, B, MAX_ARR)
        # the routing step in one launch; NQ where ~a_valid.  Adaptive
        # switches see locally failed ports (q_penalty); hashing LBs ignore
        # q_len, which is read after service and before this tick's enqueue
        target = topo.route(
            a_idx, NP, A[PHOP], A[PCURQ], A[PCONN], A[PEV], T.src, T.dst,
            q_len, q_penalty, adaptive=self.lb.switch_adaptive,
        )
        u_red = draws.u_red

        # fused enqueue kernel: service already happened, so it serves nothing;
        # it also makes the RED mark ((pos - kmin) / (kmax - kmin), which XLA
        # multiplies by the float32 reciprocal, times pmax) and the ring slot.
        # Its accept needs no `& a_valid`: target is NQ wherever ~a_valid,
        # and the kernel accepts no target >= NQ.
        q_len, accept, mark, _, slot = kernel_ops.queue_tick(
            target, u_red, q_len, None, QCAP, cfg.kmin, cfg.kmax,
            red_rcp=self._red_rcp, pmax=cfg.pmax, q_head=q_head, qcap=QCAP,
        )
        dropd = a_valid & ~accept
        ecn_marks_d = mark.sum(dim=-1, dtype=I32)
        qbuf = st.qbuf.clone()
        qbuf[R.of(target), torch.where(accept, target, NQ), slot] = a_idx
        # congestion drops: trim -> NACK; else silent (await RTO); orphans free
        a_orph = a_valid & (A[PORPH] == 1)
        drops_cong_d = (dropd & ~a_orph).sum(dim=-1, dtype=I32)
        dstate = torch.where(a_orph, FREE, IN_NACK if cfg.trimming else LOST_WAIT)
        A[PS] = torch.where(accept, QUEUED, dstate)  # A is a gathered copy
        A[PCURQ] = torch.where(accept, target, A[PCURQ])
        A[PECN] = A[PECN] | mark.to(I32)
        if cfg.trimming:
            A[PEVT] = torch.where(dropd & ~a_orph, now + cfg.nack_delay_ticks, A[PEVT])
        R.pkt_set(pkt, a_idx, A)

        # =============== 5. injection ===================================
        dep_done = torch.gather(c_done, 1, T.dep)
        started = (now >= T.start) & (T.no_dep | dep_done)
        has_work = (c_rtx_count > 0) | (st.c_next_new < T.msg)
        can = (
            started
            & ~c_done
            & has_work
            & (c_inflight < torch.floor(c_cwnd).to(I32))
        )
        elig = torch.gather(can, 1, T.hc_safe).view(B, NH, self.CPH) & T.hc_valid
        ordr = (self._cph - st.h_rr[:, :, None]) % self.CPH
        score = torch.where(elig, ordr, BIG)
        pick_local = torch.argmin(score, dim=-1).to(I32)
        any_pick = score.min(dim=-1).values < BIG
        # free-slot allocation (ring pop)
        srank = torch.cumsum(any_pick, -1, dtype=I32) - 1
        can_alloc = srank < st.fl_count[:, None]
        if sparse:
            # the active set's capacity: as_count + fl_count == NP always, so
            # with A == NP this is the dense gate; when A binds, the overflow
            # is counted as alloc failures, never a lost slot
            can_alloc = can_alloc & ((st.as_count[:, None] + srank) < self.A)
        sendh = any_pick & can_alloc
        alloc_fail_d = (any_pick & ~can_alloc).sum(dim=-1, dtype=I32)
        n_alloc = sendh.sum(dim=-1, dtype=I32)
        slot_p = st.fl[R.of(srank), (st.fl_head[:, None] + srank) % NP]
        fl_head = (st.fl_head + n_alloc) % NP
        fl_count = st.fl_count - n_alloc

        hc_of = T.hc[R.of(pick_local), R.col(pick_local), pick_local]
        pick_conn = torch.where(sendh, hc_of, NC)
        h_rr = torch.where(sendh, (pick_local + 1) % self.CPH, st.h_rr)
        # seq selection: retransmissions first (first set bit of the row)
        pick_cc = pick_conn.clamp(0, NC - 1)
        hrow = R.of(pick_cc)
        use_rtx = c_rtx_count[hrow, pick_cc] > 0
        rtx_row = self._bm_rows(c_rtx, hrow, pick_cc, ax)
        rtx_seq = torch.argmax(rtx_row.to(torch.uint8), dim=-1).to(I32)
        seq = torch.where(use_rtx, rtx_seq, st.c_next_new[hrow, pick_cc])
        self._bm_set_false(c_rtx, hrow, pick_conn, rtx_seq, sendh & use_rtx, ax)
        # each host picks <= 1 conn and a conn lives on one host, so
        # per-conn injection counts are 0/1
        isum = kernel_ops.seg_sum(pick_conn, (sendh, sendh & use_rtx), NC + 1)
        send_mask = isum[:, 0, :NC] > 0
        c_rtx_count = c_rtx_count - isum[:, 1, :NC]
        c_next_new = st.c_next_new + (isum[:, 0] - isum[:, 1])[:, :NC]
        c_inflight = c_inflight + isum[:, 0, :NC]
        injected_d = n_alloc

        # the load balancer takes the tick's ACK rounds and timeouts, then
        # stamps the EV (REPS Algorithms 1 and 2).  Its methods work per
        # connection, so the rows are just more connections: (B, NC, ...)
        # leaves are handed over as (B * NC, ...) and taken back as they were
        conns = lambda x: _conn_rows(x, B * NC)
        evs, lb_flat, *lb_counts = self.lb.step(
            conns(lb_state),
            [(conns(m), conns(e), conns(c), conns(d)) for m, e, c, d in acks],
            conns(timed_out), conns(send_mask), (conns(draws.lb_timeout), conns(draws.lb)), now,
            rows=B if events else None,
        )
        lb_state = tree_map(lambda new, old: new.reshape(old.shape), lb_flat, lb_state)
        flying, zero, minus1 = R.inject
        W = torch.stack([
            flying,  # PS
            pick_conn,  # PCONN
            evs.view(B, NC)[hrow, pick_cc],  # PEV
            seq,  # PSEQ
            zero,  # PHOP
            minus1,  # PCURQ
            torch.full((B, NH), now, dtype=I32, device=self.device),  # PSEND
            torch.full((B, NH), now + cfg.hop_latency_ticks, dtype=I32, device=self.device),
            zero,  # PECN
            zero,  # PORPH
            zero,  # PACK
        ])
        wslot = torch.where(sendh, slot_p, NP)
        R.pkt_set(pkt, wslot, W)

        # =============== 6. free-list push ==============================
        # slots popped this tick are FLYING now, not FREE: no conflict.  The
        # push writes the contiguous (mod NP) ring segment after the live
        # entries — the reference's rotate-and-blend writes the same values
        if sparse:
            f_state = torch.where(as_valid, pkt[:, PS][R.of(asx), asx], FREE)
            freed = (f_state == FREE) & (state_at_entry != FREE)
        else:
            freed = (pkt[:, PS, :NP] == FREE) & (state_at_entry != FREE)
        f_idx = slots(_compact(freed, R.ranks[self.MAX_FREE]))
        f_val = f_idx < NP
        n_freed = f_val.sum(dim=-1, dtype=I32)
        frank = torch.cumsum(f_val, -1, dtype=I32) - 1
        fpos = ((fl_head + fl_count)[:, None] + frank) % NP
        fl = st.fl.clone()
        fl[R.of(f_idx), torch.where(f_val, fpos, NP)] = f_idx
        fl_count = fl_count + n_freed
        as_idx_new, as_count = st.as_idx, st.as_count
        if sparse:
            # active-set maintenance: the freed slots leave, the tick's
            # allocations join, ascending again (distinct slots; NP pads sort
            # last; real entries <= A by the injection gate)
            alive = f_state != FREE
            cand = torch.cat([torch.where(alive, as_idx, NP), wslot], dim=-1)
            as_idx_new = torch.sort(cand, dim=-1).values[:, : self.A]
            as_count = alive.sum(dim=-1, dtype=I32) + n_alloc

        # =============== 7. fused stats update ==========================
        s_stats = st.s_stats + torch.stack([
            drops_cong_d, drops_fail_d, timeouts_d, delivered_d,
            ecn_marks_d, injected_d, unprocessed, alloc_fail_d,
        ], dim=-1)

        if ax is not None:
            # conn-sharded exit: this rank's block of the full-shape vectors
            # every rank computed alike
            blk = lambda x: x[:, off:off + n_loc].clone()
            (c_inflight, c_next_new, c_delivered, c_rx_pending, c_done, c_done_tick,
             c_rtx_count, c_cwnd, c_alpha) = map(blk, (
                c_inflight, c_next_new, c_delivered, c_rx_pending, c_done, c_done_tick,
                c_rtx_count, c_cwnd, c_alpha))

        new_state = SimState(
            pkt=pkt, qbuf=qbuf, q_head=q_head, q_len=q_len, q_served=q_served,
            c_inflight=c_inflight, c_next_new=c_next_new, c_delivered=c_delivered,
            c_rx_pending=c_rx_pending, c_done=c_done, c_done_tick=c_done_tick,
            c_rtx_count=c_rtx_count, c_rtx=c_rtx, c_rcv=c_rcv, c_cwnd=c_cwnd,
            c_alpha=c_alpha, h_rr=h_rr, lb_state=lb_state, fl=fl, fl_head=fl_head,
            fl_count=fl_count, s_stats=s_stats, as_idx=as_idx_new, as_count=as_count,
        )
        out = (new_state, None)
        if trace:
            watched = lambda x: x.gather(1, T.watch)  # each row's watched queues
            out = (new_state, TickTrace(
                max_qlen=q_len.amax(dim=-1),
                sum_qlen=q_len.sum(dim=-1, dtype=I32),
                drops=s_stats[:, ST_DROPS_CONG] + s_stats[:, ST_DROPS_FAIL],
                timeouts=s_stats[:, ST_TIMEOUTS],
                delivered=s_stats[:, ST_DELIVERED],
                injected=s_stats[:, ST_INJECTED],
                watch_qlen=watched(q_len),
                watch_served=watched(serve).to(I32),
            ))
        if events:
            out += (TickEvents(lb=lb_counts[0], fail_start=self._fail_start(now, T)),)
        return out

    # ------------------------------------------------------------------
    def probe(self, prev: SimState, new: SimState, tick: int,
              scn: ScenarioArrays | None = None) -> Probe:
        """The tick's ``Probe`` of B rows, from their state before (``prev``)
        and after (``new``) it, as the reference's ``probe`` of each row;
        ``scn`` as ``step_rows`` was given it.  Deltas telescope: summing
        ``stats_delta`` over ticks gives the final ``s_stats``."""
        now = int(tick)
        T = self._tables(scn, new.q_len.shape[0])
        watched = lambda x: x.gather(1, T.watch)  # each row's watched queues
        done_now = new.c_done > prev.c_done  # c_done only turns on: new & ~prev
        served = new.q_served - prev.q_served
        return Probe(
            now=now,
            q_len=new.q_len,
            served=served,
            watch_qlen=watched(new.q_len),
            watch_served=watched(served),
            stats_delta=new.s_stats - prev.s_stats,
            done_now=done_now,
            fct=torch.where(done_now, now - T.start, self._zero),
        )

    def step_probe_rows(self, states: SimState, tick: int, draws: TickDraws,
                        scn: ScenarioArrays | None = None) -> tuple[SimState, Probe]:
        """``step_rows`` that returns the tick's ``Probe`` instead of its
        trace (what ``FleetRunner.run_summary`` steps); ``states`` is left
        unchanged."""
        new, _ = self.step_rows(states, tick, draws, scn, trace=False)
        return new, self.probe(states, new, tick, scn)

    def step_probe(self, state: SimState, tick: int, base_key: torch.Tensor,
                   scn: ScenarioArrays | None = None,
                   draws: TickDraws | None = None) -> tuple[SimState, Probe]:
        """One tick of one run that emits a ``Probe`` instead of a trace:
        ``step_probe_rows`` on one row, as ``step_scenario`` is
        ``step_rows``'s (the probe's tensors without the row axis)."""
        now = int(tick)
        rows = (self.tick_draws(base_key[None], now, 1, scn).row(0) if draws is None
                else draws._rows_in())
        new, probe = self.step_probe_rows(add_rows(state), now, rows, scn)
        return drop_rows(new), Probe(now, *drop_rows(tuple(probe[1:])))

    def step_events_rows(self, states: SimState, tick: int, draws: TickDraws,
                         scn: ScenarioArrays | None = None):
        """``step_probe_rows`` plus the tick's ``TickEvents`` of B rows: the
        tick body of a traced sweep.  Returns ``(states, probe, events)``."""
        new, _, events = self.step_rows(states, tick, draws, scn, trace=False, events=True)
        return new, self.probe(states, new, tick, scn), events

    def step_events(self, state: SimState, tick: int, base_key: torch.Tensor,
                    scn: ScenarioArrays | None = None, draws: TickDraws | None = None):
        """``step_probe`` plus the flight recorder's ``TickEvents``, for one
        run (the tensors without the row axis)."""
        now = int(tick)
        rows = (self.tick_draws(base_key[None], now, 1, scn).row(0) if draws is None
                else draws._rows_in())
        new, probe, events = self.step_events_rows(add_rows(state), now, rows, scn)
        return (drop_rows(new), Probe(now, *drop_rows(tuple(probe[1:]))),
                TickEvents(*drop_rows(tuple(events))))

    # ------------------------------------------------------------------
    def run_rows(self, n_ticks: int, states: SimState, base_keys: torch.Tensor,
                 scn: ScenarioArrays | None = None, t0: int = 0):
        """Run ticks ``t0 ... t0 + n_ticks - 1`` of B runs in lock-step:
        ``states`` and the returned state have a leading row axis B,
        ``base_keys`` is ``(B, 2)``, ``scn`` as ``step_rows`` takes it;
        returns ``(states, trace)`` with the ``TickTrace`` fields stacked
        ``(n_ticks, B, ...)``.  The random draws are made ``draw_chunk(B)``
        ticks at a time, for every row at once."""
        traces = []
        end = int(t0) + n_ticks
        chunk = self.draw_chunk(states.q_len.shape[0])
        for c0 in range(int(t0), end, chunk):
            n = min(chunk, end - c0)
            draws = self.tick_draws(base_keys, c0, n, scn)
            for i in range(n):
                states, tr = self.step_rows(states, c0 + i, draws.row(i), scn)
                traces.append(tr)
        if not traces:
            raise ValueError("run needs n_ticks >= 1")
        return states, TickTrace(*(torch.stack(f) for f in zip(*traces)))

    def run(self, n_ticks: int, state: SimState | None = None):
        """Run ``n_ticks`` ticks from ``state`` (a fresh state by default);
        returns ``(final_state, trace)`` with the ``TickTrace`` fields
        stacked over ticks: ``run_rows`` on one row, added once at the start
        and dropped once at the end."""
        if state is None:
            state = self.init_state()
        states, trace = self.run_rows(n_ticks, add_rows(state), self.base_key[None])
        return drop_rows(states), TickTrace(*(f[:, 0] for f in trace))


def _has_gray(f: tuple) -> bool:
    """Whether a host failure schedule ``(queue, start, end, kind, param)``
    has a live gray-loss window in some row."""
    _, start, end, kind, _ = f
    return bool(np.any((kind == K_GRAY) & (end > start)))


def _conn_rows(x, n: int):
    """A rows tree's per-connection leaves ``(B, NC, ...)`` as ``(n = B * NC,
    ...)`` views; a per-row scalar ``(B,)`` (``SwitchLB``'s branch index) as
    it is."""
    return tree_map(lambda t: t.reshape(n, *t.shape[2:]) if t.dim() >= 2 else t, x)
