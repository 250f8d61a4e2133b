# Frozen copy of the port's plain formulation (src/repro_torch/core/load_balancers.py), imports
# rewritten to this package; the benchmark's reference.  Do not edit.
"""The load-balancer zoo behind one interface (counterpart of
``repro.core.load_balancers``): ECMP, OPS and REPS, which carry the paper's
claim, and the baselines it is measured against (PLB, flowlet, MPTCP,
MPRDMA, bitmap, adaptive RoCE, Prime, SeqBalance, flowlet table), plus the
``SwitchLB`` wrapper.  ``MixedLB`` lives in ``repro_torch.netsim.mixed``.

Each load balancer is a static object holding configuration; its mutable
per-connection state is a tensor or a small dataclass of tensors (or a
tuple of them) that the engine threads through the tick:

    init_state(n_conns, key)                  -> state (on key's device)
    draw(keys, n_conns)                       -> choose_ev's draws, or None
    draw_ack(keys, n_conns)                   -> on_ack's draws, or None
    draw_timeout(keys, n_conns)               -> on_timeout's draws, or None
    choose_ev(state, mask, draw, now)         -> (evs (N,), state)
    on_ack(state, mask, ev, ecn, now, draw)   -> state
    on_timeout(state, mask, now, draw)        -> state
    step(state, acks, timeout_mask, send_mask, draws, now) -> (evs, state)
    step(..., rows=B)                         -> (evs, state, counts (B, N_TRACE_KINDS))
    trace(site, prev, new, mask, rows=1)      -> counts (rows, N_TRACE_KINDS) int32

``step`` is one tick of the load balancer as the engine calls it: ``on_ack``
for each feedback round of ``acks`` (a sequence of ``(mask, ev, ecn,
draw)``), then ``on_timeout``, then ``choose_ev``, in the reference engine's
order, with ``draws = (timeout_draw, send_draw)``.  The engine's stages
between feedback and injection never read the LB state, so the tick may
apply all of them at injection; REPS does so in one kernel launch.

``mask`` selects the connections that send / got an ACK / timed out this
tick.  Keys follow the reference's key-threading contract: the tick key
folded with 2 for sending, ``fold_in(fold_in(tick_key, 4), round)`` per
feedback round for ``on_ack`` and 5 for ``on_timeout``.

One change of shape from the reference: there each callback takes its key
and draws from it.  A counter-based draw depends only on the key, never on
the state, so here every draw is split out: ``draw`` / ``draw_ack`` /
``draw_timeout`` make it for keys with any leading axes at once (the engine
passes a chunk of ticks, ``(T, B, 2)`` or ``(T, R, B, 2)`` keys for B runs; a
single ``(2,)`` key gives one call's draw), bit-equal row by row to what the
reference draws call by call, and the callback receives one call's row.
That keeps the random number generator out of the tick's launch count.

Every method works connection by connection: no state, draw or result
mixes two connections.  A draw's first axis after the key axes is the
connection axis (``(..., N)``, ``(..., N, K)``).  So the engine hands B runs
of one scenario to a load balancer as ``B * N`` connections: ``(B, N, ...)``
leaves and draws viewed as ``(B * N, ...)``.

The flight recorder's ``trace`` port is the reference's: observation-only
decision counts from state diffs around the call sites ``"ack"``,
``"timeout"`` and ``"choose"``, every count gated on the site's mask, so
that an idle tick counts nothing.  The one change of shape: the counts are
per row, ``(rows, N_TRACE_KINDS)``, each row's sum over its connections
(the connections are ``rows`` runs of equal length, row-major), where the
reference's ``(N_TRACE_KINDS,)`` sums one run's.  ``step(..., rows=B)`` is
the traced tick: the same calls, each site's counts added, as the
reference engine adds them into its ``lb_counts``; ``trace_sites`` names
the sites an LB reports anything at, and the others are not diffed.
REPS counts inside its one ``reps_tick`` launch (the kernel's traced form).
Untraced (``rows=None``), ``step`` makes no diff and no count.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import rng
from . import reps as reps_core
from . import ops as kernel_ops
from . import ref as kernel_ref
from . import kshapes as _kernel
from .kshapes import BUF as KERNEL_BUF
from .kshapes import MAX_ROUNDS
from .tree import tree_map

I32 = torch.int32
F32 = torch.float32

# Trace-event kinds of the optional ``LoadBalancer.trace`` port (one int32
# count per kind); the tracer maps them to ring event codes, and the
# numbering is serialised into flight-recorder part files.
TR_EV_HIT = 0  # REPS: popped the oldest *valid* cached EV
TR_EV_MISS = 1  # REPS: explored a fresh uniform EV
TR_EV_RECYCLE = 2  # REPS: freezing-mode reuse of a (possibly invalid) slot
TR_EV_FREEZE = 3  # REPS: entered freezing mode (failure detected)
TR_REPATH_ACK_ECN = 4  # re-path decided from ECN feedback on ACKs
TR_REPATH_RTO = 5  # re-path decided from a retransmission timeout
TR_REPATH_FLOWLET = 6  # re-path decided from a flowlet gap expiry
TR_REPATH_EPOCH = 7  # re-path decided at an epoch / message boundary
N_TRACE_KINDS = 8
assert (_kernel.N_TRACE_KINDS, _kernel.TR_EV_HIT, _kernel.TR_EV_MISS, _kernel.TR_EV_RECYCLE,
        _kernel.TR_EV_FREEZE) == (N_TRACE_KINDS, TR_EV_HIT, TR_EV_MISS, TR_EV_RECYCLE, TR_EV_FREEZE)


def _no_counts(rows: int, device) -> torch.Tensor:
    return torch.zeros((rows, N_TRACE_KINDS), dtype=I32, device=device)


def _trace_counts(rows: int, *pairs) -> torch.Tensor:
    """``(rows, N_TRACE_KINDS)`` int32 counts from ``(kind, mask)`` pairs:
    each mask ``(rows * N,)`` summed over each row's N connections.  Every
    mask must already be gated on the site's event mask."""
    kinds = [k for k, _ in pairs]
    masks = torch.stack([m for _, m in pairs])
    out = _no_counts(rows, masks.device)
    out[:, kinds] = masks.view(len(pairs), rows, -1).sum(dim=-1, dtype=I32).T
    return out


class LoadBalancer:
    name: str = "abstract"
    switch_adaptive: bool = False

    def __init__(self, evs_size: int = 65536):
        self.evs_size = evs_size

    def init_state(self, n_conns: int, key: torch.Tensor):
        raise NotImplementedError

    def draw(self, keys: torch.Tensor, n_conns: int):
        """The randomness ``choose_ev`` takes from its fold-2 key, for keys
        ``(..., 2)`` at once; ``None`` if it draws nothing."""
        return None

    def draw_ack(self, keys: torch.Tensor, n_conns: int):
        """The randomness ``on_ack`` takes from its per-round key."""
        return None

    def draw_timeout(self, keys: torch.Tensor, n_conns: int):
        """The randomness ``on_timeout`` takes from its fold-5 key."""
        return None

    def choose_ev(self, state, mask, draw, now):
        raise NotImplementedError

    def on_ack(self, state, mask, ev, ecn, now, draw):
        return state

    def on_timeout(self, state, mask, now, draw):
        return state

    trace_sites: frozenset = frozenset()  # the sites whose trace can be nonzero

    def trace(self, site, prev, new, mask, rows: int = 1):
        """Optional observation-only trace port (flight recorder).

        ``site`` names the call just made (``"choose"`` | ``"ack"`` |
        ``"timeout"``), ``prev`` / ``new`` are the state before and after it
        and ``mask`` the event mask it received.  Returns ``(rows,
        N_TRACE_KINDS)`` int32 decision counts, each row's sum over its
        connections; pure state-diff observation, every count gated on
        ``mask``."""
        return _no_counts(rows, mask.device)

    def step(self, state, acks, timeout_mask, send_mask, draws, now, rows=None):
        """One tick: ``on_ack`` per round of ``acks``, ``on_timeout``,
        ``choose_ev``; ``draws`` is ``(timeout_draw, send_draw)``.  Returns
        ``(evs, state)``, and with ``rows`` (the rows the connections split
        into) ``(evs, state, counts)``: the sum of the three sites'
        ``trace`` counts."""
        if rows is None:
            for mask, ev, ecn, draw in acks:
                state = self.on_ack(state, mask, ev, ecn, now, draw)
            state = self.on_timeout(state, timeout_mask, now, draws[0])
            return self.choose_ev(state, send_mask, draws[1], now)
        sites = self.trace_sites
        counts = []
        for mask, ev, ecn, draw in acks:
            prev, state = state, self.on_ack(state, mask, ev, ecn, now, draw)
            if "ack" in sites:
                counts.append(self.trace("ack", prev, state, mask, rows))
        prev, state = state, self.on_timeout(state, timeout_mask, now, draws[0])
        if "timeout" in sites:
            counts.append(self.trace("timeout", prev, state, timeout_mask, rows))
        prev = state
        evs, state = self.choose_ev(state, send_mask, draws[1], now)
        if "choose" in sites:
            counts.append(self.trace("choose", prev, state, send_mask, rows))
        total = counts[0] if counts else _no_counts(rows, send_mask.device)
        for c in counts[1:]:
            total = total + c
        return evs, state, total


@dataclasses.dataclass(frozen=True)
class _State:
    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def _rand_evs(keys: torch.Tensor, n: int, evs_size: int) -> torch.Tensor:
    return rng.randint(keys, (n,), 0, evs_size)


def _conn_major(draws: torch.Tensor) -> torch.Tensor:
    """``(..., S, N)`` candidates from S split keys as ``(..., N, S)``,
    contiguous: every draw's first axis after the key axes is the
    connection axis."""
    return draws.movedim(-2, -1).contiguous()


def _f32(v: float) -> float:
    """The float32 value of a python float constant, as jnp uses it."""
    return float(np.float32(v))


def _slot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot(idx, n, dtype=bool)``: an index outside ``[0, n)``
    gives an all-false row (``torch.nn.functional.one_hot`` would raise)."""
    return idx[:, None] == torch.arange(n, dtype=idx.dtype, device=idx.device)


def _pick(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(table, idx[:, None], axis=1)[:, 0]`` for indices the
    callers keep inside ``[0, table.shape[1])``."""
    return torch.gather(table, 1, idx[:, None].long())[:, 0]


# ---------------------------------------------------------------------------
# ECMP: one static EV per connection (per-flow hashing).  §2.2
# ---------------------------------------------------------------------------
class EcmpLB(LoadBalancer):
    name = "ecmp"

    def init_state(self, n_conns, key):
        return _rand_evs(key, n_conns, self.evs_size)

    def choose_ev(self, state, mask, draw, now):
        return state, state


# ---------------------------------------------------------------------------
# OPS: uniform random EV per packet.  §2.2
# ---------------------------------------------------------------------------
class OpsLB(LoadBalancer):
    name = "ops"

    def init_state(self, n_conns, key):
        # placeholder state, as in the reference
        return torch.zeros((n_conns,), dtype=I32, device=key.device)

    def draw(self, keys, n_conns):
        return _rand_evs(keys, n_conns, self.evs_size)

    def choose_ev(self, state, mask, draw, now):
        return draw, state


# ---------------------------------------------------------------------------
# REPS (the paper).  §3
# ---------------------------------------------------------------------------
class RepsLB(LoadBalancer):
    """REPS, stepped through the fused ``reps_tick`` kernel's wrapper: one
    launch per engine tick (``step``: every ACK round, the timeouts and the
    sends), and one for each of ``on_ack``, ``on_timeout`` and
    ``choose_ev`` called alone, on a CUDA device; the kernel's plain
    version on the CPU.  The state's device alone decides.  The kernel is
    compiled for the paper's 8-deep ring, so on a CUDA device another
    ``buffer_size`` raises.

    ``step`` never calls ``on_ack``, so a subclass changes what happens
    after the ACKs through a hook instead: ``after_acks(state, now) ->
    state`` runs once after the tick's ACK rounds and before its timeouts
    and sends, at the ticks where ``after_acks_at(now)`` holds (every tick
    by default).  Such a tick takes an ACK-only launch, the hook, and the
    launch of the timeouts and sends; every other tick stays one launch.
    A subclass that overrides ``on_ack`` without defining the hook raises
    ``TypeError`` at construction, since the override would be silently
    ignored."""

    name = "reps"
    after_acks = None  # subclass hook: (state, now) -> state, see above

    def __init__(
        self,
        evs_size: int = 65536,
        buffer_size: int = 8,
        num_pkts_bdp: int = 32,
        freezing_timeout: int = 1024,
        enable_freezing: bool = True,
    ):
        cls = type(self)
        if cls.on_ack is not RepsLB.on_ack and cls.after_acks is None:
            raise TypeError(
                f"{cls.__name__} overrides on_ack, which RepsLB.step (one fused "
                "reps_tick launch per tick) never calls; define the hook "
                "after_acks(state, now) (and after_acks_at(now)) instead"
            )
        super().__init__(evs_size)
        self.cfg = reps_core.REPSConfig(
            buffer_size=buffer_size,
            evs_size=evs_size,
            num_pkts_bdp=num_pkts_bdp,
            freezing_timeout=freezing_timeout,
        )
        self.enable_freezing = enable_freezing

    def uses_kernel(self, device) -> bool:
        """Whether state on ``device`` steps through the ``reps_tick``
        kernel (CUDA) rather than its plain version (CPU); raises on CUDA
        when the ring is not the kernel's depth."""
        on_card = torch.device(device).type == "cuda"
        if on_card and self.cfg.buffer_size != KERNEL_BUF:
            raise ValueError(
                f"the reps_tick kernel is compiled for buffer depth {KERNEL_BUF}, "
                f"got {self.cfg.buffer_size}"
            )
        return on_card

    def init_state(self, n_conns, key):
        self.uses_kernel(key.device)
        return reps_core.init_state(self.cfg, n_conns, device=key.device)

    def draw(self, keys, n_conns):
        return reps_core.draw_evs(self.cfg, keys, n_conns)

    def _tick(self, state, now, ack_mask=None, ack_ev=None, ack_ecn=None,
              timeout_mask=None, send_mask=None, rand_ev=None, trace_rows=None):
        """One fused Algorithm 1+2 launch; event classes left out are
        no-ops, and the ACK classes may be sequences of rounds.  With
        ``trace_rows`` the launch also counts the rows' decisions."""
        out = kernel_ops.reps_tick(
            state.buf_ev, state.buf_valid, state.head, state.num_valid,
            state.explore_counter, state.is_freezing, state.exit_freezing,
            state.n_cached, ack_mask, ack_ev, ack_ecn, timeout_mask, send_mask,
            rand_ev, now, self.cfg.num_pkts_bdp, self.cfg.freezing_timeout,
            trace_rows=trace_rows,
        )
        return reps_core.REPSState(*out[:8]), out[8], *out[9:]

    def choose_ev(self, state, mask, draw, now):
        state, evs = self._tick(state, now, send_mask=mask, rand_ev=draw)
        return evs, state

    trace_sites = frozenset({"choose", "timeout"})

    def trace(self, site, prev, new, mask, rows=1):
        # pure REPSState diffs: choose_ev changes num_valid only by popping
        # the oldest valid EV (hit) and head only by freezing-mode reuse
        # (recycle); everything else under the mask explored
        if site == "choose":
            hit = mask & (new.num_valid < prev.num_valid)
            recycle = mask & (new.head != prev.head)
            miss = mask & ~hit & ~recycle
            return _trace_counts(rows, (TR_EV_HIT, hit), (TR_EV_RECYCLE, recycle),
                                 (TR_EV_MISS, miss))
        if site == "timeout":
            freeze = mask & new.is_freezing & ~prev.is_freezing
            return _trace_counts(rows, (TR_EV_FREEZE, freeze))
        return _no_counts(rows, mask.device)

    def on_ack(self, state, mask, ev, ecn, now, draw):
        return self._tick(state, now, ack_mask=mask, ack_ev=ev, ack_ecn=ecn)[0]

    def on_timeout(self, state, mask, now, draw):
        if not self.enable_freezing:
            return state
        return self._tick(state, now, timeout_mask=mask)[0]

    def after_acks_at(self, now: int) -> bool:
        """Whether the ``after_acks`` hook acts at tick ``now``."""
        return True

    def step(self, state, acks, timeout_mask, send_mask, draws, now, rows=None):
        rounds = [tuple(a[:3]) for a in acks]
        hooked = self.after_acks is not None and self.after_acks_at(now)
        # more rounds than one launch takes, or a hook between the ACKs and
        # the rest: ACK-only launches first (the ACK site counts nothing)
        while len(rounds) > (0 if hooked else MAX_ROUNDS):
            head, rounds = rounds[:MAX_ROUNDS], rounds[MAX_ROUNDS:]
            state = self._tick(state, now, *zip(*head))[0]
        if hooked:
            state = self.after_acks(state, now)
        masks, ack_evs, ecns = zip(*rounds) if rounds else ((), (), ())
        state, evs, *counts = self._tick(
            state, now, masks, ack_evs, ecns,
            timeout_mask=timeout_mask if self.enable_freezing else None,
            send_mask=send_mask, rand_ev=draws[1], trace_rows=rows,
        )
        return (evs, state) if rows is None else (evs, state, counts[0])


# ---------------------------------------------------------------------------
# PLB / FlowBender-style: per-connection EV, re-path when an epoch sees a
# high ECN fraction or on RTO.  Configured aggressively per the paper §4.1.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PlbState(_State):
    ev: torch.Tensor  # (N,) int32 current EV
    acks: torch.Tensor  # (N,) int32 ACKs this epoch
    marked: torch.Tensor  # (N,) int32 ECN-marked ACKs this epoch
    epoch_end: torch.Tensor  # (N,) int32 tick
    bad_epochs: torch.Tensor  # (N,) int32 consecutive congested epochs


class PlbLB(LoadBalancer):
    name = "plb"

    def __init__(
        self,
        evs_size: int = 65536,
        epoch_ticks: int = 64,
        ecn_frac_threshold: float = 0.5,
        repath_after_epochs: int = 1,  # aggressive (FlowBender-like)
    ):
        super().__init__(evs_size)
        self.epoch_ticks = epoch_ticks
        self.ecn_frac_threshold = ecn_frac_threshold
        self.repath_after_epochs = repath_after_epochs

    def init_state(self, n_conns, key):
        z = lambda: torch.zeros((n_conns,), dtype=I32, device=key.device)
        return PlbState(
            ev=_rand_evs(key, n_conns, self.evs_size), acks=z(), marked=z(),
            epoch_end=torch.full((n_conns,), self.epoch_ticks, dtype=I32, device=key.device),
            bad_epochs=z(),
        )

    def draw_ack(self, keys, n_conns):
        return _rand_evs(keys, n_conns, self.evs_size)

    def draw_timeout(self, keys, n_conns):
        return _rand_evs(keys, n_conns, self.evs_size)

    def choose_ev(self, state, mask, draw, now):
        return state.ev, state

    def on_ack(self, state, mask, ev, ecn, now, draw):
        # Reset-then-count: an epoch that has already ended is judged on its
        # own counters before this tick's ACKs count into a fresh one.
        # ceil(acks * thr) in float32, as the reference (exact below 2**24)
        epoch_over = now >= state.epoch_end
        limit = torch.ceil(state.acks.to(F32) * _f32(self.ecn_frac_threshold)).to(I32)
        frac_bad = state.marked > limit
        bad_epochs = torch.where(
            epoch_over,
            torch.where(frac_bad & (state.acks > 0), state.bad_epochs + 1, 0),
            state.bad_epochs,
        )
        acks = torch.where(epoch_over, 0, state.acks)
        marked = torch.where(epoch_over, 0, state.marked)
        epoch_end = torch.where(epoch_over, now + self.epoch_ticks, state.epoch_end)
        acks = torch.where(mask, acks + 1, acks)
        marked = torch.where(mask & ecn, marked + 1, marked)
        repath = bad_epochs >= self.repath_after_epochs
        return PlbState(
            ev=torch.where(repath, draw, state.ev), acks=acks, marked=marked,
            epoch_end=epoch_end, bad_epochs=torch.where(repath, 0, bad_epochs),
        )

    def on_timeout(self, state, mask, now, draw):
        return state.replace(ev=torch.where(mask, draw, state.ev))

    trace_sites = frozenset({"ack", "timeout"})

    def trace(self, site, prev, new, mask, rows=1):
        # the mask gate drops a repath on a round where the connection's own
        # ACK mask is false, so idle-tick epoch rollovers emit nothing
        if site == "ack":
            return _trace_counts(rows, (TR_REPATH_ACK_ECN, mask & (new.ev != prev.ev)))
        if site == "timeout":
            return _trace_counts(rows, (TR_REPATH_RTO, mask))
        return _no_counts(rows, mask.device)


# ---------------------------------------------------------------------------
# Flowlet switching: new random EV whenever the inter-send gap exceeds the
# flowlet timeout (paper sets it aggressively to RTT/2).  §4.1
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FlowletState(_State):
    ev: torch.Tensor  # (N,) int32
    last_send: torch.Tensor  # (N,) int32 tick of previous send


class FlowletLB(LoadBalancer):
    name = "flowlet"

    def __init__(self, evs_size: int = 65536, gap_ticks: int = 32):
        super().__init__(evs_size)
        self.gap_ticks = gap_ticks

    def init_state(self, n_conns, key):
        return FlowletState(
            ev=_rand_evs(key, n_conns, self.evs_size),
            last_send=torch.full((n_conns,), -(10**6), dtype=I32, device=key.device),
        )

    def draw(self, keys, n_conns):
        return _rand_evs(keys, n_conns, self.evs_size)

    def choose_ev(self, state, mask, draw, now):
        new_flowlet = mask & ((now - state.last_send) > self.gap_ticks)
        ev = torch.where(new_flowlet, draw, state.ev)
        return ev, FlowletState(ev=ev, last_send=torch.where(mask, now, state.last_send))

    trace_sites = frozenset({"choose"})

    def trace(self, site, prev, new, mask, rows=1):
        if site == "choose":
            return _trace_counts(rows, (TR_REPATH_FLOWLET, mask & (new.ev != prev.ev)))
        return _no_counts(rows, mask.device)


# ---------------------------------------------------------------------------
# MPTCP-like: K static subflow EVs per connection, packets round-robin over
# subflows; a timeout re-hashes one subflow.  Coarse model of running K QPs
# (paper §4.1 uses K=8).  CC remains shared (documented simplification).
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MptcpState(_State):
    sub_evs: torch.Tensor  # (N, K) int32
    rr: torch.Tensor  # (N,) int32 round-robin cursor


class MptcpLB(LoadBalancer):
    name = "mptcp"

    def __init__(self, evs_size: int = 65536, n_subflows: int = 8):
        super().__init__(evs_size)
        self.n_subflows = n_subflows

    def init_state(self, n_conns, key):
        return MptcpState(
            sub_evs=rng.randint(key, (n_conns, self.n_subflows), 0, self.evs_size),
            rr=torch.zeros((n_conns,), dtype=I32, device=key.device),
        )

    def draw_timeout(self, keys, n_conns):
        return rng.randint(keys, (n_conns, self.n_subflows), 0, self.evs_size)

    def choose_ev(self, state, mask, draw, now):
        ev = _pick(state.sub_evs, state.rr % self.n_subflows)
        return ev, state.replace(rr=torch.where(mask, state.rr + 1, state.rr))

    def on_timeout(self, state, mask, now, draw):
        # re-hash the subflow at the cursor for timed-out connections
        sel = mask[:, None] & _slot(state.rr % self.n_subflows, self.n_subflows)
        return state.replace(sub_evs=torch.where(sel, draw, state.sub_evs))

    trace_sites = frozenset({"timeout"})

    def trace(self, site, prev, new, mask, rows=1):
        if site == "timeout":
            return _trace_counts(rows, (TR_REPATH_RTO, mask))
        return _no_counts(rows, mask.device)


# ---------------------------------------------------------------------------
# MPRDMA-like: per-packet spraying that avoids recently ECN-marked EVs via a
# small ring of "bad" EVs (no caching of good paths — the paper's contrast).
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MprdmaState(_State):
    bad_evs: torch.Tensor  # (N, L) int32 recently marked EVs
    bad_ptr: torch.Tensor  # (N,) int32


class MprdmaLB(LoadBalancer):
    name = "mprdma"

    def __init__(self, evs_size: int = 65536, blacklist: int = 16):
        super().__init__(evs_size)
        self.blacklist = blacklist

    def init_state(self, n_conns, key):
        return MprdmaState(
            bad_evs=torch.full((n_conns, self.blacklist), -1, dtype=I32, device=key.device),
            bad_ptr=torch.zeros((n_conns,), dtype=I32, device=key.device),
        )

    def draw(self, keys, n_conns):
        # split(key) -> two candidates per connection, connection-major: (..., N, 2)
        return _conn_major(_rand_evs(rng.split(keys), n_conns, self.evs_size))

    def choose_ev(self, state, mask, draw, now):
        cand1, cand2 = draw[:, 0], draw[:, 1]
        bad1 = (state.bad_evs == cand1[:, None]).any(dim=1)
        return torch.where(bad1, cand2, cand1), state  # one resample on a hit

    def on_ack(self, state, mask, ev, ecn, now, draw):
        add = mask & ecn
        sel = add[:, None] & _slot(state.bad_ptr % self.blacklist, self.blacklist)
        return MprdmaState(
            bad_evs=torch.where(sel, ev[:, None], state.bad_evs),
            bad_ptr=torch.where(add, state.bad_ptr + 1, state.bad_ptr),
        )


# ---------------------------------------------------------------------------
# BitMap (STrack-like): 1 bit of congestion state per EV in the whole EVS —
# the memory-expensive strawman of paper §3.3.  Marked EVs are avoided by
# resampling up to R candidates.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BitmapState(_State):
    bad: torch.Tensor  # (N, EVS) bool


class BitmapLB(LoadBalancer):
    name = "bitmap"

    def __init__(self, evs_size: int = 256, resamples: int = 4):
        super().__init__(evs_size)
        self.resamples = resamples

    def init_state(self, n_conns, key):
        return BitmapState(
            bad=torch.zeros((n_conns, self.evs_size), dtype=torch.bool, device=key.device))

    def draw(self, keys, n_conns):
        # split(key, R) -> R candidates per connection, connection-major: (..., N, R)
        return _conn_major(_rand_evs(rng.split(keys, self.resamples), n_conns, self.evs_size))

    def choose_ev(self, state, mask, draw, now):
        ev = draw[:, 0]
        for i in range(1, self.resamples):
            ev = torch.where(_pick(state.bad, ev), draw[:, i], ev)
        return ev, state

    def on_ack(self, state, mask, ev, ecn, now, draw):
        # bad[i, ev[i]] = ecn[i] where mask[i]: one element per row, so the
        # scatter's indices are unique; an EV outside the space changes
        # nothing (the reference's one_hot row is all-false there)
        E = self.evs_size
        rows = torch.arange(ev.shape[0], device=ev.device)
        col = ev.clamp(0, E - 1).long()
        hit = mask & (ev >= 0) & (ev < E)
        bad = state.bad.clone()
        bad[rows, col] = torch.where(hit, ecn, state.bad[rows, col])
        return BitmapState(bad=bad)


# ---------------------------------------------------------------------------
# PRIME-like: multi-part entropy header.  The EV splits into a per-flow part
# hashed at connection setup and a sub-entropy field of ``sub_bits`` bits
# that rotates per packet through a hashed sequence.  An RTO re-hashes the
# flow part; an ECN-marked ACK skips the rotation forward.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PrimeState(_State):
    base: torch.Tensor  # (N,) int32 hashed per-flow part of the header
    ctr: torch.Tensor  # (N,) int32 per-packet rotation counter


class PrimeLB(LoadBalancer):
    name = "prime"

    def __init__(self, evs_size: int = 65536, sub_bits: int = 4):
        super().__init__(evs_size)
        if not 0 < (1 << sub_bits) <= evs_size:
            raise ValueError(f"need 0 < 2**sub_bits <= evs_size, got {sub_bits}, {evs_size}")
        self.sub_bits = sub_bits

    def init_state(self, n_conns, key):
        return PrimeState(
            base=_rand_evs(key, n_conns, self.evs_size),
            ctr=torch.zeros((n_conns,), dtype=I32, device=key.device),
        )

    def draw_timeout(self, keys, n_conns):
        return _rand_evs(keys, n_conns, self.evs_size)

    def choose_ev(self, state, mask, draw, now):
        sub = (kernel_ref.mix32(state.ctr) & ((1 << self.sub_bits) - 1)).to(I32)
        ev = (state.base + sub) % self.evs_size
        return ev, state.replace(ctr=torch.where(mask, state.ctr + 1, state.ctr))

    def on_ack(self, state, mask, ev, ecn, now, draw):
        return state.replace(ctr=torch.where(mask & ecn, state.ctr + 1, state.ctr))

    def on_timeout(self, state, mask, now, draw):
        return state.replace(base=torch.where(mask, draw, state.base))

    trace_sites = frozenset({"ack", "timeout"})

    def trace(self, site, prev, new, mask, rows=1):
        if site == "ack":  # ECN-skip advances the sub-entropy rotation
            return _trace_counts(rows, (TR_REPATH_ACK_ECN, mask & (new.ctr != prev.ctr)))
        if site == "timeout":  # flow-part re-hash moves the whole window
            return _trace_counts(rows, (TR_REPATH_RTO, mask))
        return _no_counts(rows, mask.device)


# ---------------------------------------------------------------------------
# SeqBalance-like: reorder-free congestion-aware re-pathing.  One EV per
# connection, re-drawn only at message boundaries (every ``msg_pkts`` sends)
# when the window since the last boundary saw a high ECN fraction; an RTO
# re-paths immediately.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SeqBalanceState(_State):
    ev: torch.Tensor  # (N,) int32 current path
    sent: torch.Tensor  # (N,) int32 sends since the last boundary
    acks: torch.Tensor  # (N,) int32 ACKs since the last boundary
    marked: torch.Tensor  # (N,) int32 ECN-marked ACKs since the last boundary


class SeqBalanceLB(LoadBalancer):
    name = "seqbalance"

    def __init__(self, evs_size: int = 65536, msg_pkts: int = 16,
                 ecn_frac_threshold: float = 0.25):
        super().__init__(evs_size)
        self.msg_pkts = msg_pkts
        self.ecn_frac_threshold = ecn_frac_threshold

    def init_state(self, n_conns, key):
        z = torch.zeros((n_conns,), dtype=I32, device=key.device)
        return SeqBalanceState(ev=_rand_evs(key, n_conns, self.evs_size), sent=z, acks=z, marked=z)

    def draw(self, keys, n_conns):
        return _rand_evs(keys, n_conns, self.evs_size)

    def draw_timeout(self, keys, n_conns):
        return _rand_evs(keys, n_conns, self.evs_size)

    def choose_ev(self, state, mask, draw, now):
        boundary = mask & (state.sent >= self.msg_pkts)
        # float32 compare, as the reference (exact below 2**24)
        congested = state.marked.to(F32) > state.acks.to(F32) * _f32(self.ecn_frac_threshold)
        ev = torch.where(boundary & congested, draw, state.ev)
        return ev, SeqBalanceState(
            ev=ev,
            sent=torch.where(mask, torch.where(boundary, 1, state.sent + 1), state.sent),
            acks=torch.where(boundary, 0, state.acks),
            marked=torch.where(boundary, 0, state.marked),
        )

    def on_ack(self, state, mask, ev, ecn, now, draw):
        return state.replace(
            acks=torch.where(mask, state.acks + 1, state.acks),
            marked=torch.where(mask & ecn, state.marked + 1, state.marked),
        )

    def on_timeout(self, state, mask, now, draw):
        return state.replace(
            ev=torch.where(mask, draw, state.ev),
            acks=torch.where(mask, 0, state.acks),
            marked=torch.where(mask, 0, state.marked),
        )

    trace_sites = frozenset({"choose", "timeout"})

    def trace(self, site, prev, new, mask, rows=1):
        if site == "choose":  # congestion-triggered message-boundary repath
            return _trace_counts(rows, (TR_REPATH_EPOCH, mask & (new.ev != prev.ev)))
        if site == "timeout":
            return _trace_counts(rows, (TR_REPATH_RTO, mask))
        return _no_counts(rows, mask.device)


# ---------------------------------------------------------------------------
# CONGA-style flowlet table: a small per-connection table of candidate EVs
# with a cached congestion score fed by ECN marks (integer EWMA).  A flowlet
# gap switches to the least-congested candidate; an RTO re-hashes the
# active candidate and clears its score.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FlowletTableState(_State):
    cand: torch.Tensor  # (N, T) int32 candidate EVs
    score: torch.Tensor  # (N, T) int32 cached congestion score
    cur: torch.Tensor  # (N,) int32 active candidate index
    last_send: torch.Tensor  # (N,) int32 tick of previous send


class FlowletTableLB(LoadBalancer):
    name = "flowlet_table"
    SCORE_MARK = 64  # score bump per ECN-marked ACK (decay is 1/4 per ACK)

    def __init__(self, evs_size: int = 65536, table: int = 4, gap_ticks: int = 32):
        super().__init__(evs_size)
        self.table = table
        self.gap_ticks = gap_ticks

    def init_state(self, n_conns, key):
        dev = key.device
        return FlowletTableState(
            cand=rng.randint(key, (n_conns, self.table), 0, self.evs_size),
            score=torch.zeros((n_conns, self.table), dtype=I32, device=dev),
            cur=torch.zeros((n_conns,), dtype=I32, device=dev),
            last_send=torch.full((n_conns,), -(10**6), dtype=I32, device=dev),
        )

    def draw_timeout(self, keys, n_conns):
        return rng.randint(keys, (n_conns, self.table), 0, self.evs_size)

    def choose_ev(self, state, mask, draw, now):
        new_flowlet = mask & ((now - state.last_send) > self.gap_ticks)
        best = torch.argmin(state.score, dim=1).to(I32)  # first minimum, as jnp
        cur = torch.where(new_flowlet, best, state.cur)
        return _pick(state.cand, cur), state.replace(
            cur=cur, last_send=torch.where(mask, now, state.last_send))

    def on_ack(self, state, mask, ev, ecn, now, draw):
        hit = mask[:, None] & (state.cand == ev[:, None])
        decayed = state.score - state.score // 4 + (ecn.to(I32) * self.SCORE_MARK)[:, None]
        return state.replace(score=torch.where(hit, decayed, state.score))

    def on_timeout(self, state, mask, now, draw):
        sel = mask[:, None] & _slot(state.cur, self.table)
        return state.replace(
            cand=torch.where(sel, draw, state.cand),
            score=torch.where(sel, 0, state.score),
        )

    trace_sites = frozenset({"choose", "timeout"})

    def trace(self, site, prev, new, mask, rows=1):
        if site == "choose":  # flowlet gap switched to another candidate
            return _trace_counts(rows, (TR_REPATH_FLOWLET, mask & (new.cur != prev.cur)))
        if site == "timeout":  # active candidate re-hashed + score cleared
            return _trace_counts(rows, (TR_REPATH_RTO, mask))
        return _no_counts(rows, mask.device)


# ---------------------------------------------------------------------------
# SwitchLB: N variants behind one branch index, so that scenarios differing
# only in their LB share one tick (the sweep engine's LB dispatch,
# repro_torch.netsim.sweep).  The state keeps the reference's layout,
# (branch index, tuple of every variant's state): a 0-dim index for one run,
# ``(B,)`` under a row axis, one per row (``with_branch``).  Every variant
# steps all connections on the draws it would make serially (each its own,
# from the one key), and each row keeps the outputs of its own variant
# only: the other variants' slots of that row are left as they were, so the
# active branch is bit-identical to a serial run with the plain variant,
# as the reference's vmapped lax.switch (run every branch, select per row).
# ---------------------------------------------------------------------------
def _by_row(sel: torch.Tensor, new, old):
    """``new`` on the rows where ``sel`` (the rows' ``(B,)`` or one run's
    0-dim mask) holds, ``old`` elsewhere; a leaf's first axis holds the
    rows' connections, row-major.  A leaf the variant left as it was costs
    nothing."""
    B = sel.numel()

    def pick(n, o):
        if n is o:
            return n
        rows = n.reshape(B, n.shape[0] // B, *n.shape[1:])
        m = sel.reshape(B, *([1] * n.dim()))
        return torch.where(m, rows, o.reshape(rows.shape)).reshape(n.shape)

    return tree_map(pick, new, old)


class SwitchLB(LoadBalancer):
    name = "switch"

    def __init__(self, variants):
        variants = tuple(variants)
        if not variants:
            raise ValueError("need at least one variant")
        flags = {v.switch_adaptive for v in variants}
        if len(flags) != 1:
            raise ValueError(
                "SwitchLB variants must agree on switch_adaptive (in-network "
                "adaptive LBs change the routing function, a static property); "
                "bucket them separately"
            )
        sizes = {int(v.evs_size) for v in variants}
        if len(sizes) != 1:
            raise ValueError(
                "SwitchLB variants must share one evs_size (every branch "
                "samples the same entropy space; a smaller variant would "
                "silently draw out-of-range EVs): got "
                + ", ".join(f"{v.name}={v.evs_size}" for v in variants)
                + ".  Pass evs_size explicitly to each variant — note "
                "BitmapLB defaults to 256 while the rest of the zoo "
                "defaults to 65536."
            )
        super().__init__(sizes.pop())
        self.variants = variants
        self.switch_adaptive = flags.pop()
        self.name = "switch(" + "+".join(v.name for v in variants) + ")"

    def init_state(self, n_conns, key):
        # every variant is seeded with the same key it would get serially
        return (
            torch.zeros((), dtype=I32, device=key.device),
            tuple(v.init_state(n_conns, key) for v in self.variants),
        )

    def with_branch(self, state, branch_idx):
        """Rebind the branch index: an int for one run, one per row under a
        row axis (the sweep sets it per scenario row).  An index outside
        ``[0, len(variants))`` raises."""
        dev = state[0].device
        idx = torch.as_tensor(np.asarray(branch_idx, np.int32), device=dev)
        bad = (idx < 0) | (idx >= len(self.variants))
        if bool(bad.any()):
            raise ValueError(f"branch index outside [0, {len(self.variants)}): {branch_idx}")
        return (idx, state[1])

    def draw(self, keys, n_conns):
        return tuple(v.draw(keys, n_conns) for v in self.variants)

    def draw_ack(self, keys, n_conns):
        return tuple(v.draw_ack(keys, n_conns) for v in self.variants)

    def draw_timeout(self, keys, n_conns):
        return tuple(v.draw_timeout(keys, n_conns) for v in self.variants)

    def _dispatch(self, state, fn):
        """``fn(i, variant, state_i) -> (evs or None, new state_i)`` for every
        variant, each row keeping its own variant's.  One variant: no
        selection at all, as the plain load balancer."""
        bidx, states = state
        if len(self.variants) == 1:
            evs, s0 = fn(0, self.variants[0], states[0])
            return evs, (bidx, (s0,))
        evs, out = None, []
        for i, (v, s) in enumerate(zip(self.variants, states)):
            sel = bidx == i
            e, ns = fn(i, v, s)
            out.append(_by_row(sel, ns, s))
            if e is not None:
                evs = e if evs is None else _by_row(sel, e, evs)
        return evs, (bidx, tuple(out))

    def choose_ev(self, state, mask, draw, now):
        return self._dispatch(state, lambda i, v, s: v.choose_ev(s, mask, draw[i], now))

    def on_ack(self, state, mask, ev, ecn, now, draw):
        return self._dispatch(
            state, lambda i, v, s: (None, v.on_ack(s, mask, ev, ecn, now, draw[i])))[1]

    def on_timeout(self, state, mask, now, draw):
        return self._dispatch(state, lambda i, v, s: (None, v.on_timeout(s, mask, now, draw[i])))[1]

    def step(self, state, acks, timeout_mask, send_mask, draws, now, rows=None):
        def call(i, v, s, rows=None):
            return v.step(s, [(m, e, c, d[i]) for m, e, c, d in acks], timeout_mask, send_mask,
                          (draws[0][i], draws[1][i]), now, rows)

        if rows is None:
            return self._dispatch(state, call)
        counts = []

        def traced(i, v, s):
            if not v.trace_sites:  # counts nothing: stepped untraced
                return call(i, v, s)
            evs, new, c = call(i, v, s, rows)
            counts.append((i, c))
            return evs, new

        evs, new = self._dispatch(state, traced)
        return evs, new, self._by_branch(state[0], counts, rows, len(self.variants))

    @property
    def trace_sites(self):
        return frozenset().union(*(v.trace_sites for v in self.variants))

    def trace(self, site, prev, new, mask, rows=1):
        # only a row's own variant changed its slot of that row, so each
        # row keeps its own variant's counts
        return self._by_branch(new[0], [
            (i, v.trace(site, p, n, mask, rows))
            for i, (v, p, n) in enumerate(zip(self.variants, prev[1], new[1]))], rows,
            len(self.variants))

    @staticmethod
    def _by_branch(bidx: torch.Tensor, counts: list, rows: int, n_variants: int) -> torch.Tensor:
        """``(rows, N_TRACE_KINDS)`` counts: variant i's, from the ``(i,
        counts)`` pairs, on the rows whose branch index is i, and zero on
        the rows of a variant without a pair (one that counts nothing)."""
        if not counts:
            return _no_counts(rows, bidx.device)
        (i0, out), *rest = counts
        if len(counts) < n_variants:
            out = out.masked_fill((bidx != i0).reshape(-1, 1), 0)
        for i, c in rest:
            out = torch.where((bidx == i).reshape(-1, 1), c, out)
        return out


# ---------------------------------------------------------------------------
# Adaptive RoCE (NVIDIA Spectrum-X style): in-network per-packet adaptive
# routing — switches pick the least-loaded valid uplink.  The sender sprays
# (EV is ignored by adaptive switches, so the router launches no hash).
# ---------------------------------------------------------------------------
class AdaptiveRoceLB(OpsLB):
    name = "adaptive_roce"
    switch_adaptive = True


REGISTRY = {
    cls.name: cls
    for cls in (
        EcmpLB, OpsLB, RepsLB, PlbLB, FlowletLB, MptcpLB, MprdmaLB, BitmapLB,
        AdaptiveRoceLB, PrimeLB, SeqBalanceLB, FlowletTableLB,
    )
}


def make_lb(name: str, **kwargs) -> LoadBalancer:
    """Build a registered load balancer (``"mixed"`` registers when
    ``repro_torch.netsim`` is imported, as in the reference)."""
    if name not in REGISTRY:
        raise ValueError(f"unknown load balancer {name!r}; registered: {list(REGISTRY)}")
    return REGISTRY[name](**kwargs)
