"""On-device flight recorder: typed decision events in a ring-buffer carry
(counterpart of ``repro.netsim.tracer``).

The telemetry sketches (``repro_torch.netsim.telemetry``) answer aggregate
questions; this module answers provenance ones: when REPS hit, missed,
recycled or froze, when a failure window opened, when the first failure
drop happened and when the first re-routed delivery landed.  A
``TracerProgram`` lays a ``TraceSpec`` out as one flat ``(size,)`` int32
carry per row, a ring of ``(tick, code, value)`` events plus a monotone
push cursor, and ``update`` folds one tick's ``Probe`` and ``TickEvents``
of B rows into a ``(B, size)`` carry in place, as the telemetry carry is
updated.  Every push condition is False on an all-zero ``(probe, events)``
pair, so a quiescent tick leaves the carry bitwise unchanged, and the
carry composes with the sweep's per-row horizon freeze and early exit.

The first-drop / re-delivery edges mirror ``telemetry.RecoveryTracker``
exactly (the new first drop first, then the strict ``now > first_drop``),
so a decoded recovery span equals the tracker's ``recovery_ticks``.

The reference makes up to 12 conditional pushes in sequence, each a few
``where``s over the ring.  Here the 12 conditions of a tick are one ``(B,
12)`` matrix, the comparison of one ``(B, 3 * 12)`` block of every push's
tick, code and value; since ``ring >= 16 > 12`` no two pushes of one tick
share a slot, so a cumsum along it gives every push its slot, and one
``scatter_`` writes the block.  A push that does not happen is aimed at the
cursor word, which is written after it, and then the two first-edge words.  Event codes and ``CODE_NAMES`` are the
reference's: they are serialised into flight part files.

    prog = TraceSpec().build(sim, ticks)
    trc = prog.init_rows(B)
    states, probe, events = sim.step_events_rows(states, t, draws.row(i), scn)
    prog.update(trc, probe, events)
    prog.decode_row(trc[b].cpu().numpy())
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.load_balancers import (
    N_TRACE_KINDS, TR_EV_FREEZE, TR_EV_HIT, TR_EV_MISS, TR_EV_RECYCLE, TR_REPATH_ACK_ECN,
    TR_REPATH_EPOCH, TR_REPATH_FLOWLET, TR_REPATH_RTO,
)
from repro_torch.netsim.engine import BIG, ST_DELIVERED, ST_DROPS_FAIL, add_rows, drop_rows

I32 = torch.int32

# Ring event codes (serialised into flight part files: keep stable).
MARK = 1  # heartbeat on active ticks; value = total queue backlog
EV_HIT = 2  # REPS popped a valid cached EV; value = count this tick
EV_MISS = 3  # REPS explored fresh entropy
EV_RECYCLE = 4  # REPS freezing-mode slot reuse
EV_FREEZE = 5  # REPS entered freezing mode
REPATH_ACK_ECN = 6  # re-path from ECN feedback
REPATH_RTO = 7  # re-path from a timeout
REPATH_FLOWLET = 8  # re-path from a flowlet gap
REPATH_EPOCH = 9  # re-path at an epoch / message boundary
FAIL_ACTIVE = 10  # failure window opened; value = queues affected
FAIL_FIRST_DROP = 11  # first failure drop; value = drops this tick
FAIL_REROUTED = 12  # first delivery after it; value = recovery ticks

CODE_NAMES = {
    MARK: "mark",
    EV_HIT: "ev_hit",
    EV_MISS: "ev_miss",
    EV_RECYCLE: "ev_recycle",
    EV_FREEZE: "ev_freeze",
    REPATH_ACK_ECN: "repath_ack_ecn",
    REPATH_RTO: "repath_rto",
    REPATH_FLOWLET: "repath_flowlet",
    REPATH_EPOCH: "repath_epoch",
    FAIL_ACTIVE: "fail_active",
    FAIL_FIRST_DROP: "fail_first_drop",
    FAIL_REROUTED: "fail_rerouted",
}

# (trace-port kind, ring code) in the static push order: one conditional
# push per kind per tick, so the ring is the same under any chunk tiling
_LB_CODES = (
    (TR_EV_HIT, EV_HIT),
    (TR_EV_MISS, EV_MISS),
    (TR_EV_RECYCLE, EV_RECYCLE),
    (TR_EV_FREEZE, EV_FREEZE),
    (TR_REPATH_ACK_ECN, REPATH_ACK_ECN),
    (TR_REPATH_RTO, REPATH_RTO),
    (TR_REPATH_FLOWLET, REPATH_FLOWLET),
    (TR_REPATH_EPOCH, REPATH_EPOCH),
)
assert len(_LB_CODES) == N_TRACE_KINDS
# every push of a tick, in order: the LB kinds, then the failure edges, then MARK
PUSH_CODES = tuple(c for _, c in _LB_CODES) + (FAIL_ACTIVE, FAIL_FIRST_DROP, FAIL_REROUTED, MARK)
_EDGES = slice(N_TRACE_KINDS + 1, N_TRACE_KINDS + 3)  # the first-drop and re-routed pushes
assert PUSH_CODES[_EDGES] == (FAIL_FIRST_DROP, FAIL_REROUTED)


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Declarative, hashable flight-recorder knobs.

    ``ring`` bounds the carry at ``3 + 3 * ring`` int32 per row; at most 12
    events push per tick, so a ring of 256 absorbs 21 fully eventful ticks
    before overwriting, and overwrites are reported (``lost``).
    ``marker_every`` spaces the heartbeat MARK rows (in ticks)."""

    ring: int = 256
    marker_every: int = 256

    def build(self, sim, ticks: int) -> "TracerProgram":
        return TracerProgram(self, sim, ticks)


class TracerProgram:
    """A ``TraceSpec`` laid out against one simulator.

    Flat per-row carry layout (all int32)::

        [0]                cursor: total pushes ever (monotone)
        [1]                first failure-drop tick (BIG until seen)
        [2]                first re-routed delivery tick (BIG until seen)
        [3        : 3+R ]  ring: event tick
        [3 +   R  : 3+2R]  ring: event code
        [3 + 2R   : 3+3R]  ring: event value

    Event ``k`` (0-based push index) lives at ring slot ``k % R``;
    ``decode_row`` walks ``[since, cursor)`` in push order.
    """

    def __init__(self, spec: TraceSpec, sim, ticks: int):
        if spec.ring < 16:
            raise ValueError(f"TraceSpec.ring must be >= 16, got {spec.ring}")
        if spec.marker_every < 1:
            raise ValueError(f"TraceSpec.marker_every must be >= 1, got {spec.marker_every}")
        self.spec = spec
        self.ring = int(spec.ring)
        self.ticks = int(ticks)
        self.size = 3 + 3 * self.ring
        self.device = None if sim is None else sim.device  # no simulator: a layout only
        self._consts = None  # (field offsets, push codes, header offsets) on the carry's device

    @property
    def nbytes(self) -> int:
        return self.size * 4

    def init(self) -> torch.Tensor:
        """One row's initial carry, ``(size,)`` int32 on the device."""
        flat = np.zeros((self.size,), np.int32)
        flat[1] = BIG  # first_drop sentinel
        flat[2] = BIG  # first_redeliver sentinel
        return torch.as_tensor(flat, device=self.device)

    def init_rows(self, n_rows: int) -> torch.Tensor:
        """``n_rows`` initial carries, ``(n_rows, size)``."""
        return self.init()[None].repeat(n_rows, 1)

    def update(self, flat: torch.Tensor, probe, events) -> torch.Tensor:
        """Fold one tick's ``Probe`` and ``TickEvents`` of B rows into the
        carry ``flat (B, size)`` in place (and return it).  Bitwise a no-op
        on a quiescent tick."""
        R = self.ring
        now = int(probe.now)
        B = flat.shape[0]
        if self._consts is None or self._consts[0].device != flat.device:
            dev = flat.device
            self._consts = (
                # (1, 3, 1): the flat offsets of the tick, code and value fields
                torch.tensor([3, 3 + R, 3 + 2 * R], dtype=torch.int64, device=dev).view(1, 3, 1),
                torch.tensor(PUSH_CODES, dtype=I32, device=dev)[None],
            )
        field_base, codes = self._consts
        marker = now % self.spec.marker_every == 0
        P = len(PUSH_CODES) - (not marker)  # MARK, last, pushes only on marker ticks
        sd = probe.stats_delta
        # every push's tick, code and value, as one (B, 3 * P) block laid
        # out (field, push); the values: the LB counts, the failure windows,
        # the drops, the recovery span, and the backlog on marker ticks
        vals = torch.cat([
            torch.full((B, P), now, dtype=I32, device=flat.device), codes[:, :P].expand(B, P),
            events.lb, events.fail_start[:, None], sd[:, ST_DROPS_FAIL, None],
            now - flat[:, 1:2],
        ] + ([probe.q_len.sum(dim=1, dtype=I32)[:, None]] if marker else []), dim=1)
        cond = vals[:, 2 * P:] > 0
        # RecoveryTracker's order: this tick's first drop first, then a
        # delivery strictly after it.  A first drop of an earlier tick is
        # < now, so `now - first_drop > 0` says it was set before this tick.
        # First drop: a drop while none is recorded; re-routed: a delivery
        # after it while none is recorded.
        cond[:, _EDGES] &= flat[:, 1:3] >= BIG
        cond[:, _EDGES] &= sd[:, ST_DROPS_FAIL:ST_DELIVERED + 1:ST_DELIVERED - ST_DROPS_FAIL] > 0
        if marker:
            # heartbeat: only on active ticks, spaced on the absolute tick
            cond[:, P - 1] = ((sd != 0).any(dim=1) | (probe.q_len > 0).any(dim=1)
                              | (events.lb != 0).any(dim=1))
        # cursor + the pushes up to and including each: the new cursor last
        ends = torch.cumsum(cond, dim=1, dtype=torch.int64) + flat[:, :1]
        slot = (ends + (R - 1)) % R  # (cursor + the pushes before it) % R
        # (B, 3, P) flat indices; a push that does not happen is aimed at
        # the cursor word, which is written after the scatter
        idx = torch.where(cond[:, None], slot[:, None] + field_base, 0)
        flat.scatter_(1, idx.view(B, 3 * P), vals)
        flat[:, 0] = ends[:, -1]
        flat[:, 1:3].masked_fill_(cond[:, _EDGES], now)
        return flat

    # -- host side ----------------------------------------------------------
    def decode_row(self, flat: np.ndarray, since: int = 0) -> dict:
        """Decode one host-side row's events in push order.

        Returns events ``[max(since, cursor - ring), cursor)``; ``seq`` is
        the global push index, ``lost`` counts events of ``[since,
        cursor)`` already overwritten by the ring's wrap-around."""
        flat = np.asarray(flat)
        assert flat.shape == (self.size,), (flat.shape, self.size)
        R = self.ring
        cursor = int(flat[0])
        start = max(int(since), cursor - R)
        lost = max(0, start - int(since))
        seq = np.arange(start, cursor, dtype=np.int64)
        idx = (seq % R).astype(np.int64)
        first_drop = int(flat[1])
        first_red = int(flat[2])
        return {
            "seq": seq,
            "tick": flat[3: 3 + R][idx],
            "code": flat[3 + R: 3 + 2 * R][idx],
            "value": flat[3 + 2 * R: 3 + 3 * R][idx],
            "cursor": cursor,
            "lost": lost,
            "first_drop_tick": -1 if first_drop >= BIG else first_drop,
            "first_redeliver_tick": -1 if first_red >= BIG else first_red,
        }


def run_serial(sim, n_ticks: int, spec: TraceSpec):
    """Serial reference: one plain ``Simulator`` run with the recorder
    folded in.  Returns ``(final_state, trace_carry (size,))``; the carry
    equals the same scenario's sweep-row carry, because pushes depend only
    on ``(probe, events)``."""
    prog = spec.build(sim, n_ticks)
    states = add_rows(sim.init_state())
    trc = prog.init_rows(1)
    keys = sim.base_key[None]
    chunk = sim.draw_chunk(1)
    for c0 in range(0, n_ticks, chunk):
        m = min(chunk, n_ticks - c0)
        draws = sim.tick_draws(keys, c0, m)
        for i in range(m):
            states, probe, events = sim.step_events_rows(states, c0 + i, draws.row(i))
            prog.update(trc, probe, events)
    return drop_rows(states), trc[0]
