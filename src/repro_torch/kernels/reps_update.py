"""CUDA wrapper of the fused REPS kernel (``csrc/reps_update.cu``).

One launch applies, per connection, R rounds of Algorithm 1 onAck, then
onFailureDetection, then Algorithm 2 getNextEV over the 8-deep EV ring.
Replaces the Pallas kernel ``repro.kernels.reps_update`` (which is the
case R = 1); the plain version is ``repro_torch.kernels.ref.reps_tick_ref``.
With ``trace_rows=B`` the same launch also returns the flight recorder's
REPS decision counts per row, ``(B, N_TRACE_KINDS)`` int32 (``TR_EV_HIT``,
``TR_EV_MISS``, ``TR_EV_RECYCLE``, ``TR_EV_FREEZE``; the repath kinds stay
0), the connections being B rows of equal length, row-major.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels._checks import check, stream_ptr

BUF = 8  # paper buffer depth, compiled into the kernel
MAX_ROUNDS = 4  # ACK rounds one launch takes, compiled into the kernel
# the trace kinds the traced form counts, numbered as the load balancers' TR_*
N_TRACE_KINDS = 8
TR_EV_HIT, TR_EV_MISS, TR_EV_RECYCLE, TR_EV_FREEZE = 0, 1, 2, 3
launches = 0  # incremented once per kernel launch, nowhere else

_ACK_PTRS = ctypes.c_void_p * (3 * MAX_ROUNDS)
_STATE = (  # name, dtype, whether it is a ring (else one value per connection)
    ("buf_ev", torch.int32, True), ("buf_valid", torch.bool, True), ("head", torch.int32, False),
    ("num_valid", torch.int32, False), ("explore", torch.int32, False),
    ("freezing", torch.bool, False), ("exit_freeze", torch.int32, False),
    ("n_cached", torch.int32, False),
)


def ack_rounds(ack_mask, ack_ev, ack_ecn) -> tuple:
    """The ACK event classes as a tuple of R ``(mask, ev, ecn)`` rounds.
    Each argument is one round's tensor, ``None`` (absent in every round)
    or a sequence of R tensors or ``None``s; the sequences must agree on R."""
    cols = [x if isinstance(x, (tuple, list)) else None if x is None else (x,)
            for x in (ack_mask, ack_ev, ack_ecn)]
    lengths = {len(c) for c in cols if c is not None}
    if len(lengths) > 1:
        raise ValueError(f"ACK masks, EVs and ECN flags disagree on the rounds: {sorted(lengths)}")
    R = lengths.pop() if lengths else 1
    return tuple(zip(*(c if c is not None else (None,) * R for c in cols)))


def reps_tick_cuda(
    buf_ev, buf_valid, head, num_valid, explore, freezing, exit_freeze,
    n_cached, ack_mask, ack_ev, ack_ecn, timeout_mask, send_mask, rand_ev,
    now, num_pkts_bdp, freezing_timeout, trace_rows=None,
):
    """State ``(..., 8)`` int32/bool rings and ``(...)`` int32/bool scalars,
    events ``(...)`` (``None`` = all-zero; the ACK classes per round, see
    ``ack_rounds``, at most ``MAX_ROUNDS``) -> new state fields and EVs,
    same shapes, and with ``trace_rows`` the ``(trace_rows,
    N_TRACE_KINDS)`` counts.  A leading row axis is just more connections
    here."""
    global launches
    rounds = ack_rounds(ack_mask, ack_ev, ack_ecn)
    if len(rounds) > MAX_ROUNDS:
        raise ValueError(f"reps_tick takes at most {MAX_ROUNDS} ACK rounds, got {len(rounds)}")
    if not isinstance(head, torch.Tensor) or head.device.type != "cuda":
        raise ValueError("reps_tick: the state must be CUDA tensors")
    shape, dev = head.shape, head.device
    ring = (*shape, BUF)
    state = (buf_ev, buf_valid, head, num_valid, explore, freezing, exit_freeze, n_cached)
    for t, (name, dt, is_ring) in zip(state, _STATE):
        check("reps_tick", t, name, dt, ring if is_ring else shape, dev)
    b8, i32 = torch.bool, torch.int32
    events = [(t, dt) for rnd in rounds for t, dt in zip(rnd, (b8, i32, b8))]
    events += ((timeout_mask, b8), (send_mask, b8), (rand_ev, i32))
    for t, dt in events:
        if t is not None:
            check("reps_tick", t, "event", dt, shape, dev)
    if buf_ev.data_ptr() % 16 or buf_valid.data_ptr() % 8:
        raise ValueError("reps_tick: the rings must be 16-byte (buf_ev) and 8-byte "
                         "(buf_valid) aligned; pass a copy of an offset view")
    ptrs = [None] * (3 * MAX_ROUNDS)
    for r, rnd in enumerate(rounds):
        for c, t in enumerate(rnd):
            ptrs[c * MAX_ROUNDS + r] = None if t is None else t.data_ptr()
    n = head.numel()
    # two allocations, rings first so both stay aligned: int32 [ring | head |
    # num_valid | explore | exit_freeze | n_cached | ev], bool [ring | freezing]
    o_ring, o_head, o_nv, o_ex, o_ef, o_nc, o_ev = torch.empty(
        14 * n, dtype=i32, device=dev).split((BUF * n,) + (n,) * 6)
    o_valid, o_fr = torch.empty(9 * n, dtype=b8, device=dev).split((BUF * n, n))
    outs = (o_ring.view(ring), o_valid.view(ring), o_head, o_nv, o_ex, o_fr, o_ef, o_nc, o_ev)
    if len(shape) != 1:
        outs = outs[:2] + tuple(o.view(shape) for o in outs[2:])
    counts = None
    if trace_rows is not None:
        rows = int(trace_rows)
        if rows < 1 or n % rows:
            raise ValueError(f"reps_tick: {n} connections do not split into {rows} rows")
        counts = torch.empty((rows, N_TRACE_KINDS), dtype=i32, device=dev)  # zeroed by the call
    p = lambda t: None if t is None else t.data_ptr()
    rc = build.library().repro_reps_tick(
        *(t.data_ptr() for t in state), _ACK_PTRS(*ptrs), len(rounds), p(timeout_mask),
        p(send_mask), p(rand_ev), int(now), int(num_pkts_bdp), int(freezing_timeout), n,
        *(o.data_ptr() for o in outs), p(counts), n // rows if counts is not None else 0,
        stream_ptr(dev),
    )
    build.check(rc, "reps_tick")
    launches += 1
    return outs if counts is None else (*outs, counts)
