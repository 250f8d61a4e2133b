"""CUDA wrapper of the fused REPS kernel (``csrc/reps_update.cu``).

One launch applies, per connection, Algorithm 1 onAck -> onFailureDetection
-> Algorithm 2 getNextEV over the 8-deep EV ring.  Replaces the Pallas
kernel ``repro.kernels.reps_update``; the plain version is
``repro_torch.kernels.ref.reps_tick_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels._checks import ptr, require

BUF = 8  # paper buffer depth, compiled into the kernel
launches = 0  # incremented once per kernel launch, nowhere else


def reps_tick_cuda(
    buf_ev, buf_valid, head, num_valid, explore, freezing, exit_freeze,
    n_cached, ack_mask, ack_ev, ack_ecn, timeout_mask, send_mask, rand_ev,
    now, num_pkts_bdp, freezing_timeout,
):
    """State ``(..., 8)`` int32/bool rings and ``(...)`` int32/bool scalars,
    events ``(...)`` (``None`` = all-zero) -> new state fields and EVs, same
    shapes.  A leading row axis is just more connections here."""
    global launches
    shape = head.shape
    dev = head.device
    i32, b8 = torch.int32, torch.bool
    require(buf_ev, "buf_ev", i32, len(shape) + 1, dev)
    require(buf_valid, "buf_valid", b8, len(shape) + 1, dev)
    if buf_ev.shape[-1] != BUF or buf_ev.shape[:-1] != shape or buf_valid.shape != buf_ev.shape:
        raise ValueError(f"rings must be {(*shape, BUF)}, got {tuple(buf_ev.shape)}")
    scalars = dict(head=(head, i32), num_valid=(num_valid, i32), explore=(explore, i32),
                   freezing=(freezing, b8), exit_freeze=(exit_freeze, i32),
                   n_cached=(n_cached, i32))
    events = dict(ack_mask=(ack_mask, b8), ack_ev=(ack_ev, i32), ack_ecn=(ack_ecn, b8),
                  timeout_mask=(timeout_mask, b8), send_mask=(send_mask, b8),
                  rand_ev=(rand_ev, i32))
    for name, (t, dt) in {**scalars, **events}.items():
        require(t, name, dt, len(shape), dev, optional=name in events)
        if t is not None and t.shape != shape:
            raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    outs = (
        torch.empty_like(buf_ev), torch.empty_like(buf_valid),
        *(torch.empty(shape, dtype=dt, device=dev)
          for dt in (i32, i32, i32, b8, i32, i32, i32)),
    )
    n = head.numel()
    rc = build.library().repro_reps_tick(
        buf_ev.data_ptr(), buf_valid.data_ptr(), head.data_ptr(), num_valid.data_ptr(),
        explore.data_ptr(), freezing.data_ptr(), exit_freeze.data_ptr(), n_cached.data_ptr(),
        ptr(ack_mask), ptr(ack_ev), ptr(ack_ecn), ptr(timeout_mask), ptr(send_mask),
        ptr(rand_ev), int(now), int(num_pkts_bdp), int(freezing_timeout), n,
        *(o.data_ptr() for o in outs), torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(rc, "reps_tick")
    launches += 1
    return outs
