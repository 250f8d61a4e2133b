"""CUDA wrapper of the ``queue_tick`` kernel (``csrc/queue_tick.cu``).

One switch tick: serve <= 1 per queue, FIFO multi-enqueue in 128-arrival
tiles against the running occupancy, tail drop, RED mark.  Replaces the
Pallas kernel ``repro.kernels.queue_tick``; the plain version is
``repro_torch.kernels.ref.queue_tick_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels._checks import ptr, require

TILE = 128  # arrivals per tile; part of the result (see csrc/queue_tick.cu)
launches = 0  # incremented once per kernel launch, nowhere else
MAX_SHARED_QUEUES = (227 * 1024 - 4 * TILE) // 4


def queue_tick_cuda(target, u, qlen, serve, capacity, kmin, kmax):
    """``target (K,)`` int32, ``u (K,)`` float32, ``qlen (Q,)`` int32,
    ``serve (Q,)`` bool or ``None`` (optionally all with a leading row axis)
    -> ``(new_qlen, accept, mark, pos)``."""
    global launches
    batched = target.dim() == 2
    d = 2 if batched else 1
    dev = target.device
    require(target, "target", torch.int32, d)
    require(u, "u", torch.float32, d, dev)
    require(qlen, "qlen", torch.int32, d, dev)
    require(serve, "serve", torch.bool, d, dev, optional=True)
    B = target.shape[0] if batched else 1
    K, Q = target.shape[-1], qlen.shape[-1]
    if u.shape != target.shape or (serve is not None and serve.shape != qlen.shape) or (
        batched and qlen.shape[0] != B
    ):
        raise ValueError("queue_tick: target/u and qlen/serve shapes disagree")
    new_qlen = torch.empty((B, Q), dtype=torch.int32, device=dev)
    accept = torch.empty((B, K), dtype=torch.bool, device=dev)
    mark = torch.empty((B, K), dtype=torch.bool, device=dev)
    pos = torch.empty((B, K), dtype=torch.int32, device=dev)
    scratch = torch.empty((B, Q), dtype=torch.int32, device=dev) if Q > MAX_SHARED_QUEUES else None
    rc = build.library().repro_queue_tick(
        target.data_ptr(), u.data_ptr(), qlen.data_ptr(), ptr(serve),
        B, K, Q, int(capacity), int(kmin), int(kmax),
        new_qlen.data_ptr(), accept.data_ptr(), mark.data_ptr(), pos.data_ptr(),
        ptr(scratch), torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(rc, "queue_tick")
    launches += 1
    if batched:
        return new_qlen, accept, mark, pos
    return new_qlen[0], accept[0], mark[0], pos[0]
