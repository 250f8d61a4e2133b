"""CUDA wrapper of the ``queue_tick`` kernel (``csrc/queue_tick.cu``).

One switch tick: serve <= 1 per queue, FIFO multi-enqueue in 128-arrival
tiles against the running occupancy, tail drop, RED mark; optionally the
simulator's RED mark and each arrival's ring slot.  Replaces the Pallas
kernel ``repro.kernels.queue_tick``; the plain version is
``repro_torch.kernels.ref.queue_tick_ref``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels._checks import check, ptr, stream_ptr

TILE = 128  # arrivals per tile; part of the result (see csrc/queue_tick.cu)
launches = 0  # incremented once per kernel launch, nowhere else


@functools.lru_cache(maxsize=None)
def _scratch_ints(Q: int) -> int:
    """Ints of global working memory the kernel needs per row (0: it works in
    shared memory)."""
    return build.library().repro_queue_tick_scratch_ints(Q)


def queue_tick_cuda(target, u, qlen, serve, capacity, kmin, kmax, red_rcp=None, pmax=1.0,
                    q_head=None, qcap=None):
    """``target (K,)`` int32, ``u (K,)`` float32, ``qlen (Q,)`` int32,
    ``serve (Q,)`` bool or ``None`` (optionally all with a leading row axis)
    -> ``(new_qlen, accept, mark, pos)``, plus ``slot`` when ``q_head`` is
    given; the arguments as ``ref.queue_tick_ref``."""
    global launches
    if not isinstance(target, torch.Tensor) or not isinstance(qlen, torch.Tensor):
        raise TypeError("queue_tick: target and qlen must be tensors")
    if target.dim() not in (1, 2):
        raise ValueError(f"queue_tick: target must be (K,) or (B, K), got {tuple(target.shape)}")
    dev, kshape = target.device, target.shape
    if dev.type != "cuda":
        raise ValueError(f"queue_tick: the kernel needs CUDA tensors, got one on {dev}")
    qshape = kshape[:-1] + qlen.shape[-1:]
    i32 = torch.int32
    for t, name, dt, shape, optional in (
        (target, "target", i32, kshape, False), (u, "u", torch.float32, kshape, False),
        (qlen, "qlen", i32, qshape, False), (serve, "serve", torch.bool, qshape, True),
        (q_head, "q_head", i32, qshape, True),
    ):
        if t is not None or not optional:
            check("queue_tick", t, name, dt, shape, dev)
    if q_head is not None and (qcap is None or int(qcap) < 1):
        raise ValueError(f"queue_tick: q_head needs a ring capacity qcap >= 1, got {qcap}")
    B = kshape[0] if len(kshape) == 2 else 1
    K, Q = kshape[-1], qshape[-1]
    nk, nq = B * K, B * Q
    # one int32 allocation [new_qlen | pos | slot] and one bool [accept | mark],
    # the kernel's pointers taken into them before any view is made
    ints = torch.empty(nq + nk * (1 if q_head is None else 2), dtype=i32, device=dev)
    flags = torch.empty(2 * nk, dtype=torch.bool, device=dev)
    p_int, p_flag = ints.data_ptr(), flags.data_ptr()
    n_scratch = _scratch_ints(Q)
    scratch = torch.empty(B * n_scratch, dtype=i32, device=dev) if n_scratch else None
    rc = build.library().repro_queue_tick(
        target.data_ptr(), u.data_ptr(), qlen.data_ptr(), ptr(serve), ptr(q_head),
        B, K, Q, int(capacity), int(kmin), int(kmax), red_rcp is not None,
        0.0 if red_rcp is None else float(red_rcp), float(pmax), 0 if qcap is None else int(qcap),
        p_int, p_flag, p_flag + nk, p_int + 4 * nq,
        None if q_head is None else p_int + 4 * (nq + nk), ptr(scratch), stream_ptr(dev),
    )
    build.check(rc, "queue_tick")
    launches += 1
    outs = (ints[:nq], flags[:nk], flags[nk:], ints[nq : nq + nk])
    if q_head is not None:
        outs += (ints[nq + nk :],)
    if len(kshape) == 2:
        outs = (outs[0].view(qshape),) + tuple(o.view(kshape) for o in outs[1:])
    return outs
