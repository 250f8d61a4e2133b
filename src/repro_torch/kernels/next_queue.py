"""CUDA wrapper of the ``next_queue`` kernel (``csrc/next_queue.cu``).

The arrivals stage's routing step in one launch: for each arrival, the
queue it enters next in the 2- or 3-tier fat tree (``Topology.next_queue``
of the reference, ECMP hash or first least-loaded port at each choice hop).
The redesign for this card of ``ecmp_hash``, the port of the Pallas kernel
``repro.kernels.ecmp_hash``: the hash sites, the gathers around them and
the hop transition are one kernel, for one run's arrivals ``(K,)`` or a
fleet's ``(B, K)``.  The plain version is
``repro_torch.kernels.ref.next_queue_ref``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels._checks import check, ptr, stream_ptr

launches = 0  # incremented once per kernel launch, nowhere else


class RouteGeometry(NamedTuple):
    """The fabric's queue-id layout, as ``Topology.build`` computes it, in
    plain ints; the fields a tier does not use are 0.  The kernel takes them
    in this order (``Fabric`` in ``csrc/next_queue.cu``)."""
    tiers: int
    hosts_per_tor: int
    n_tors: int
    uplinks_per_tor: int  # 2-tier: U ToR uplinks, one per spine
    aggs_per_pod: int  # 3-tier: A, also a ToR's uplinks
    agg_uplinks: int  # 3-tier: U2 core uplinks per agg
    tors_per_pod: int  # 3-tier
    n_pods: int  # 3-tier
    t0_up_base: int
    agg_up_base: int
    core_down_base: int
    agg_down_base: int
    t0_down_base: int
    n_queues: int


def check_geometry(g: RouteGeometry) -> RouteGeometry:
    """Raise unless ``g`` is a 2- or 3-tier layout whose divisors are >= 1."""
    if not isinstance(g, RouteGeometry):
        raise TypeError(f"next_queue needs a RouteGeometry, got {type(g).__name__}")
    divisors = {2: ("hosts_per_tor", "uplinks_per_tor"),
                3: ("hosts_per_tor", "aggs_per_pod", "agg_uplinks", "tors_per_pod", "n_pods")}
    if g.tiers not in divisors:
        raise ValueError(f"next_queue routes 2- and 3-tier fabrics, got tiers={g.tiers}")
    small = [f for f in divisors[g.tiers] if getattr(g, f) < 1]
    if small:
        raise ValueError(f"next_queue needs {', '.join(small)} >= 1, got {g}")
    return g


@functools.lru_cache(maxsize=64)
def _fabric(g: RouteGeometry) -> ctypes.Array:
    """``g`` checked, as the host int array the C entry point copies."""
    return (ctypes.c_int * len(g))(*check_geometry(g))


def _row_stride(t, name: str, shape: tuple, device) -> int:
    """The kernel's row stride of a per-row table: 0 for a shared ``(N,)``
    table or ``(B, N)`` rows expanded from one, ``N`` for contiguous rows.
    Raises unless ``t`` is int32 on ``device`` of ``(N,)`` or ``shape``."""
    if isinstance(t, torch.Tensor) and t.dim() == 1:
        check("next_queue", t, name, torch.int32, shape[-1:], device)
        return 0
    if not isinstance(t, torch.Tensor) or t.dtype is not torch.int32 or t.device != device \
            or t.shape != shape or len(shape) != 2 or t.stride(1) != 1 \
            or t.stride(0) not in (0, shape[1]):
        got = (f"{t.dtype} {tuple(t.shape)} on {t.device}, strides {t.stride()}"
               if isinstance(t, torch.Tensor) else type(t).__name__)
        raise ValueError(f"next_queue: {name} must be an int32 tensor on {device} of shape "
                         f"{tuple(shape[-1:])}, or {tuple(shape)} with row stride 0 or "
                         f"{shape[-1]} and unit column stride; got {got}")
    return t.stride(0)


def next_queue_cuda(g: RouteGeometry, at_injection, cur_queue, flow_id, ev, src, dst, q_len,
                    adaptive: bool, q_penalty=None, a_idx=None, n_pkt: int = 0) -> torch.Tensor:
    """``(K,)`` CUDA tensors -> int32 ``(K,)`` next queues, or with a leading
    row axis ``(B, K)`` -> ``(B, K)`` in the same one launch (``q_len`` then
    ``(B, NQ)``; ``q_penalty`` and the engine form's connection tables
    ``(NQ,)`` / ``(NC,)`` shared, or ``(B, ...)`` with row stride NQ / NC,
    one per row, or 0, one row's expanded); the arguments as
    ``ref.next_queue_ref`` (the engine's form when ``a_idx`` is given)."""
    global launches
    fabric = _fabric(g)
    if not isinstance(cur_queue, torch.Tensor) or cur_queue.dim() not in (1, 2) \
            or cur_queue.device.type != "cuda":
        raise ValueError("next_queue: cur_queue must be a (K,) or (B, K) CUDA tensor")
    dev, shape, i32 = cur_queue.device, cur_queue.shape, torch.int32
    rows = shape[:-1]  # () or (B,)
    engine = a_idx is not None
    for t, name in ((cur_queue, "cur_queue"), (flow_id, "flow_id"), (ev, "ev")):
        check("next_queue", t, name, i32, shape, dev)
    check("next_queue", at_injection, "at_injection (hop counts)" if engine else "at_injection",
          i32 if engine else torch.bool, shape, dev)
    n_conns = conn_stride = 0
    if engine:
        check("next_queue", a_idx, "a_idx", i32, shape, dev)
        n_conns = src.shape[-1] if isinstance(src, torch.Tensor) and src.dim() >= 1 else 0
        if n_conns < 1:
            raise ValueError("next_queue: the engine form needs (NC,) or (B, NC) connection "
                             "tables, NC >= 1")
        conn_stride = _row_stride(src, "src", (*rows, n_conns), dev)
        if _row_stride(dst, "dst", (*rows, n_conns), dev) != conn_stride:
            raise ValueError("next_queue: src and dst must have the same row stride")
    else:
        for t, name in ((src, "src"), (dst, "dst")):
            check("next_queue", t, name, i32, shape, dev)
    nq = g.n_queues
    check("next_queue", q_len, "q_len", i32, (*rows, nq), dev)
    pen_stride = 0 if q_penalty is None else _row_stride(q_penalty, "q_penalty", (*rows, nq), dev)
    out = torch.empty(shape, dtype=i32, device=dev)
    rc = build.library().repro_next_queue(
        fabric, at_injection.data_ptr(), cur_queue.data_ptr(), flow_id.data_ptr(),
        ev.data_ptr(), src.data_ptr(), dst.data_ptr(), ptr(a_idx), int(n_pkt), n_conns,
        conn_stride, q_len.data_ptr(), ptr(q_penalty), pen_stride, int(bool(adaptive)),
        out.numel(), shape[-1], out.data_ptr(), stream_ptr(dev),
    )
    build.check(rc, "next_queue")
    launches += 1
    return out
