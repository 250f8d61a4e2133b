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


def next_queue_cuda(g: RouteGeometry, at_injection, cur_queue, flow_id, ev, src, dst, q_len,
                    adaptive: bool, q_penalty=None, a_idx=None, n_pkt: int = 0) -> torch.Tensor:
    """``(K,)`` CUDA tensors -> int32 ``(K,)`` next queues, or with a leading
    row axis ``(B, K)`` -> ``(B, K)`` in the same one launch (``q_len`` then
    ``(B, NQ)``, ``q_penalty`` ``(NQ,)`` shared or ``(B, NQ)``); the
    arguments as ``ref.next_queue_ref`` (the engine's form when ``a_idx`` is
    given)."""
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
    n_conns = 0
    if engine:
        check("next_queue", a_idx, "a_idx", i32, shape, dev)
        n_conns = src.shape[0] if isinstance(src, torch.Tensor) and src.dim() == 1 else 0
        if n_conns < 1:
            raise ValueError("next_queue: the engine form needs (NC,) connection tables, NC >= 1")
    for t, name in ((src, "src"), (dst, "dst")):
        check("next_queue", t, name, i32, (n_conns,) if engine else shape, dev)
    nq = g.n_queues
    check("next_queue", q_len, "q_len", i32, (*rows, nq), dev)
    pen_stride = 0
    if q_penalty is not None:
        per_row = bool(rows) and q_penalty.dim() == 2
        check("next_queue", q_penalty, "q_penalty", i32, (*rows, nq) if per_row else (nq,), dev)
        pen_stride = nq if per_row else 0
    out = torch.empty(shape, dtype=i32, device=dev)
    rc = build.library().repro_next_queue(
        fabric, at_injection.data_ptr(), cur_queue.data_ptr(), flow_id.data_ptr(),
        ev.data_ptr(), src.data_ptr(), dst.data_ptr(), ptr(a_idx), int(n_pkt), n_conns,
        q_len.data_ptr(), ptr(q_penalty), pen_stride, int(bool(adaptive)), out.numel(),
        shape[-1], out.data_ptr(), stream_ptr(dev),
    )
    build.check(rc, "next_queue")
    launches += 1
    return out
