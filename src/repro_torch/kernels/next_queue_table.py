"""CUDA wrapper of the ``next_queue_table`` kernel (``csrc/next_queue_table.cu``).

The routing step of a generated fabric (``netsim/topogen.py``) in one
launch: for each arrival, the queue it enters next by the fabric's tables
(``TableTopology.next_queue`` of the reference: the down table, else the
ECMP hash over the switch's up block, or the first least-loaded candidate
under adaptive routing).  The table form of ``next_queue.py``'s kernel, and
like it the redesign for this card of the Pallas kernel
``repro.kernels.ecmp_hash``: the same two forms (the reference's signature;
the engine's compacted slots and gathers) and the same row axis.  The
plain version is ``repro_torch.kernels.ref.next_queue_table_ref``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels._checks import check, ptr, stream_ptr
from repro_torch.kernels.next_queue import _row_stride

launches = 0  # incremented once per kernel launch, nowhere else


class RouteTables(NamedTuple):
    """A ``TopologySpec``'s routing tables as int32 tensors on one device
    (``TableTopology.tables``), and the candidate count of the adaptive pick
    (``max(spec.max_up_deg, 1)``)."""
    host_sw: torch.Tensor  # (NH,) host -> its ToR
    q_sw: torch.Tensor  # (NQ,) queue -> the switch it feeds, -1 on host downlinks
    up_base: torch.Tensor  # (NS, NH) first up candidate toward dst
    up_deg: torch.Tensor  # (NS,) up candidates, 0 at a top switch
    down_next: torch.Tensor  # (NS, NH) down queue toward dst, -1: go up
    salt: torch.Tensor  # (NS,) ECMP salt plane
    max_up_deg: int  # >= 1

    @property
    def n_hosts(self) -> int:
        return self.host_sw.shape[0]

    @property
    def n_queues(self) -> int:
        return self.q_sw.shape[0]

    @property
    def n_switches(self) -> int:
        return self.up_deg.shape[0]


def check_tables(t: RouteTables, device) -> RouteTables:
    """Raise unless ``t`` is a ``RouteTables`` of contiguous int32 tensors of
    consistent shapes on ``device``, with ``max_up_deg >= 1``."""
    if not isinstance(t, RouteTables):
        raise TypeError(f"next_queue_table needs RouteTables, got {type(t).__name__}")
    NH, NQ, NS = t.n_hosts, t.n_queues, t.n_switches
    if min(NH, NQ, NS) < 1 or int(t.max_up_deg) < 1:
        raise ValueError(f"next_queue_table: empty tables or max_up_deg < 1 (NH={NH}, NQ={NQ}, "
                         f"NS={NS}, max_up_deg={t.max_up_deg})")
    for name, shape in (("host_sw", (NH,)), ("q_sw", (NQ,)), ("up_base", (NS, NH)),
                        ("up_deg", (NS,)), ("down_next", (NS, NH)), ("salt", (NS,))):
        check("next_queue_table", getattr(t, name), name, torch.int32, shape, device)
    return t


def next_queue_table_cuda(t: RouteTables, at_injection, cur_queue, flow_id, ev, src, dst,
                          q_len, adaptive: bool, q_penalty=None, a_idx=None,
                          n_pkt: int = 0) -> torch.Tensor:
    """``(K,)`` or ``(B, K)`` CUDA tensors -> int32 next queues of the same
    shape, in one launch; the arguments as ``ref.next_queue_table_ref`` (the
    engine's form when ``a_idx`` is given), the rows as
    ``next_queue.next_queue_cuda`` takes them."""
    global launches
    if not isinstance(cur_queue, torch.Tensor) or cur_queue.dim() not in (1, 2) \
            or cur_queue.device.type != "cuda":
        raise ValueError("next_queue_table: cur_queue must be a (K,) or (B, K) CUDA tensor")
    dev, shape, i32 = cur_queue.device, cur_queue.shape, torch.int32
    t = check_tables(t, dev)
    rows = shape[:-1]
    engine = a_idx is not None
    for x, name in ((cur_queue, "cur_queue"), (flow_id, "flow_id"), (ev, "ev")):
        check("next_queue_table", x, name, i32, shape, dev)
    check("next_queue_table", at_injection,
          "at_injection (hop counts)" if engine else "at_injection",
          i32 if engine else torch.bool, shape, dev)
    n_conns = conn_stride = 0
    if engine:
        check("next_queue_table", a_idx, "a_idx", i32, shape, dev)
        n_conns = src.shape[-1] if isinstance(src, torch.Tensor) and src.dim() >= 1 else 0
        if n_conns < 1:
            raise ValueError("next_queue_table: the engine form needs (NC,) or (B, NC) "
                             "connection tables, NC >= 1")
        conn_stride = _row_stride(src, "src", (*rows, n_conns), dev)
        if _row_stride(dst, "dst", (*rows, n_conns), dev) != conn_stride:
            raise ValueError("next_queue_table: src and dst must have the same row stride")
    else:
        for x, name in ((src, "src"), (dst, "dst")):
            check("next_queue_table", x, name, i32, shape, dev)
    nq = t.n_queues
    check("next_queue_table", q_len, "q_len", i32, (*rows, nq), dev)
    pen_stride = 0 if q_penalty is None else _row_stride(q_penalty, "q_penalty", (*rows, nq),
                                                         dev)
    out = torch.empty(shape, dtype=i32, device=dev)
    rc = build.library().repro_next_queue_table(
        t.host_sw.data_ptr(), t.q_sw.data_ptr(), t.up_base.data_ptr(), t.up_deg.data_ptr(),
        t.down_next.data_ptr(), t.salt.data_ptr(), t.n_hosts, nq, t.n_switches,
        int(t.max_up_deg), at_injection.data_ptr(), cur_queue.data_ptr(), flow_id.data_ptr(),
        ev.data_ptr(), src.data_ptr(), dst.data_ptr(), ptr(a_idx), int(n_pkt), n_conns,
        conn_stride, q_len.data_ptr(), ptr(q_penalty), pen_stride, int(bool(adaptive)),
        out.numel(), shape[-1], out.data_ptr(), stream_ptr(dev),
    )
    build.check(rc, "next_queue_table")
    launches += 1
    return out
