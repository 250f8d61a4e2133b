"""Dispatch of the seven kernels by the device of their tensors.

A CPU tensor goes to the kernel's plain version in ``ref`` — that is the
only reason the plain version runs.  A CUDA tensor goes to the hand-written
kernel, or the call raises: there is no fallback.  Each kernel module keeps
a plain-int ``launches`` count that its wrapper bumps once per launch;
``launch_counts`` / ``reset_launch_counts`` read and clear them, so a run
can show that its main path went through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ecmp_hash as _eh
from repro_torch.kernels import next_queue as _nq
from repro_torch.kernels import next_queue_table as _nqt
from repro_torch.kernels import queue_tick as _qt
from repro_torch.kernels import ref
from repro_torch.kernels import reps_update as _ru
from repro_torch.kernels import seg_rank as _sr
from repro_torch.kernels import seg_sum as _ss

KERNEL_MODULES = {
    "seg_sum": _ss, "seg_rank": _sr, "reps_tick": _ru, "queue_tick": _qt, "ecmp_hash": _eh,
    "next_queue": _nq, "next_queue_table": _nqt,
}


def _on_cuda(t: torch.Tensor, kernel: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{kernel}: no kernel or plain version for device {t.device}")


def seg_sum(seg: torch.Tensor, vals, n_segments: int) -> torch.Tensor:
    """``seg (K,)`` int32 and ``vals`` — a sequence of F bool / int32 fields
    shaped like ``seg``, or one stacked ``(F, K)`` int32 tensor — ->
    ``(F, n_segments)`` int32 segment sums (optional leading row axis); ids
    outside ``[0, n_segments)`` drop."""
    if _on_cuda(seg, "seg_sum"):
        return _ss.seg_sum_cuda(seg, vals, n_segments)
    return ref.seg_sum_ref(seg, vals, n_segments)


def seg_rank(seg: torch.Tensor, n_segments: int) -> torch.Tensor:
    """``(K,)`` int32 -> stable FIFO rank within each segment (ids outside
    ``[0, n_segments)`` rank 0); optional leading row axis."""
    if _on_cuda(seg, "seg_rank"):
        return _sr.seg_rank_cuda(seg, n_segments)
    return ref.seg_rank_ref(seg, n_segments)


def reps_tick(*args):
    """Fused REPS per-tick update (R ACK rounds, timeout, send); arguments
    as ``ref.reps_tick_ref``."""
    if _on_cuda(args[2], "reps_tick"):
        return _ru.reps_tick_cuda(*args)
    return ref.reps_tick_ref(*args)


def queue_tick(target, u, qlen, serve, capacity, kmin, kmax, red_rcp=None, pmax=1.0,
               q_head=None, qcap=None):
    """One switch tick: serve + enqueue + RED, optionally with the
    simulator's RED mark (``red_rcp``, ``pmax``) and each arrival's ring slot
    (``q_head``, ``qcap``); see ``ref.queue_tick_ref``."""
    args = (target, u, qlen, serve, capacity, kmin, kmax, red_rcp, pmax, q_head, qcap)
    if _on_cuda(target, "queue_tick"):
        return _qt.queue_tick_cuda(*args)
    return ref.queue_tick_ref(*args, tile=_qt.TILE)


def ecmp_hash(flow, ev, salt, nports) -> torch.Tensor:
    """``(K,)`` int32 (flow, EV, salt) -> the ECMP port in ``[0, nports)``;
    optional leading row axis; ``nports`` an int or an int32 tensor of
    per-lane counts that broadcasts against ``flow``; see
    ``ref.ecmp_hash_ref``."""
    if _on_cuda(flow, "ecmp_hash"):
        return _eh.ecmp_hash_cuda(flow, ev, salt, nports)
    return ref.ecmp_hash_ref(flow, ev, salt, nports)


def next_queue(g, at_injection, cur_queue, flow_id, ev, src, dst, q_len, adaptive: bool,
               q_penalty=None, a_idx=None, n_pkt: int = 0) -> torch.Tensor:
    """The routing step: each arrival's next queue on the fabric of layout
    ``g`` (a ``next_queue.RouteGeometry``), in the reference's form or, with
    ``a_idx``, the engine's; see ``ref.next_queue_ref``."""
    args = (g, at_injection, cur_queue, flow_id, ev, src, dst, q_len, adaptive, q_penalty,
            a_idx, n_pkt)
    if _on_cuda(cur_queue, "next_queue"):
        return _nq.next_queue_cuda(*args)
    return ref.next_queue_ref(*args)


def next_queue_table(t, at_injection, cur_queue, flow_id, ev, src, dst, q_len, adaptive: bool,
                     q_penalty=None, a_idx=None, n_pkt: int = 0) -> torch.Tensor:
    """The routing step of a generated fabric: each arrival's next queue by
    the tables ``t`` (a ``next_queue_table.RouteTables``), in the
    reference's form or, with ``a_idx``, the engine's; see
    ``ref.next_queue_table_ref``."""
    args = (t, at_injection, cur_queue, flow_id, ev, src, dst, q_len, adaptive, q_penalty,
            a_idx, n_pkt)
    if _on_cuda(cur_queue, "next_queue_table"):
        return _nqt.next_queue_table_cuda(*args)
    return ref.next_queue_table_ref(*args)


def launch_counts() -> dict[str, int]:
    return {name: mod.launches for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES.values():
        mod.launches = 0
