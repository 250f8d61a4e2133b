"""CUDA wrapper of the ``seg_rank`` kernel (``csrc/seg_rank.cu``).

``rank[b, i] = #{j < i : seg[b, j] == seg[b, i]}``, stable in input order;
ids outside ``[0, S)`` rank 0.  The FIFO rank of same-connection ACK events
(the exact ``feedback_rounds`` replay) and of same-target arrivals.
Replaces the Pallas kernel ``repro.kernels.seg_rank``; the plain version is
``repro_torch.kernels.ref.seg_rank_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels._checks import check, stream_ptr

launches = 0  # incremented once per kernel launch, nowhere else
# above this the kernel's histogram lives in a (B, S) global scratch row
MAX_SHARED_SEGMENTS = 227 * 1024 // 4


def seg_rank_cuda(seg: torch.Tensor, n_segments: int) -> torch.Tensor:
    """``seg (K,)`` or ``(B, K)`` int32 on a CUDA device -> int32 ranks."""
    global launches
    if not isinstance(seg, torch.Tensor) or seg.dim() not in (1, 2) or seg.device.type != "cuda":
        raise ValueError("seg_rank: seg must be a (K,) or (B, K) CUDA tensor")
    dev = seg.device
    check("seg_rank", seg, "seg", torch.int32, seg.shape, dev)
    B = seg.shape[0] if seg.dim() == 2 else 1
    K, S = seg.shape[-1], int(n_segments)
    rank = torch.empty(seg.shape, dtype=torch.int32, device=dev)
    scratch = torch.empty((B, S), dtype=torch.int32, device=dev) if S > MAX_SHARED_SEGMENTS else None
    rc = build.library().repro_seg_rank(
        seg.data_ptr(), rank.data_ptr(), None if scratch is None else scratch.data_ptr(),
        B, K, S, stream_ptr(dev),
    )
    build.check(rc, "seg_rank")
    launches += 1
    return rank
