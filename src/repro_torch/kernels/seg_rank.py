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
from repro_torch.kernels._checks import require

launches = 0  # incremented once per kernel launch, nowhere else
MAX_SHARED_SEGMENTS = 227 * 1024 // 4  # above this the histogram lives in a scratch row


def seg_rank_cuda(seg: torch.Tensor, n_segments: int) -> torch.Tensor:
    """``seg (K,)`` or ``(B, K)`` int32 on a CUDA device -> int32 ranks."""
    global launches
    batched = seg.dim() == 2
    require(seg, "seg", torch.int32, 2 if batched else 1)
    B = seg.shape[0] if batched else 1
    K, S = seg.shape[-1], int(n_segments)
    rank = torch.empty((B, K), dtype=torch.int32, device=seg.device)
    scratch = (
        torch.empty((B, S), dtype=torch.int32, device=seg.device)
        if S > MAX_SHARED_SEGMENTS else None
    )
    rc = build.library().repro_seg_rank(
        seg.data_ptr(), rank.data_ptr(), None if scratch is None else scratch.data_ptr(),
        B, K, S, torch.cuda.current_stream(seg.device).cuda_stream,
    )
    build.check(rc, "seg_rank")
    launches += 1
    return rank if batched else rank[0]
