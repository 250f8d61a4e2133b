"""CUDA wrapper of the ``seg_sum`` kernel (``csrc/seg_sum.cu``).

``out[b, f, s] = sum_k vals[b, f, k] * (seg[b, k] == s)``: the stacked
per-connection event aggregation of every stage of the tick.  Replaces the
Pallas kernel ``repro.kernels.seg_sum``; the plain version is
``repro_torch.kernels.ref.seg_sum_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels._checks import require

launches = 0  # incremented once per kernel launch, nowhere else


def seg_sum_cuda(seg: torch.Tensor, vals: torch.Tensor, n_segments: int) -> torch.Tensor:
    """``seg (K,)`` / ``vals (F, K)`` -> ``(F, S)``, or with a leading row
    axis ``(B, K)`` / ``(B, F, K)`` -> ``(B, F, S)``; int32 on one CUDA device."""
    global launches
    batched = seg.dim() == 2
    require(seg, "seg", torch.int32, 2 if batched else 1)
    require(vals, "vals", torch.int32, 3 if batched else 2, device=seg.device)
    B = seg.shape[0] if batched else 1
    K = seg.shape[-1]
    F = vals.shape[-2]
    if vals.shape[-1] != K or (batched and vals.shape[0] != B):
        raise ValueError(f"seg {tuple(seg.shape)} and vals {tuple(vals.shape)} disagree")
    S = int(n_segments)
    out = torch.empty((B, F, S), dtype=torch.int32, device=seg.device)
    rc = build.library().repro_seg_sum(
        seg.data_ptr(), vals.data_ptr(), out.data_ptr(), B, F, K, S,
        torch.cuda.current_stream(seg.device).cuda_stream,
    )
    build.check(rc, "seg_sum")
    launches += 1
    return out if batched else out[0]
