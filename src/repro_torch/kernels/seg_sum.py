"""CUDA wrapper of the ``seg_sum`` kernel (``csrc/seg_sum.cu``).

``out[b, f, s] = sum_k vals_f[b, k] * (seg[b, k] == s)``: the
per-connection event aggregation of every stage of the tick.  The fields
come as they are — a sequence of up to ``MAX_FIELDS`` bool or int32 tensors
shaped like ``seg`` — or as the reference's stacked int32 ``(F, K)`` tensor.
Replaces the Pallas kernel ``repro.kernels.seg_sum``; the plain version is
``repro_torch.kernels.ref.seg_sum_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels._checks import require, stream_ptr

MAX_FIELDS = 8  # fields one launch takes, compiled into the kernel
launches = 0  # incremented once per kernel launch, nowhere else

_FIELD_PTRS = ctypes.c_void_p * MAX_FIELDS


def seg_sum_cuda(seg: torch.Tensor, vals, n_segments: int) -> torch.Tensor:
    """``seg (K,)`` with ``vals`` a sequence of F ``(K,)`` bool / int32
    fields or one ``(F, K)`` int32 tensor -> ``(F, S)`` int32; with a leading
    row axis ``(B, K)`` / F ``(B, K)`` fields or ``(B, F, K)`` ->
    ``(B, F, S)``.  All on one CUDA device, 1 <= F <= ``MAX_FIELDS``."""
    global launches
    batched = seg.dim() == 2
    require(seg, "seg", torch.int32, 2 if batched else 1)
    dev = seg.device
    B = seg.shape[0] if batched else 1
    K = seg.shape[-1]
    bool_mask = 0
    if isinstance(vals, torch.Tensor):  # the stacked form: field f of row b at (b*F + f)*K
        require(vals, "vals", torch.int32, 3 if batched else 2, device=dev)
        if vals.shape[-1] != K or (batched and vals.shape[0] != B):
            raise ValueError(f"seg {tuple(seg.shape)} and vals {tuple(vals.shape)} disagree")
        F = vals.shape[-2]
        base = vals.data_ptr()
        ptrs = [base + 4 * K * f for f in range(F)]
        row_stride = F * K
    else:
        ptrs = []
        for f, t in enumerate(vals):
            if not isinstance(t, torch.Tensor):
                raise TypeError(f"seg_sum: field {f} must be a tensor, got {type(t).__name__}")
            if t.dtype is torch.bool:
                bool_mask |= 1 << f
            elif t.dtype is not torch.int32:
                raise TypeError(f"seg_sum: field {f} must be bool or int32, got {t.dtype}")
            if t.device != dev or t.shape != seg.shape or not t.is_contiguous():
                raise ValueError(
                    f"seg_sum: field {f} must be contiguous, shaped like seg "
                    f"{tuple(seg.shape)} on {dev}; got {tuple(t.shape)} on {t.device}")
            ptrs.append(t.data_ptr())
        F = len(ptrs)
        row_stride = K
    if not 1 <= F <= MAX_FIELDS:
        raise ValueError(f"seg_sum takes 1 to {MAX_FIELDS} fields, got {F}")
    S = int(n_segments)
    out = torch.empty((B, F, S) if batched else (F, S), dtype=torch.int32, device=dev)
    rc = build.library().repro_seg_sum(
        seg.data_ptr(), _FIELD_PTRS(*ptrs), F, bool_mask, row_stride, out.data_ptr(), B, K, S,
        stream_ptr(dev),
    )
    build.check(rc, "seg_sum")
    launches += 1
    return out
