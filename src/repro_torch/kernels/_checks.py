"""Argument checks shared by the CUDA kernel wrappers."""
from __future__ import annotations

import torch


def require(t, name: str, dtype: torch.dtype, dim: int, device=None, optional=False):
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and rank
    ``dim`` (on ``device`` when given).  ``None`` passes when ``optional``."""
    if t is None and optional:
        return
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got one on {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name} must have {dim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check(kernel: str, t, name: str, dtype: torch.dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: every condition in one test, the message only on failure."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{kernel}: {name} must be a tensor, got {type(t).__name__}")
    if t.dtype is not dtype or t.device != device or t.shape != shape or not t.is_contiguous():
        raise ValueError(
            f"{kernel}: {name} must be a contiguous {dtype} tensor of shape {tuple(shape)} "
            f"on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            + ("" if t.is_contiguous() else " (not contiguous)"))


def stream_ptr(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of ``device``'s current stream.  The same
    value as ``torch.cuda.current_stream(device).cuda_stream``, read
    without building a ``torch.cuda.Stream`` object per launch; the call
    Triton's launcher makes."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def ptr(t) -> int | None:
    """Device pointer of an optional tensor (``None`` -> null)."""
    return None if t is None else t.data_ptr()
