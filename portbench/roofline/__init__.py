"""Bytes that an operation needs, from its call shapes, and the card's peaks.

The rule (``PERF.md``'s kernel table, ``chip_smoke.py``'s ``nbytes``): each
input read once and each output written once, at its dtype's width; a
broadcast (stride-0) axis is read once.  Both operations here are
memory-bound (a few integer operations per byte), so the roofline time is
bytes over the HBM rate.  The counts depend on the operation's shapes
alone, not on the kernel that computes it.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet (dense, at the 700 W limit)
PEAKS = {"hbm_bytes_per_s": 3.35e12}


def tensor_bytes(shape, strides, itemsize: int) -> int:
    """Bytes of one tensor read or written once: axes of stride 0 count once."""
    n = 1
    for size, stride in zip(shape, strides):
        if stride != 0:
            n *= int(size)
    return n * int(itemsize)


def seg_sum_bytes(seg: tuple, fields: list[tuple], n_segments: int) -> int:
    """``seg (..., K)`` int32 and F fields ``(..., K)`` (bool or int32), or one
    stacked ``(..., F, K)`` int32 tensor -> ``(..., F, S)`` int32 sums.
    ``seg`` and each field are ``(shape, strides, itemsize)``."""
    seg_shape = seg[0]
    lead = 1
    for d in seg_shape[:-1]:
        lead *= int(d)
    if len(fields) == 1 and len(fields[0][0]) == len(seg_shape) + 1:
        n_fields = int(fields[0][0][-2])  # the stacked form
    else:
        n_fields = len(fields)
    out = lead * n_fields * int(n_segments) * 4
    return tensor_bytes(*seg) + sum(tensor_bytes(*f) for f in fields) + out


def reps_tick_bytes(inputs: list[tuple], outputs: list[tuple]) -> int:
    """The fused REPS update: the eight state tensors and the event tensors
    it is given read once, the state it returns and the EVs written once."""
    return sum(tensor_bytes(*t) for t in inputs) + sum(tensor_bytes(*t) for t in outputs)


def roofline_pct(n_bytes: int, device_s: float) -> float | None:
    """The share of the HBM roofline, in %: None where nothing ran."""
    if device_s <= 0 or n_bytes <= 0:
        return None
    return 100.0 * n_bytes / PEAKS["hbm_bytes_per_s"] / device_s


class CallRecorder:
    """Records the shapes of every ``seg_sum`` and ``reps_tick`` call made
    through ``repro_torch.kernels.ops`` while installed, and their bytes."""

    def __init__(self, ops_module):
        self.ops = ops_module
        self.bytes = {"seg_sum": 0, "reps_tick": 0}
        self._orig = {}

    def __enter__(self):
        import torch

        desc = lambda t: (tuple(t.shape), tuple(t.stride()), t.element_size())
        flat = lambda xs: [x for x in xs if isinstance(x, torch.Tensor)] + [
            y for x in xs if isinstance(x, (tuple, list)) for y in flat(x)]
        rec = self

        def seg_sum(seg, vals, n_segments, _f=self.ops.seg_sum):
            fields = [vals] if isinstance(vals, torch.Tensor) else list(vals)
            rec.bytes["seg_sum"] += seg_sum_bytes(desc(seg), [desc(f) for f in fields],
                                                  int(n_segments))
            return _f(seg, vals, n_segments)

        def reps_tick(*args, trace_rows=None, _f=self.ops.reps_tick):
            out = _f(*args, trace_rows=trace_rows)
            rec.bytes["reps_tick"] += reps_tick_bytes([desc(t) for t in flat(list(args))],
                                                      [desc(t) for t in flat(list(out))])
            return out

        self._orig = {"seg_sum": self.ops.seg_sum, "reps_tick": self.ops.reps_tick}
        self.ops.seg_sum, self.ops.reps_tick = seg_sum, reps_tick
        return self

    def __exit__(self, *exc):
        for k, f in self._orig.items():
            setattr(self.ops, k, f)
        return False
