"""How ``correct`` is decided: the rows that the timed path produced against
the plain reference, leaf by leaf, bit for bit.

Every compared number is a count of elements that differ, with the limit 0:
the simulator's results are exact (integer state, and float32 congestion
state rounded as the reference rounds it), so any difference is a fault.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

LIMITS = {"state_diff": 0, "lb_state_diff": 0, "telemetry_diff": 0, "quiescence_diff": 0}
# the last slot of these axes (counted after the row axis) is the engine's sink
# for the writes of padded lanes, not state: the JAX package's state has no
# such slot, and on the card its content depends on which of several writes
# to it lands, in the program and in the reference alike
SENTINEL_AXIS = {"pkt": 1, "qbuf": 0, "c_rtx": 0, "c_rcv": 0, "fl": 0}


def flatten(x, prefix: str = "") -> dict:
    """A state tree (dataclasses, named tuples, tuples, tensors) as
    ``{path: numpy array}``; ``None`` leaves are left out."""
    if x is None:
        return {}
    if isinstance(x, torch.Tensor):
        return {prefix: x.detach().cpu().numpy()}
    if dataclasses.is_dataclass(x):
        items = [(f.name, getattr(x, f.name)) for f in dataclasses.fields(x)]
    elif hasattr(x, "_fields"):
        items = list(zip(x._fields, x))
    elif isinstance(x, (tuple, list)):
        items = list(enumerate(x))
    else:
        return {prefix: np.asarray(x)}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype.kind == "f":  # compare floats by their bits (-0.0, NaN)
        return a.view(np.int32 if a.itemsize == 4 else np.int64)
    return a.astype(np.int64)


def without_sentinels(leaves: dict) -> dict:
    """The state's leaves with each sentinel slot taken off."""
    out = dict(leaves)
    for k, ax in SENTINEL_AXIS.items():
        if k in out:
            a = out[k]
            out[k] = np.take(a, np.arange(a.shape[ax + 1] - 1), axis=ax + 1)
    return out


def diff_rows(got: dict, want: dict) -> np.ndarray:
    """Per row (leading axis), the number of elements of ``got`` that differ
    from ``want``; a leaf missing on one side or shaped differently counts
    every element of the other."""
    n_rows = next(iter(want.values())).shape[0] if want else 0
    out = np.zeros(n_rows, np.int64)
    for k in set(got) | set(want):
        a, b = got.get(k), want.get(k)
        if a is None or b is None or a.shape != b.shape:
            c = b if b is not None else a
            out += int(np.prod(c.shape[1:], dtype=np.int64))
            continue
        ne = _bits(a) != _bits(b)
        out += ne.reshape(ne.shape[0], -1).sum(axis=1)
    return out


def compare(prog_rows, ref_rows) -> dict:
    """``{number: per-row counts}`` for one batch's sampled rows:
    ``prog_rows`` and ``ref_rows`` are ``(states, telemetry or None)``."""
    (p_st, p_tel), (r_st, r_tel) = prog_rows, ref_rows
    p, r = without_sentinels(flatten(p_st)), without_sentinels(flatten(r_st))
    lb = lambda d: {k: v for k, v in d.items() if k.startswith("lb_state")}
    rest = lambda d: {k: v for k, v in d.items() if not k.startswith("lb_state")}
    out = {"state_diff": diff_rows(rest(p), rest(r)), "lb_state_diff": diff_rows(lb(p), lb(r))}
    if r_tel is not None or p_tel is not None:
        out["telemetry_diff"] = diff_rows(flatten(p_tel, "tel"), flatten(r_tel, "tel"))
    return out
