"""``tree_map`` over the port's state trees: a ``SimState``, a load
balancer's state, a trace or a tick's draws (dataclasses, tuples, named
tuples, tensors, ``None``)."""
from __future__ import annotations

import dataclasses
import functools

import torch


def tree_map(fn, x, *rest):
    """``fn`` over the tensors of a state tree, with ``rest`` trees of the
    same structure as further arguments.  The tick maps a few trees per
    call, so the common cases come first."""
    if isinstance(x, torch.Tensor):
        return fn(x, *rest)
    if x is None:
        return None
    if isinstance(x, tuple):
        leaves = (tree_map(fn, *vs) for vs in zip(x, *rest))
        return type(x)(*leaves) if hasattr(x, "_fields") else tuple(leaves)
    names = _field_names(type(x))
    return type(x)(**{n: tree_map(fn, getattr(x, n), *(getattr(r, n) for r in rest))
                      for n in names})


@functools.lru_cache(maxsize=None)
def _field_names(cls) -> tuple[str, ...]:
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"a state tree holds tensors, tuples and dataclasses, not {cls.__name__}")
    return tuple(f.name for f in dataclasses.fields(cls))
