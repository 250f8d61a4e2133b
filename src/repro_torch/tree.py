"""``tree_map`` over the port's state trees: a ``SimState``, a load
balancer's state, a trace or a tick's draws (dataclasses, tuples, named
tuples, tensors, ``None``); and a path-keyed flatten / unflatten of such
trees (dicts too, numpy arrays as leaves) that names each leaf stably, for
checkpoints."""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
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


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def tree_map_with_path(fn, x, path: str = ""):
    """``fn(path, leaf)`` over the tensors (or numpy arrays) of a state tree,
    rebuilding its structure; ``path`` names a leaf by the steps to it,
    joined by ``/``: a dataclass or named-tuple field by its name, a tuple
    or list element by its index, a dict entry by its key.  The names are
    stable for a given structure, which is what checkpoint files key their
    arrays by."""
    join = lambda k: f"{path}/{k}" if path else str(k)
    if _is_leaf(x):
        return fn(path, x)
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: tree_map_with_path(fn, v, join(k)) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        if hasattr(x, "_fields"):
            return type(x)(*(tree_map_with_path(fn, getattr(x, f), join(f)) for f in x._fields))
        return type(x)(tree_map_with_path(fn, v, join(i)) for i, v in enumerate(x))
    names = _field_names(type(x))
    return type(x)(**{n: tree_map_with_path(fn, getattr(x, n), join(n)) for n in names})


def tree_flatten_with_path(x) -> dict:
    """``{path: leaf}`` of a state tree, in the tree's order (see
    ``tree_map_with_path`` for the names; a tree that is one leaf is
    ``{"_": leaf}``)."""
    out: dict = {}
    tree_map_with_path(lambda p, t: out.__setitem__(p or "_", t), x)
    return out


def tree_unflatten_like(like, flat: dict):
    """A tree shaped like ``like`` whose leaves are ``flat[path]``."""
    return tree_map_with_path(lambda p, _: flat[p or "_"], like)


def tree_structure(x) -> str:
    """A short description of a tree's structure (its node types and
    leaf paths), for a checkpoint's manifest."""
    parts = []
    tree_map_with_path(lambda p, t: parts.append(f"{p}:{t.dtype}"), x)
    return f"{type(x).__name__}[{', '.join(parts)}]"
