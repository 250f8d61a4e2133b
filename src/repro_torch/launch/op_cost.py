"""Per-device cost of a step from the aten operations it dispatches: the
port's counterpart of ``repro.launch.hlo_cost`` (which walks XLA's
optimized HLO text).  PyTorch has no HLO, so this reads none: ``count()``
is a ``TorchDispatchMode`` that sees every operation the step runs (on real
tensors on the card, or on fake tensors under ``FakeTensorMode``, where
nothing is allocated) and adds it to an ``OpCost`` with ``HloCost``'s
fields:

  * ``flops``: matrix products, batched products, convolutions and
    scaled-dot-product attention, by ``torch.utils.flop_counter``'s
    formulas.  Elementwise work is not counted (the reference's rule).
  * ``bytes_accessed``: operand plus result bytes of every operation that
    is not a view, an allocation or a metadata query.  Eager PyTorch runs
    each operation as its own kernel, so this is the traffic the step
    really makes, not a bound (``copy_``, ``fill_`` and ``zero_`` do not
    read the tensor they overwrite).
  * ``bytes_min``: 2 x result bytes (the perfect-fusion floor).
  * ``coll_bytes`` / ``coll_breakdown``: the ``_c10d_functional``
    collectives, with the reference's ring factors: all-reduce 2 x
    operand, all-gather 1 x result, reduce-scatter, all-to-all and
    permute 1 x operand.

On a DTensor mesh the count is per device: an operation on DTensors is
passed on (the mode returns ``NotImplemented``), and DTensor runs it as
operations on each rank's local shard and the collectives its
redistributions need, which the mode then counts.  DTensor's own
bookkeeping (an op run once on global shapes to propagate metadata, the
offsets of strided shards) is not counted.

``LiveBytes`` tracks the bytes of the storages alive while the step runs
(its arguments registered first): its ``peak`` is the step's
high-water mark of memory in use.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

_COLL_FACTORS = {
    "all_reduce": ("all-reduce", "operand", 2.0),
    "all_reduce_coalesced": ("all-reduce", "operand", 2.0),
    "all_gather_into_tensor": ("all-gather", "result", 1.0),
    "all_gather_into_tensor_coalesced": ("all-gather", "result", 1.0),
    "reduce_scatter_tensor": ("reduce-scatter", "operand", 1.0),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", "operand", 1.0),
    "all_to_all_single": ("all-to-all", "operand", 1.0),
    "shard_dim_alltoall": ("all-to-all", "operand", 1.0),  # DTensor's, on a CUDA mesh
    "broadcast": ("collective-permute", "operand", 1.0),
}
# operations that move no bytes: allocations, metadata, waits
_FREE = {
    "empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided", "detach",
    "lift_fresh", "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
    "wait_tensor", "device", "set_", "resize_", "_local_scalar_dense", "_unsafe_view",
}
_OVERWRITE = {"copy_", "fill_", "zero_"}

_skip = threading.local()


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    """The plain (or fake) tensors of an op's arguments or outputs."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


@dataclasses.dataclass
class OpCost:
    flops: float = 0.0
    bytes_accessed: float = 0.0  # operands + results of every op that moves data
    bytes_min: float = 0.0  # 2 x result bytes (perfect-fusion floor)
    coll_bytes: float = 0.0
    coll_breakdown: dict = dataclasses.field(default_factory=dict)
    n_ops: int = 0
    rows: dict = dataclasses.field(default_factory=dict)  # (path, op) -> [count, flops, bytes]

    def breakdown(self) -> list[tuple[str, float, float, float]]:
        """``[(path/op, count, flops, bytes)]`` sorted by bytes, largest
        first: the counterpart of ``hlo_cost.breakdown``'s rows.  ``path``
        is the innermost model or train function the op was dispatched
        from (``module.function``), or the backward's ``autograd.<node>``."""
        out = [(f"{p}/{op}", v[0], v[1], v[2]) for (p, op), v in self.rows.items()]
        return sorted(out, key=lambda r: -r[3])


_NOT_CALLERS = ("repro_torch.launch.", "repro_torch.distrib.")


def _caller() -> str:
    """``module.function`` of the innermost model or train frame, or
    ``autograd.<node>`` in the backward."""
    node = torch._C._current_autograd_node()
    if node is not None:
        return f"autograd.{node.name()}"
    f = sys._getframe(2)
    while f is not None:
        name = f.f_globals.get("__name__", "")
        if name.startswith("repro_torch.") and not name.startswith(_NOT_CALLERS):
            return f"{name.rsplit('.', 1)[-1]}.{f.f_code.co_name}"
        f = f.f_back
    return "other"


def _alone(func, args) -> bool:
    """A collective over a group of one rank (a mesh dimension of size 1):
    it moves nothing."""
    if func.namespace not in ("_c10d_functional", "_dtensor"):
        return False
    from torch.distributed.distributed_c10d import _resolve_process_group

    names = [a for a in args if isinstance(a, str)]
    return bool(names) and _resolve_process_group(names[-1]).size() == 1


class _Counter(TorchDispatchMode):
    def __init__(self, cost: OpCost, rows: bool):
        super().__init__()
        self.cost = cost
        self.rows = rows

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it on the local shards, counted below
        out = func(*args, **kwargs)
        if getattr(_skip, "on", False):
            return out
        name = func._overloadpacket.__name__
        if func.is_view or name in _FREE or func.namespace == "prim" or _alone(func, args):
            return out
        c = self.cost
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        if name in _OVERWRITE:
            ins = ins[1:]
        outs = list(_tensors(out))
        rb = sum(map(_nbytes, outs))
        b = rb + sum(map(_nbytes, ins))
        fl = 0.0
        if func._overloadpacket in flop_registry:
            fl = float(flop_registry[func._overloadpacket](*args, **kwargs, out_val=out))
        c.flops += fl
        c.bytes_accessed += b
        c.bytes_min += 2.0 * rb
        c.n_ops += 1
        if func.namespace in ("_c10d_functional", "_dtensor"):
            # DTensor's all-to-all on a CPU mesh runs as other collectives
            coll = "all_to_all_single" if getattr(_skip, "alltoall", False) else name
            if coll not in _COLL_FACTORS:
                raise NotImplementedError(f"op_cost: no ring factor for the collective {coll}")
            kind, side, factor = _COLL_FACTORS[coll]
            moved = factor * (rb if side == "result" else sum(map(_nbytes, ins)))
            c.coll_bytes += moved
            c.coll_breakdown[kind] = c.coll_breakdown.get(kind, 0.0) + moved
        if self.rows:
            row = c.rows.setdefault((_caller(), name), [0, 0.0, 0.0])
            row[0] += 1
            row[1] += fl
            row[2] += b
        return out


def _aside(fn):
    """``fn`` run as DTensor's own bookkeeping: its operations are not
    counted, and any fake mode is set aside so that the small index
    tensors it reads back are real."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    def wrapped(*a, **k):
        prev = getattr(_skip, "on", False)
        _skip.on = True
        try:
            with unset_fake_temporarily():
                return fn(*a, **k)
        finally:
            _skip.on = prev

    return wrapped


@contextlib.contextmanager
def _dtensor_bookkeeping_aside():
    """DTensor propagates shardings by running an op once on fake tensors
    of the global shapes, and computes strided shards' offsets with index
    tensors; neither is the step's work.  (Patched for the block.)"""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard

    from torch.distributed.tensor import placement_types

    patched = [(ShardingPropagator, "propagate_op_sharding_non_cached"),
               (_StridedShard, "local_shard_size_and_offset")]
    orig = [cls.__dict__[name] for cls, name in patched]
    for (cls, name), fn in zip(patched, orig):
        if isinstance(fn, staticmethod):
            setattr(cls, name, staticmethod(_aside(fn.__func__)))
        else:
            setattr(cls, name, _aside(fn))
    # on a CPU mesh DTensor makes its all-to-all an all-gather and a chunk;
    # it is counted as the all-to-all it stands for
    alltoall = placement_types.shard_dim_alltoall

    def flagged(*a, **k):
        _skip.alltoall = True
        try:
            return alltoall(*a, **k)
        finally:
            _skip.alltoall = False

    placement_types.shard_dim_alltoall = flagged
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = alltoall
        for (cls, name), fn in zip(patched, orig):
            setattr(cls, name, fn)


@contextlib.contextmanager
def count(rows: bool = False):
    """Count the operations run inside the block into the ``OpCost`` it
    yields (``rows``: also per (function, op), for ``breakdown()``)."""
    cost = OpCost()
    with _dtensor_bookkeeping_aside(), _Counter(cost, rows):
        yield cost


# ---------------------------------------------------------------------------
# memory in use
# ---------------------------------------------------------------------------
class LiveBytes(TorchDispatchMode):
    """The bytes of the storages alive (each counted once, from its first
    appearance as an argument or an op's output until it is freed) and
    their high-water mark, ``peak``."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._seen: dict[int, weakref.ref] = {}

    def add(self, t) -> None:
        """Count ``t``'s storage (a plain or fake tensor, or a DTensor's
        local shard) if it is not counted yet."""
        from torch.distributed.tensor import DTensor

        if isinstance(t, DTensor):
            t = t._local_tensor
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)

        def freed(_, key=key, n=n):
            self.live -= n
            self._seen.pop(key, None)

        self._seen[key] = weakref.ref(st, freed)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if not getattr(_skip, "on", False):
            for t in _tensors(out):
                self.add(t)
        return out


def tree_bytes(tree) -> int:
    """Bytes of the distinct storages of a tree's tensors (a DTensor counts
    its local shard)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import tree_flatten_with_path

    seen, total = set(), 0
    for t in tree_flatten_with_path(tree).values():
        if isinstance(t, DTensor):
            t = t._local_tensor
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total

