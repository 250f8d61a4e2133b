"""Logical-axis sharding rules over a DTensor ``DeviceMesh`` (counterpart of
``repro.distrib.sharding``, its model half).

Models annotate activations and parameters with *logical* axes ("batch",
"seq", "heads", "embed", "mlp", "experts", "vocab", "kv_seq", ...).  A rule
table maps logical axes to mesh axes; ``shard()`` redistributes a DTensor
to the placements the rules give when a mesh is active, and returns its
argument itself otherwise (one card runs the same code and dispatches
nothing for it).

``resolve_spec`` returns what the reference's ``PartitionSpec`` holds, one
entry per tensor dimension: ``None``, a mesh-axis name, or a tuple of
names (major first).  ``placements`` turns such a spec into DTensor
placements: ``Shard(dim)`` on every mesh dimension that shards ``dim``,
``Replicate()`` on the others.

The rule table is swappable (``mesh_rules(mesh, rules)``), as in the
reference.

The sweep half (reference ``src/repro/distrib/sharding.py:124-202``)
builds the network simulator's meshes over the ranks of the active process
group (``repro_torch.distrib.ranks``): ``sweep_mesh`` a 1-D ``("rows",)``
mesh for row-parallel sweeps, ``sweep_conn_mesh`` a 2-D ``("rows",
"conns")`` mesh for scale mode's connection axis, ``pad_rows`` the row
count padded to the row axis.  The reference's ``resolve_kernels_backend``
(Pallas or jnp by the mesh's platform) has no counterpart: in the port the
device picks the kernel path.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import torch

# The baseline rule set: pure data parallelism over pod + data, tensor and
# expert parallelism over model (the reference's table, entry for entry).
DEFAULT_RULES: dict[str, tuple[str, ...] | str | None] = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_model": "model",  # sequence-parallel attention (low-head archs)
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "kv_seq": "model",  # flash-decode: KV cache sharded along sequence
    "mlp": "model",
    "experts": "model",
    "expert_cap": None,
    "vocab": "model",
    "head_dim": None,  # fsdp: ("data",)
    "moe_fsdp": None,  # fsdp: ("data",)
    "qkv": None,
    "state": "model",  # SSM/RWKV channel-parallel state
    "layers": None,
}

Spec = tuple  # one entry per dimension: None, a mesh-axis name, or a tuple of names

_local = threading.local()


def _ctx():
    if not hasattr(_local, "mesh"):
        _local.mesh = None
        _local.rules = dict(DEFAULT_RULES)
    return _local


def _axis_names(mesh) -> tuple[str, ...]:
    """The mesh's axis names: a ``DeviceMesh``'s ``mesh_dim_names``, or the
    ``axis_names`` of any object that also maps ``shape[name]`` to a size
    (a stand-in mesh in tests)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def _axis_size(mesh, name: str) -> int:
    if hasattr(mesh, "mesh_dim_names"):
        return mesh.size(mesh.mesh_dim_names.index(name))
    return mesh.shape[name]


@contextlib.contextmanager
def mesh_rules(mesh, rules: Optional[dict] = None):
    """Activate a mesh and a rule table for ``shard()`` calls in this
    thread."""
    c = _ctx()
    prev = (c.mesh, c.rules)
    c.mesh = mesh
    c.rules = {**DEFAULT_RULES, **(rules or {})}
    try:
        yield
    finally:
        c.mesh, c.rules = prev


def active_mesh():
    return _ctx().mesh


def resolve_spec(logical_axes: Sequence[Optional[str]],
                 shape: Optional[Sequence[int]] = None) -> Spec:
    """Map logical axis names to per-dimension mesh axes under the active
    rules, dropping mesh axes that the active mesh lacks.  A mesh axis
    shards at most one dimension.  When ``shape`` is given, mesh axes that
    do not divide the dimension are dropped, the minor one first (8 KV
    heads cannot shard 16 ways; batch 1 cannot be data-parallel)."""
    c = _ctx()
    mesh = c.mesh
    mesh_axes = set(_axis_names(mesh)) if mesh is not None else set()
    out = []
    used: set[str] = set()
    for i, ax in enumerate(logical_axes):
        if ax is None:
            out.append(None)
            continue
        rule = c.rules.get(ax, None)
        if rule is None:
            kept: tuple[str, ...] = ()
        elif isinstance(rule, str):
            kept = (rule,) if rule in mesh_axes else ()
        else:
            kept = tuple(r for r in rule if r in mesh_axes)
        kept = tuple(r for r in kept if r not in used)
        if shape is not None and kept:
            dim = shape[i]
            while kept:
                total = 1
                for r in kept:
                    total *= _axis_size(mesh, r)
                if dim % total == 0:
                    break
                kept = kept[:-1]
        used.update(kept)
        out.append(kept if len(kept) > 1 else (kept[0] if kept else None))
    return tuple(out)


def placements(mesh, spec: Spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dimension,
    ``Shard(d)`` where dimension ``d``'s entry names it, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    by_axis = {}
    for d, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                by_axis[name] = d
    return tuple(Shard(by_axis[n]) if n in by_axis else Replicate()
                 for n in _axis_names(mesh))


def local_shape(mesh, shape: Sequence[int], places) -> tuple[int, ...]:
    """The shape of one rank's shard of a tensor of ``shape`` placed by
    ``places`` (every sharded dimension divides evenly)."""
    out = list(shape)
    for i, p in enumerate(places):
        if p.is_shard():
            out[p.dim] //= mesh.size(i)
    return tuple(out)


def contiguous_stride(shape: Sequence[int]) -> tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape`` (computed, so that
    no tensor of the global shape is made, not even a fake one)."""
    out, n = [], 1
    for d in reversed(tuple(shape)):
        out.append(n)
        n *= d
    return tuple(reversed(out))


def shard(x, *logical_axes: Optional[str]):
    """Redistribute ``x`` (a DTensor) to the sharding its logical axes give
    under the active mesh; with no mesh, ``x`` itself."""
    c = _ctx()
    if c.mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    assert len(logical_axes) == x.ndim, (logical_axes, x.shape)
    if not isinstance(x, DTensor):
        raise TypeError(f"shard{logical_axes}: a {type(x).__name__} under an active mesh; the "
                        "step's tensors are DTensors there (make a new tensor like its input)")
    want = placements(c.mesh, resolve_spec(logical_axes, x.shape))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(c.mesh, want)


def _placed_like(like, shape, logical_axes):
    """The placements for a new tensor of ``shape`` made inside a step
    beside ``like`` (a DTensor): those its logical axes give, or with
    none, ``like``'s on the leading dimensions the two share."""
    c = _ctx()
    if logical_axes:
        return placements(c.mesh, resolve_spec(logical_axes, shape))
    from torch.distributed.tensor import Replicate

    return tuple(p if not p.is_shard() or p.dim < len(shape) else Replicate()
                 for p in like.placements)


def full(shape, value, dtype, like, *logical_axes):
    """``torch.full(shape, value)`` on ``like``'s device (``like``: a
    tensor or a device); under a mesh, when ``like`` is a DTensor, a
    DTensor placed by ``logical_axes`` (or like ``like``), each rank
    allocating only its shard."""
    from torch.distributed.tensor import DTensor

    c = _ctx()
    if c.mesh is None or not isinstance(like, DTensor):
        return torch.full(shape, value, dtype=dtype, device=getattr(like, "device", like))
    pl = _placed_like(like, shape, logical_axes)
    local = torch.full(local_shape(c.mesh, shape, pl), value, dtype=dtype, device=like.device)
    return DTensor.from_local(local, c.mesh, pl, run_check=False, shape=tuple(shape),
                              stride=contiguous_stride(shape))


def zeros(shape, dtype, like, *logical_axes):
    """``torch.zeros(shape)`` on ``like``'s device, placed as ``full``
    places it."""
    from torch.distributed.tensor import DTensor

    if _ctx().mesh is None or not isinstance(like, DTensor):
        return torch.zeros(shape, dtype=dtype, device=getattr(like, "device", like))
    return full(shape, 0, dtype, like, *logical_axes)


def lookup(table, ids):
    """``table[ids]`` (rows of an embedding table); over DTensors, a local
    lookup per rank: where the ids are sharded (the batch) the table is
    whole and its gradient a partial sum; where the table is sharded by
    rows (the vocabulary) each rank looks up the ids it holds, zero
    elsewhere, and the output is a partial sum; along its width the table
    is gathered (fsdp)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(table, DTensor):
        return table[ids]
    mesh = table.device_mesh
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim, run_check=False)
    t_pl, out_pl, g_pl = [], [], []
    for ip, tp in zip(ids.placements, table.placements):
        if ip.is_shard():
            t_pl.append(Replicate()), out_pl.append(Shard(ip.dim)), g_pl.append(Partial())
        elif tp.is_shard(0):
            t_pl.append(tp), out_pl.append(Partial()), g_pl.append(tp)
        else:
            t_pl.append(Replicate()), out_pl.append(Replicate()), g_pl.append(Replicate())
    if list(table.placements) != t_pl:
        table = table.redistribute(mesh, t_pl)
    local = table.to_local(grad_placements=g_pl)
    idx = ids.to_local()
    block = 0  # this rank's block of rows, counted over the mesh dims that split them
    for m, p in enumerate(t_pl):
        if p.is_shard(0):
            block = block * mesh.size(m) + mesh.get_coordinate()[m]
    lo = block * local.shape[0]
    hit = (idx >= lo) & (idx < lo + local.shape[0])
    y = torch.nn.functional.embedding(torch.where(hit, idx - lo, 0), local)
    if any(p.is_partial() for p in out_pl):
        y = y * hit[..., None].to(y.dtype)
    return DTensor.from_local(y, mesh, out_pl, run_check=False)


def named_sharding(*logical_axes: Optional[str], shape=None):
    """``(mesh, placements)`` of the logical axes under the active mesh, or
    None with no mesh."""
    c = _ctx()
    if c.mesh is None:
        return None
    return c.mesh, placements(c.mesh, resolve_spec(logical_axes, shape))


# ---------------------------------------------------------------------------
# einsum over DTensors
# ---------------------------------------------------------------------------
def einsum(equation: str, *operands):
    """``torch.einsum``; over DTensors, one local einsum per rank.

    DTensor alone would see the einsum decomposed (permutes, reshapes and
    a batched product), and a reshape that merges two sharded batch axes
    (attention's batch and heads) into one gives strided shards that it
    handles slowly.  Here each mesh dimension keeps the letter that
    shards the most operand bytes along it: an operand holding that letter
    is sharded by it there, one without it is replicated (DTensor
    redistributes where it must, so the collective is counted), the
    output is sharded by the letter, or ``Partial`` where the letter is
    contracted.  The local einsums then run on the shards."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not any(isinstance(o, DTensor) for o in operands):
        return torch.einsum(equation, *operands)
    ins, out = equation.replace(" ", "").split("->")
    subs = ins.split(",")
    mesh = next(o for o in operands if isinstance(o, DTensor)).device_mesh
    rep = [Replicate()] * mesh.ndim
    ops = [o if isinstance(o, DTensor) else DTensor.from_local(o, mesh, rep, run_check=False)
           for o in operands]
    ops = [o.redistribute(mesh, [Replicate() if p.is_partial() else p for p in o.placements])
           if any(p.is_partial() for p in o.placements) else o for o in ops]
    want = [list(o.placements) for o in ops]
    grad = [list(o.placements) for o in ops]  # what each local gradient is a shard of
    out_pl = []
    for m in range(mesh.ndim):
        weight: dict[str, int] = {}
        for o, s in zip(ops, subs):
            p = o.placements[m]
            if p.is_shard():
                weight[s[p.dim]] = weight.get(s[p.dim], 0) + o.numel() * o.element_size()
        letter = max(weight, key=weight.get) if weight else None
        for w, g, s in zip(want, grad, subs):
            held = letter is not None and letter in s
            w[m] = Shard(s.index(letter)) if held else Replicate()
            # a replicated operand meets only this rank's part of the
            # sharded letter: its local gradient is a partial sum
            g[m] = w[m] if held or letter is None else Partial()
        out_pl.append(Replicate() if letter is None else
                      Shard(out.index(letter)) if letter in out else Partial())
    local = [(o if list(o.placements) == w else o.redistribute(mesh, w)).to_local(
        grad_placements=g) for o, w, g in zip(ops, want, grad)]
    y = DTensor.from_local(torch.einsum(equation, *local), mesh, out_pl, run_check=False)
    size = {c: n for o, s in zip(ops, subs) for c, n in zip(s, o.shape)}
    assert y.shape == tuple(size[c] for c in out), (equation, y.shape)  # even shards
    return y



# ---------------------------------------------------------------------------
# Sweep-row sharding (netsim/sweep.py): independent scenario rows sharded
# over a 1-D mesh of the process group's ranks, and scale mode's connection
# axis as the minor axis of a 2-D one.
# ---------------------------------------------------------------------------
SWEEP_AXIS = "rows"
# the second axis of conn-sharded scale mode (SimConfig.conn_sharding): the
# connection axis of the per-connection state is split over it (see
# Simulator.step_rows(conn_axis=...))
CONN_AXIS = "conns"


def _visible_ranks(max_devices: Optional[int]) -> int:
    import torch.distributed as dist

    n = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    return n if max_devices is None else max(1, min(int(max_devices), n))


def _rank_mesh(device_type: str, shape: tuple[int, ...], names: tuple[str, ...]):
    from torch.distributed.device_mesh import DeviceMesh

    n = 1
    for s in shape:
        n *= s
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=names)


def sweep_mesh(max_devices: Optional[int] = None, device_type: str = "cpu"):
    """1-D ``("rows",)`` mesh over the first ``max_devices`` ranks of the
    process group (all of them by default), or None when that is one rank
    or no group is up (callers then run every row in this process).  Every
    rank of the group must call it (making the mesh's groups is
    collective); reference ``sharding.py:138-147``."""
    n = _visible_ranks(max_devices)
    if n <= 1:
        return None
    return _rank_mesh(device_type, (n,), (SWEEP_AXIS,))


def sweep_conn_mesh(conn_devices: int, max_devices: Optional[int] = None,
                    device_type: str = "cpu"):
    """2-D ``(rows, conns)`` mesh for conn-sharded sweeps: scenario rows on
    the major axis, the connection state axis split over the minor
    ``CONN_AXIS``; rank ``r`` sits at ``(r // conn_devices, r %
    conn_devices)``.  Raises when fewer than ``conn_devices`` ranks are up
    (conn sharding cannot silently degrade: results would still be
    bit-identical, but the memory contract would not hold); reference
    ``sharding.py:150-173``."""
    n = _visible_ranks(max_devices)
    conn_devices = int(conn_devices)
    if conn_devices < 1:
        raise ValueError(f"conn_devices must be >= 1, got {conn_devices}")
    if conn_devices > n:
        raise ValueError(
            f"conn_devices={conn_devices} exceeds the {n} visible devices "
            "(on the CPU start more ranks: repro_torch.distrib.ranks.run_ranks)")
    rows = n // conn_devices
    return _rank_mesh(device_type, (rows, conn_devices), (SWEEP_AXIS, CONN_AXIS))


def pad_rows(n_rows: int, mesh) -> int:
    """Row count after padding to a multiple of the sweep mesh's row axis."""
    if mesh is None:
        return n_rows
    n_dev = _axis_size(mesh, SWEEP_AXIS)
    return ((n_rows + n_dev - 1) // n_dev) * n_dev


def mesh_platform(mesh) -> str:
    """Platform ("cpu" / "gpu") of the devices a sweep runs on: the mesh's
    device type when one is given, else the card when one is present."""
    if mesh is not None:
        return "gpu" if mesh.device_type == "cuda" else mesh.device_type
    return "gpu" if torch.cuda.is_available() else "cpu"
