"""``repro_torch.distrib.sharding`` against ``repro.distrib.sharding``:
``resolve_spec`` entry for entry on the reference test's stand-in mesh and
on every preset's full-size parameter, optimizer-state, batch and decode
state leaves under every rule set of the dry-run, on 16 x 16 and 2 x 16 x
16 meshes; the spec-to-placements helper; ``shard()`` is the argument
itself and dispatches nothing with no mesh, and redistributes a DTensor
with one."""
import ast
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.distrib import sharding as j_shd
from repro_torch import rng
from repro_torch.configs import SHAPES, all_configs, applicable_shapes
from repro_torch.distrib import sharding as shd
from repro_torch.launch import dryrun, op_cost
from repro_torch.launch.mesh import make_host_mesh, make_mesh, make_production_mesh, release
from repro_torch.models import build_model
from repro_torch.train.optimizer import opt_state_axes
from repro_torch.tree import tree_flatten_with_path

ROOT = Path(__file__).resolve().parents[1]


class FakeMesh:
    """The reference test's stand-in: axis names and sizes, no devices."""

    def __init__(self, sizes: dict):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)


MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _reference_literal(name: str):
    """A module-level literal of the reference's dry-run launcher, read
    from its source (importing it would set XLA_FLAGS for this process)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    for node in tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            target = node.targets[0] if isinstance(node, ast.Assign) else node.target
            if getattr(target, "id", None) == name:
                return ast.literal_eval(node.value)
    raise KeyError(name)


def _both(mesh, rules, axes, shape):
    with shd.mesh_rules(mesh, rules), j_shd.mesh_rules(mesh, rules):
        return shd.resolve_spec(axes, shape), tuple(j_shd.resolve_spec(axes, shape))


def test_rules_and_defaults_are_the_references():
    assert shd.DEFAULT_RULES == j_shd.DEFAULT_RULES
    assert dryrun.RULE_SETS == _reference_literal("RULE_SETS")
    assert dryrun.ARCH_DEFAULTS == _reference_literal("ARCH_DEFAULTS")


def test_reference_fake_mesh_cases():
    mesh = FakeMesh({"data": 4, "model": 2})
    cases = [(("batch", None), (1, 8), (None, None)),
             ((None, "kv_heads"), (4, 2), (None, "model")),
             ((None, "kv_heads"), (4, 3), (None, None)),
             (("kv_seq", "kv_heads"), (8, 2), ("model", None)),
             (("batch", "heads", None), (8, 4, 3), ("data", "model", None)),
             (("batch", None), None, ("data", None))]
    for axes, shape, want in cases:
        got, ref = _both(mesh, None, axes, shape)
        assert got == ref == want, (axes, shape, got, ref)


def _leaves(model):
    """(logical axes, shape) of every leaf the dry-run places: parameters,
    optimizer state, and for each of the preset's shapes the batch and the
    decode state, at full size."""
    p = model.init_params(rng.PRNGKey(0, device="meta"))
    p_axes = model.param_axes()
    trees = [(p, p_axes), ({"m": p, "v": p}, {k: v for k, v in opt_state_axes(
        p_axes).items() if k != "step"})]
    for s in applicable_shapes(model.cfg):
        trees += [(model.input_specs(SHAPES[s]), model.batch_axes(SHAPES[s])),
                  (model.decode_state_spec(SHAPES[s]), model.decode_state_axes())]
    out = set()
    for tree, axes in trees:
        flat = tree_flatten_with_path(tree)
        flat_axes = dryrun._flat_axes(axes)
        assert flat.keys() == flat_axes.keys()
        out |= {(flat_axes[k], tuple(t.shape)) for k, t in flat.items()}
    return out


@pytest.mark.parametrize("arch", sorted(all_configs()))
def test_resolve_spec_matches_reference_on_every_leaf(arch):
    leaves = _leaves(build_model(all_configs()[arch]))
    for mesh_name, sizes in MESHES.items():
        mesh = FakeMesh(sizes)
        for rules_name, rules in dryrun.RULE_SETS.items():
            for axes, shape in leaves:
                got, ref = _both(mesh, rules, axes, shape)
                assert got == ref, (arch, mesh_name, rules_name, axes, shape, got, ref)
                got, ref = _both(mesh, rules, axes, None)
                assert got == ref, (arch, mesh_name, rules_name, axes, got, ref)


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    try:
        assert shd.placements(mesh, (("pod", "data"), None, "model")) == (
            Shard(0), Shard(0), Shard(2))
        assert shd.placements(mesh, (None, "data")) == (Replicate(), Shard(1), Replicate())
        assert shd.placements(mesh, ()) == (Replicate(),) * 3
        with shd.mesh_rules(mesh):
            got = shd.named_sharding("batch", "kv_seq", shape=(4, 6))
            assert got == (mesh, (Shard(0), Shard(0), Shard(1)))
            assert shd.local_shape(mesh, (4, 6), got[1]) == (1, 3)
        assert shd.named_sharding("batch") is None
    finally:
        release()


class _AllOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def test_shard_is_a_no_op_with_no_mesh():
    x = torch.randn(4, 8, 16)
    with _AllOps() as seen, op_cost.count() as c:
        y = shd.shard(x, "batch", "seq", None)
        z = shd.zeros((4, 3), torch.float32, x, "batch", None)
    assert y is x and seen.ops == [torch.ops.aten.zeros.default] and c.n_ops == 1
    assert torch.equal(z, torch.zeros(4, 3))


def test_shard_redistributes_under_a_mesh():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = make_mesh((4, 2), ("data", "model"))
    try:
        with FakeTensorMode(), shd.mesh_rules(mesh):
            x = DTensor.from_local(torch.empty(8, 6, 4), mesh, [Replicate(), Replicate()],
                                   run_check=False, shape=(8, 6, 4), stride=(24, 4, 1))
            y = shd.shard(x, "batch", None, "heads")
            assert tuple(y.placements) == (Shard(0), Shard(2))
            assert tuple(y.to_local().shape) == (2, 6, 2)
            assert shd.shard(y, "batch", None, "heads") is y
            with op_cost.count() as c:
                shd.shard(y, None, None, None)
            assert set(c.coll_breakdown) == {"all-gather"}
            with pytest.raises(TypeError):
                shd.shard(torch.empty(8, 6, 4), "batch", None, None)
    finally:
        release()


def test_meshes():
    """The production meshes over fake groups of 256 and 512 ranks, torn
    down by ``release``; the host mesh over this process's one rank, on
    the card unless the CPU is asked for."""
    import torch.distributed as dist

    for multi_pod, shape, names in ((False, (16, 16), ("data", "model")),
                                    (True, (2, 16, 16), ("pod", "data", "model"))):
        try:
            mesh = make_production_mesh(multi_pod=multi_pod)
            assert tuple(mesh.shape) == shape and mesh.mesh_dim_names == names
            assert dist.get_world_size() == mesh.size() and dist.get_backend() == "fake"
        finally:
            release()
        assert not dist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_host_mesh()
        assert not dist.is_initialized()
    try:
        mesh = make_host_mesh(device="cpu")
        assert tuple(mesh.shape) == (1, 1) and mesh.mesh_dim_names == ("data", "model")
    finally:
        dist.destroy_process_group()
