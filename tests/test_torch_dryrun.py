"""``repro_torch.launch.dryrun`` (the production-mesh dry-run over a DTensor
mesh of fake ranks) and ``launch.report`` / ``launch.roofline`` against the
reference: the dry-run's specs (meta tensors where the reference has
``ShapeDtypeStruct``), the exact parameter counts and model FLOPs, the
report's tables on the same records; the dry-run itself at reduced size on
fake meshes: pure data parallelism divides the one-device count by the
data axis exactly and all-reduces each gradient once (2 x its bytes), the
model axis divides every transformer matmul and leaves whole what the
rules leave whole (the closed forms), and on (4, 2) and (2, 2, 2) meshes a record has every key the reference's has,
all finite.  (The reference's own dry-run does not run under this JAX:
``shard()`` raises on its Explicit mesh axes.)"""
import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES, all_configs as j_all
from repro.launch import report as j_report, roofline as j_roofline
from repro.models import build_model as j_build_model
from repro_torch.configs import SHAPES, ShapeConfig, all_configs, applicable_shapes, reduced
from repro_torch.launch import dryrun, report, roofline
from repro_torch.launch.mesh import make_mesh, release
from repro_torch.models import build_model
from repro_torch.tree import tree_flatten_with_path

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

ARCHS = sorted(all_configs())
# the keys of a record of the reference's dryrun_cell (src/repro/launch/dryrun.py)
REF_KEYS = {"arch", "shape", "mesh", "rules", "microbatches", "n_devices", "lower_s",
            "compile_s", "memory", "flops_per_device", "hbm_bytes_per_device",
            "collective_bytes_per_device", "collective_breakdown", "model_flops_global",
            "t_compute_s", "t_memory_s", "t_memory_min_s", "t_collective_s", "bottleneck",
            "useful_flops_ratio", "roofline_fraction"}
REF_MEMORY_KEYS = {"argument_gb", "output_gb", "temp_gb", "alias_gb", "peak_live_gb"}
DTYPES = {torch.bfloat16: jax.numpy.bfloat16, torch.float32: jax.numpy.float32,
          torch.int32: jax.numpy.int32}


def _same_specs(got: dict, want: dict, what):
    flat = tree_flatten_with_path(got)
    ref = {"/".join(str(getattr(p, "key", p)) for p in path): leaf
           for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert flat.keys() == ref.keys(), what
    for k, t in flat.items():
        assert t.is_meta and tuple(t.shape) == ref[k].shape, (what, k)
        assert DTYPES[t.dtype] == ref[k].dtype, (what, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_counts_and_model_flops_match_reference(arch):
    cfg, jcfg = all_configs()[arch], j_all()[arch]
    model, jmodel = build_model(cfg), j_build_model(jcfg)
    assert roofline.exact_param_counts(cfg) == j_roofline.exact_param_counts(jcfg)
    for s in applicable_shapes(cfg):
        _same_specs(model.input_specs(SHAPES[s]), jmodel.input_specs(J_SHAPES[s]), (arch, s))
        _same_specs(model.decode_state_spec(SHAPES[s]), jmodel.decode_state_spec(J_SHAPES[s]),
                    (arch, s))
        assert model.batch_axes(SHAPES[s]) == jmodel.batch_axes(J_SHAPES[s])
        assert roofline.model_flops_for(cfg, SHAPES[s]) == j_roofline.model_flops_for(
            jcfg, J_SHAPES[s]), (arch, s)
    assert model.decode_state_axes() == jmodel.decode_state_axes()


def test_init_decode_state_is_zeros_of_the_spec():
    model = build_model(reduced(all_configs()["zamba2-7b"]))
    shape = ShapeConfig("t", 64, 2, "decode")
    state = model.init_decode_state(shape, device="cpu")
    spec = model.decode_state_spec(shape)
    for k, t in state.items():
        assert t.shape == spec[k].shape and t.dtype == spec[k].dtype and not t.any()


def _train(mesh_dims, axes=("data", "model"), **kw):
    model = build_model(reduced(all_configs()["mistral-nemo-12b"]))
    mesh = make_mesh(mesh_dims, axes)
    try:
        return dryrun.trace_step(model, ShapeConfig("t", 32, 8, "train"), mesh, rows=True, **kw)
    finally:
        release()


def test_pure_data_parallel_divides_the_count():
    """On an (8, 1) mesh each device runs an eighth of the (1, 1) mesh's
    step, and its one collective is the gradients' all-reduce, 2 x their
    bytes."""
    one, mem1, _ = _train((1, 1))
    dp, mem8, _ = _train((8, 1))
    assert dp.flops * 8 == one.flops
    assert one.coll_bytes == 0
    params = (mem1["alias"] - 4) // 3  # params, m and v (float32), and the step
    assert dp.coll_breakdown == {"all-reduce": 2 * params}


def _flops_by_row(cfg, n_model):
    """Per-(path, op) FLOPs of a (4 x 64) train step on a (1, n_model)
    mesh (no remat), and the total."""
    mesh = make_mesh((1, n_model), ("data", "model"))
    try:
        cost, _, _ = dryrun.trace_step(build_model(cfg), ShapeConfig("t", 64, 4, "train"), mesh,
                                       rows=True, remat=False)
    finally:
        release()
    return {path: flops for path, _, flops, _ in cost.breakdown() if flops}, cost.flops


def test_model_axis_splits_every_transformer_matmul():
    """On a (1, 4) model-only mesh the transformer's matmuls are split by
    heads, KV heads, mlp or vocab: every row of the count is a quarter
    of the (1, 1) mesh's."""
    cfg = reduced(all_configs()["mistral-nemo-12b"])
    assert cfg.n_kv_heads == 4
    (one, total1), (four, total4) = _flops_by_row(cfg, 1), _flops_by_row(cfg, 4)
    assert four.keys() == one.keys() and total4 * 4 == total1
    assert all(four[k] * 4 == v for k, v in one.items())


T_TOKENS = 4 * 64


@pytest.mark.parametrize("arch,kv,n_model,row,closed_form", [
    # 2 KV heads do not split 4 ways: the K and V projections stay whole on
    # each device, the Q projection is split by heads
    ("mistral-nemo-12b", 2, 4, "attention._project_qkv/bmm",
     lambda c: c.n_layers * 2 * T_TOKENS * c.d_model * c.head_dim * (c.n_heads // 4
                                                                     + 2 * c.n_kv_heads)),
    # RWKV's channel mix: the key and value matmuls split by mlp, the
    # receptance (embed x embed) whole
    ("rwkv6-1.6b", None, 2, "ssm.rwkv_cmix/bmm",
     lambda c: c.n_layers * 2 * T_TOKENS * (2 * c.d_model * c.d_ff // 2 + c.d_model ** 2)),
])
def test_model_axis_flops_equal_the_closed_form(arch, kv, n_model, row, closed_form):
    cfg = reduced(all_configs()[arch])
    if kv is not None:
        cfg = dataclasses.replace(cfg, n_kv_heads=kv)
    rows, _ = _flops_by_row(cfg, n_model)
    assert rows[row] == closed_form(cfg)


@pytest.mark.parametrize("dims,axes,arch,kind,rules,mb", [
    ((4, 2), ("data", "model"), "mistral-nemo-12b", "train", "fsdp", 2),
    ((4, 2), ("data", "model"), "rwkv6-1.6b", "prefill", "baseline", 1),
    ((4, 2), ("data", "model"), "zamba2-7b", "decode", "seq_act", 1),
    ((2, 2, 2), ("pod", "data", "model"), "gemma3-4b", "train", "baseline", 1),
    ((2, 2, 2), ("pod", "data", "model"), "qwen1.5-4b", "decode", "fsdp", 1),
])
def test_record_has_every_reference_key(dims, axes, arch, kind, rules, mb, tmp_path,
                                        monkeypatch):
    monkeypatch.chdir(tmp_path)
    shape = ShapeConfig(f"{kind}_small", 64, 8, kind)
    rec = dryrun.dryrun_cell(arch, shape.name, rules_name=rules, microbatches=mb,
                             cfg=reduced(all_configs()[arch]), mesh_shape=(dims, axes),
                             shape=shape, verbose=False)
    assert set(rec) == REF_KEYS and set(rec["memory"]) == REF_MEMORY_KEYS
    assert set(rec) - {"arch", "shape", "mesh", "rules", "memory", "collective_breakdown",
                       "bottleneck"} == {k for k, v in rec.items() if isinstance(v, (int, float))}
    nums = [v for v in rec.values() if isinstance(v, (int, float))]
    nums += list(rec["memory"].values()) + list(rec["collective_breakdown"].values())
    assert all(math.isfinite(v) for v in nums)
    assert rec["n_devices"] == math.prod(dims) and rec["flops_per_device"] > 0
    assert rec["memory"]["peak_live_gb"] >= rec["memory"]["argument_gb"] > 0
    assert rec["collective_bytes_per_device"] > 0 and rec["microbatches"] == mb
    saved = tmp_path / dryrun.RESULTS_DIR / f"{arch}__{shape.name}__{'x'.join(map(str, dims))}.json"
    assert json.loads(saved.read_text()) == rec


def test_report_table_equals_reference(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rs = np.random.RandomState(0)
    for d in (report.RESULTS_DIR, "results/dryrun"):
        (tmp_path / d).mkdir(parents=True)
    for i, (arch, shape) in enumerate([("gemma3-4b", "train_4k"), ("rwkv6-1.6b", "decode_32k"),
                                       ("zamba2-7b", "long_500k")]):
        t = rs.uniform(1e-4, 3.0, 3)
        rec = {"arch": arch, "shape": shape, "rules": "fsdp", "microbatches": 4,
               "compile_s": float(rs.uniform(0, 90)), "n_devices": 256,
               "memory": {"peak_live_gb": float(rs.uniform(1, 90))},
               "t_compute_s": t[0], "t_memory_s": t[1], "t_memory_min_s": t[1] / 3,
               "t_collective_s": t[2],
               "bottleneck": ("compute", "memory", "collective")[int(np.argmax(t))],
               "useful_flops_ratio": float(rs.uniform()), "roofline_fraction": float(rs.uniform())}
        for d in (report.RESULTS_DIR, "results/dryrun"):
            (tmp_path / d / f"{arch}__{shape}__pod16x16.json").write_text(json.dumps(rec))
    for mesh in ("pod16x16", "pod2x16x16"):
        assert report.table(mesh) == j_report.table(mesh)
    notes, j_notes = report.bottleneck_notes("pod16x16"), j_report.bottleneck_notes("pod16x16")
    assert notes.replace("tensor-core-aligned", "MXU-aligned") == j_notes
