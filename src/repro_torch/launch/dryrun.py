"""Dry-run of the production mesh (counterpart of ``repro.launch.dryrun``):
trace every (architecture x shape x mesh) cell's train, prefill or decode
step on the 256- or 512-device mesh without the devices, and record its
per-device memory, FLOPs, bytes and collective bytes and its roofline
terms.

The reference lowers and compiles each cell with XLA on placeholder host
devices.  Here the mesh is a DTensor ``DeviceMesh`` over a fake process
group of 256 or 512 ranks in this one process (``launch.mesh``), the
parameters, optimizer state, batch and decode state are DTensors of fake
tensors (``FakeTensorMode``: shapes and dtypes, no storage) placed by the
logical-axis rules (``distrib.sharding``), and the step runs once on them
as the port's eager code, under ``op_cost.count`` (per-device FLOPs,
bytes, collectives) and ``op_cost.LiveBytes`` (per-device memory in use).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mistral-nemo-12b \\
        --shape train_4k [--multi-pod] [--rules baseline]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Records go to results/dryrun_torch/<arch>__<shape>__<mesh>.json, with the
reference's keys.  ``DRYRUN_DUMP_HLO=1`` also writes the per-(function, op)
cost rows (``OpCost.breakdown``) to results/op_cost/; there is no HLO.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch

from repro_torch import rng
from repro_torch.configs import SHAPES, all_configs, applicable_shapes, get_config
from repro_torch.distrib import sharding as shd
from repro_torch.launch import op_cost
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import PRODUCTION, make_mesh, release
from repro_torch.models import build_model
from repro_torch.tree import tree_flatten_with_path, tree_map_with_path

RESULTS_DIR = "results/dryrun_torch"

# Per-arch defaults used by --all: (rules, train microbatches), the
# reference's.
ARCH_DEFAULTS = {
    "mistral-nemo-12b": ("fsdp", 8),
    "gemma-7b": ("fsdp", 8),
    "qwen1.5-4b": ("fsdp", 4),
    "gemma3-4b": ("fsdp", 4),
    "qwen3-moe-235b-a22b": ("fsdp", 16),
    "phi3.5-moe-42b-a6.6b": ("fsdp", 8),
    "musicgen-large": ("fsdp", 4),
    "rwkv6-1.6b": ("fsdp", 4),
    "zamba2-7b": ("fsdp", 8),
    "llava-next-mistral-7b": ("fsdp", 8),
}

# Named rule-table variants (the reference's).
RULE_SETS: dict[str, dict] = {
    "baseline": {},
    # fsdp: secondary sharding of params/optimizer over the data axis
    # (ZeRO-3 style): DTensor all-gathers weights at use
    "fsdp": {
        "embed": ("data",),
        "head_dim": ("data",),
        "moe_fsdp": ("data",),
    },
    # seq-activations: also shard long activations along sequence between
    # attention blocks
    "seq_act": {"seq": ("model",)},
}


def _flat_axes(axes_tree, prefix: str = "") -> dict:
    """``{path: logical axes}`` of an axes tree (paths as ``repro_torch.tree``
    names them)."""
    if isinstance(axes_tree, tuple):
        return {prefix or "_": axes_tree}
    out = {}
    for k, v in axes_tree.items():
        out.update(_flat_axes(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def axes_to_shardings(mesh, axes_tree, like_tree=None, rules=None) -> dict:
    """Resolve a logical-axis tree to DTensor placements, ``{leaf path:
    placements}`` (paths as ``repro_torch.tree`` names them); with
    ``like_tree`` (tensors of matching structure) mesh axes that do not
    divide a dimension are dropped."""
    flat_ax = _flat_axes(axes_tree)
    with shd.mesh_rules(mesh, rules):
        if like_tree is None:
            return {k: shd.placements(mesh, shd.resolve_spec(ax)) for k, ax in flat_ax.items()}
        flat_like = tree_flatten_with_path(like_tree)
        assert flat_ax.keys() == flat_like.keys(), "axes/like tree mismatch"
        return {k: shd.placements(mesh, shd.resolve_spec(flat_ax[k], t.shape))
                for k, t in flat_like.items()}


def _fake_dtensors(mesh, like_tree, places: dict, dtype=None):
    """Fake DTensors shaped like ``like_tree``'s leaves (meta tensors), each
    one rank's local shard of its global shape under ``places[path]``;
    plain fake tensors with no mesh.  ``dtype`` replaces floating dtypes."""
    from torch.distributed.tensor import DTensor

    def make(path, t):
        dt = dtype if (dtype is not None and t.is_floating_point()) else t.dtype
        if mesh is None:
            return torch.empty(t.shape, dtype=dt)
        pl = places[path or "_"]
        local = torch.empty(shd.local_shape(mesh, t.shape, pl), dtype=dt)
        return DTensor.from_local(local, mesh, pl, run_check=False, shape=t.shape,
                                  stride=shd.contiguous_stride(t.shape))

    return tree_map_with_path(make, like_tree)


def _batch_shards(mesh, rules) -> int:
    """How many ways the "batch" axis shards on ``mesh``."""
    n = 1
    with shd.mesh_rules(mesh, rules):
        for ax in shd.resolve_spec(("batch",)):
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                if a is not None:
                    n *= shd._axis_size(mesh, a)
    return n


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@contextlib.contextmanager
def _traced(mesh, rules):
    """Fake tensors, the mesh and rules active, and plain tensors made
    inside the step (positions, masks, constants) taken as replicated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    with contextlib.ExitStack() as st:
        fake = st.enter_context(FakeTensorMode(allow_non_fake_inputs=False))
        st.enter_context(shd.mesh_rules(mesh, rules))
        if mesh is not None:
            st.enter_context(implicit_replication())
        yield fake


def trace_step(model, shape, mesh, rules=None, microbatches: int = 1, remat_policy=None,
               rows: bool = False, remat: bool = True):
    """Run ``shape``'s step of ``model`` once on fake tensors placed on
    ``mesh`` (None: one device, plain fake tensors).  Returns
    ``(OpCost, memory bytes dict, microbatches used)``: the per-device
    count and ``argument`` / ``output`` / ``alias`` / ``peak`` bytes."""
    from repro_torch.models.common import cast_tree
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.optimizer import opt_state_axes

    p_dtype = torch.float32 if shape.kind == "train" else torch.bfloat16
    p_like = model.init_params(rng.PRNGKey(0, device="meta"), p_dtype)
    p_axes = model.param_axes()
    shards = (lambda axes, like: axes_to_shardings(mesh, axes, like, rules)) if mesh else (
        lambda axes, like: None)
    live = op_cost.LiveBytes()
    with _traced(mesh, rules):
        params = _fake_dtensors(mesh, p_like, shards(p_axes, p_like))
        if shape.kind == "train":
            opt_like = {"m": p_like, "v": p_like, "step": _meta((), torch.int32)}
            opt = _fake_dtensors(mesh, opt_like, shards(opt_state_axes(p_axes), opt_like),
                                 torch.float32)
            blike = model.input_specs(shape)
            batch = _fake_dtensors(mesh, blike, shards(model.batch_axes(shape), blike))
            mb_cap = max(1, shape.global_batch // (_batch_shards(mesh, rules) if mesh else 1))
            microbatches = min(microbatches, mb_cap)
            step = make_train_step(model, TrainConfig(microbatches=microbatches, remat=remat,
                                                      remat_policy=remat_policy))
            args, aliased = (params, opt, batch), (params, opt)
            run = lambda: step(*args)
        elif shape.kind == "prefill":
            blike = {k: v for k, v in model.input_specs(shape).items() if k != "labels"}
            batch = _fake_dtensors(mesh, blike, shards(
                {k: v for k, v in model.batch_axes(shape).items() if k != "labels"}, blike))
            args, aliased = (params, batch), ()
            run = lambda: model.prefill_fn(cast_tree(params, torch.bfloat16), batch,
                                           shape.seq_len)
        else:
            s_like = model.decode_state_spec(shape)
            state = _fake_dtensors(mesh, s_like, shards(model.decode_state_axes(), s_like))
            tlike = {"t": _meta((shape.global_batch, 1), torch.int32)}
            tokens = _fake_dtensors(mesh, tlike, shards({"t": ("batch", None)}, tlike))["t"]
            clen = _fake_dtensors(mesh, {"c": _meta((), torch.int32)},
                                  shards({"c": ()}, {"c": _meta((), torch.int32)}))["c"]
            args, aliased = (params, state, tokens, clen), (state,)
            run = lambda: model.decode_fn(cast_tree(params, torch.bfloat16), state, tokens,
                                          clen)
        for t in tree_flatten_with_path(list(args)).values():
            live.add(t)
        argument = live.live
        with op_cost.count(rows) as cost, live:
            out = run()
        mem = {"argument": argument, "output": op_cost.tree_bytes(list(out)),
               "alias": op_cost.tree_bytes(list(aliased)), "peak": live.peak}
        del out
    return cost, mem, microbatches


def dryrun_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    rules_name: str = "baseline",
    microbatches: int = 1,
    remat_policy=None,
    save: bool = True,
    verbose: bool = True,
    cfg=None,
    mesh_shape=None,
    shape=None,
):
    """One cell's record.  ``cfg`` replaces the preset's config (a reduced
    one in tests), ``shape`` the named shape (a ``ShapeConfig``) and
    ``mesh_shape`` the production mesh (``(shape, axes)``, e.g. ``((4, 2),
    ("data", "model"))``)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    model = build_model(cfg)
    dims, axes = mesh_shape or PRODUCTION[multi_pod]
    mesh = make_mesh(dims, axes)
    n_dev = mesh.size()
    rules = RULE_SETS[rules_name]
    t0 = time.time()
    try:
        cost, mem, microbatches = trace_step(
            model, shape, mesh, rules, microbatches if shape.kind == "train" else 1,
            remat_policy, rows=bool(os.environ.get("DRYRUN_DUMP_HLO")))
    finally:
        release()
    t_trace = time.time() - t0
    roof = rl.analyze(cost, n_dev, rl.model_flops_for(cfg, shape))
    mesh_name = ("pod2x16x16" if multi_pod else "pod16x16") if mesh_shape is None else \
        "x".join(map(str, dims))
    if os.environ.get("DRYRUN_DUMP_HLO"):
        os.makedirs("results/op_cost", exist_ok=True)
        with open(f"results/op_cost/{arch}__{shape_name}__{mesh_name}.tsv", "w") as f:
            f.write("path/op\tcount\tflops\tbytes\n")
            for row in cost.breakdown():
                f.write("\t".join(map(str, row)) + "\n")
    gb = 1e9
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "rules": rules_name,
        "microbatches": microbatches,
        "n_devices": n_dev,
        "lower_s": round(t_trace, 1),  # the trace is the lowering
        "compile_s": 0.0,  # eager: nothing is compiled
        "memory": {
            "argument_gb": mem["argument"] / gb,
            "output_gb": mem["output"] / gb,
            "temp_gb": (mem["peak"] - mem["argument"]) / gb,
            "alias_gb": mem["alias"] / gb,
            "peak_live_gb": mem["peak"] / gb,
        },
        "flops_per_device": roof.flops,
        "hbm_bytes_per_device": roof.hbm_bytes,
        "collective_bytes_per_device": roof.coll_bytes,
        "collective_breakdown": {k: v for k, v in roof.coll_breakdown.items() if v},
        "model_flops_global": roof.model_flops,
        **roof.row(),
    }
    if verbose:
        print(
            f"[{arch} x {shape_name} x {mesh_name} x {rules_name}] "
            f"trace={t_trace:.0f}s peak={rec['memory']['peak_live_gb']:.2f}GB "
            f"t_comp={roof.t_compute*1e3:.1f}ms t_mem={roof.t_memory*1e3:.1f}ms "
            f"t_coll={roof.t_collective*1e3:.1f}ms bottleneck={roof.bottleneck} "
            f"roofline_frac={roof.roofline_fraction:.3f}"
        )
    if save:
        os.makedirs(RESULTS_DIR, exist_ok=True)
        with open(f"{RESULTS_DIR}/{arch}__{shape_name}__{mesh_name}.json", "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--rules", default="baseline", choices=sorted(RULE_SETS))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat-policy", default=None)
    args = ap.parse_args(argv)

    if args.all:
        failures = []
        for arch, cfg in sorted(all_configs().items()):
            rules_name, mb = ARCH_DEFAULTS.get(arch, ("baseline", 1))
            for shape_name in applicable_shapes(cfg):
                try:
                    dryrun_cell(
                        arch, shape_name, multi_pod=args.multi_pod,
                        rules_name=rules_name,
                        microbatches=mb if SHAPES[shape_name].kind == "train" else 1,
                    )
                except Exception as e:  # noqa: BLE001
                    traceback.print_exc()
                    failures.append((arch, shape_name, str(e)[:200]))
        print(f"\n{'=' * 60}\nfailures: {len(failures)}")
        for f in failures:
            print("  FAIL:", f)
        raise SystemExit(1 if failures else 0)

    dryrun_cell(
        args.arch, args.shape, multi_pod=args.multi_pod,
        rules_name=args.rules, microbatches=args.microbatches,
        remat_policy=args.remat_policy,
    )


if __name__ == "__main__":
    main()
