"""The port's DTensor path holds real values: four gloo ranks on this host
form a (2, 2) ``("data", "model")`` mesh and take one train step of a
reduced transformer with grouped-query attention, RWKV6 and Zamba2 under
the ``baseline`` and ``fsdp`` rules.  The sharded loss and every gradient
(``full_tensor()``), and the loss, parameters and AdamW moments after a
step of two microbatches, equal those of the same calls with no mesh.
This covers ``sharding.einsum``'s placements and its ``Partial``
gradients, the vocabulary-parallel ``lookup``, the one-hot cross-entropy,
``_microbatch``'s every-n-th-row split and AdamW on local shards (the
dry-run traces the same code on fake tensors, whose collectives move
nothing).

The ranks compute in float64: the models' float32 casts and buffers are
made float64 in these processes.  In float32 the recurrent stacks turn a
reordered sum into differences of up to 5e-4 of a leaf's largest
gradient, enough to hide a misplaced contribution to a small element; in
float64 the mesh and the one device agree to 1e-11 of it.

Each rank is a process running this file as a script; the test starts
four and holds their exit codes."""
import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
# (arch, n_kv_heads or None for the reduced preset's, sequence length):
# the transformer with 4 query heads over 2 KV heads; RWKV's chunk is 16
# tokens and Zamba's SSD chunk 32
CASES = [("mistral-nemo-12b", 2, 16), ("rwkv6-1.6b", None, 16), ("zamba2-7b", None, 32)]
RULES = ("baseline", "fsdp")
BATCH, MICROBATCHES = 4, 2
# of a leaf's largest element
ATOL_OF_MAX = 1e-9


def _float64_everywhere() -> None:
    """``Tensor.float()`` and float32 ``torch.zeros`` / ``torch.full``
    give float64 (in this process)."""
    torch.Tensor.float = lambda self, *a, **k: self.double()

    def widen(fn):
        def made(*args, dtype=None, **kw):
            return fn(*args, dtype=torch.float64 if dtype == torch.float32 else dtype, **kw)
        return made

    torch.zeros, torch.full = widen(torch.zeros), widen(torch.full)


def _copy(tree):
    from repro_torch.tree import tree_map_with_path

    return tree_map_with_path(lambda _, t: t.clone(), tree)


def _close(got, want, what):
    from torch.distributed.tensor import DTensor

    if isinstance(got, DTensor):
        got = got.full_tensor()
    assert got.shape == want.shape and got.dtype == want.dtype, what
    atol = ATOL_OF_MAX * float(want.abs().max()) if want.numel() else 0.0
    torch.testing.assert_close(got, want, rtol=0.0, atol=atol, msg=lambda m: f"{what}: {m}")


def _rank_main(rank: int, port: int) -> None:
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import rng
    from repro_torch.configs import ShapeConfig, all_configs, reduced
    from repro_torch.distrib import sharding as shd
    from repro_torch.launch.dryrun import RULE_SETS, axes_to_shardings
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.optimizer import init_opt_state, opt_state_axes
    from repro_torch.train.steps import make_grad_fn
    from repro_torch.tree import tree_flatten_with_path, tree_map_with_path

    torch.set_num_threads(1)
    _float64_everywhere()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=WORLD)
    try:
        mesh = make_host_mesh(model=2, device="cpu")
        assert tuple(mesh.shape) == (2, 2)
        g_cfg = TrainConfig(compute_dtype=torch.float64)
        s_cfg = TrainConfig(compute_dtype=torch.float64, microbatches=MICROBATCHES)
        for arch, kv, seq in CASES:
            cfg = reduced(all_configs()[arch])
            if kv is not None:
                cfg = dataclasses.replace(cfg, n_kv_heads=kv)
            model = build_model(cfg)
            shape = ShapeConfig("t", seq, BATCH, "train")
            rs = np.random.RandomState(0)
            batch = {k: torch.from_numpy(rs.randint(0, cfg.vocab, tuple(v.shape)).astype(np.int32))
                     for k, v in model.input_specs(shape).items()}
            params = model.init_params(rng.PRNGKey(0, device="cpu"), torch.float64)
            opt = init_opt_state(params)
            loss, _, grads = make_grad_fn(model, g_cfg)(params, batch)
            p1, o1, m1 = make_train_step(model, s_cfg)(_copy(params), _copy(opt), batch)
            for rules_name in RULES:
                rules = RULE_SETS[rules_name]

                def place(tree, axes):
                    pl = axes_to_shardings(mesh, axes, tree, rules)
                    return tree_map_with_path(
                        lambda path, t: distribute_tensor(t, mesh, pl[path or "_"]), tree)

                what = f"{arch} {rules_name}"
                d_batch = place(batch, model.batch_axes(shape))
                with shd.mesh_rules(mesh, rules), implicit_replication():
                    d_loss, _, d_grads = make_grad_fn(model, g_cfg)(
                        place(params, model.param_axes()), d_batch)
                    _close(d_loss, loss, f"{what} loss")
                    for k, g in grads.items():
                        _close(d_grads[k], g, f"{what} grad {k}")
                    d_opt = place(_copy(opt), opt_state_axes(model.param_axes()))
                    p2, o2, m2 = make_train_step(model, s_cfg)(
                        place(_copy(params), model.param_axes()), d_opt, d_batch)
                _close(m2["loss"], m1["loss"], f"{what} microbatched loss")
                _close(m2["grad_norm"], m1["grad_norm"], f"{what} grad_norm")
                for part, got, want in (("param", p2, p1), ("opt", o2, o1)):
                    got = tree_flatten_with_path(got)
                    for k, t in tree_flatten_with_path(want).items():
                        _close(got[k], t, f"{what} {part} {k} after one step")
    finally:
        dist.destroy_process_group()


def test_sharded_train_step_equals_the_one_device_step():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src"), *filter(None, [os.environ.get("PYTHONPATH")])]),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(port)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-4000:]}"


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]))
