"""The port's training path on its own (no JAX) on the CPU: activation
checkpointing (remat off, on and ``remat_policy="dots"``) gives bit-equal
gradients, and ``"dots"`` saves the projections' products and recomputes
the attention's and the experts' (a set apart from both "everything" and
"nothing"); the layers unbound once per forward (``unstack_layers``) leave
the serve paths' outputs unchanged, run a config's first layers of a
deeper stack and give each stacked leaf's gradient in one write; the reference test's loss decrease on the Markov stream;
one train step of every ``--arch`` preset at ``reduced()``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import rng
from repro_torch.configs import all_configs, get_config, reduced
from repro_torch.data import SyntheticLM
from repro_torch.models import build_model, common, recurrent, transformer
from repro_torch.train import (AdamWConfig, TrainConfig, init_train_state, make_serve_steps,
                               make_train_step)
from repro_torch.train.steps import make_grad_fn
from repro_torch.tree import tree_flatten_with_path, tree_map_with_path
from torch.utils._python_dispatch import TorchDispatchMode

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

ARCHS = sorted(all_configs())
FAMILIES = ["qwen1.5-4b", "phi3.5-moe-42b-a6.6b", "rwkv6-1.6b", "zamba2-7b"]
REMAT = [("off", False, None), ("on", True, None), ("dots", True, "dots")]


def batch_for(cfg, seed: int = 3, b: int = 2, s: int = 64) -> dict:
    rs = np.random.RandomState(seed)
    out = {"labels": torch.from_numpy(rs.randint(0, cfg.vocab, (b, s)).astype(np.int32))}
    if cfg.frontend != "none":
        out["embeds"] = torch.from_numpy(rs.standard_normal((b, s, cfg.d_model)).astype(
            np.float32))
    else:
        out["tokens"] = torch.from_numpy(rs.randint(0, cfg.vocab, (b, s)).astype(np.int32))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_modes_give_equal_gradients(arch, dtype):
    cfg = reduced(get_config(arch))
    model = build_model(cfg)
    params = model.init_params(rng.PRNGKey(0, "cpu"))
    batch = batch_for(cfg)
    out = {}
    for name, remat, policy in REMAT:
        tcfg = TrainConfig(compute_dtype=dtype, remat=remat, remat_policy=policy)
        out[name] = make_grad_fn(model, tcfg)(params, batch)
    loss0, _, g0 = out["off"]
    for name in ("on", "dots"):
        loss, _, g = out[name]
        assert torch.equal(loss, loss0), name
        assert all(torch.equal(g[k], g0[k]) for k in g0), name


def test_dots_policy_saves_projections_and_recomputes_the_rest(monkeypatch):
    """Per MoE layer the policy saves the five projections (q, k, v, o and
    the router, as batch-1 ``bmm``s) and recomputes the attention's score
    and value products and the experts' three products (``bmm``s with a
    batch), and everything that is not a matrix product."""
    seen = []
    save = common.REMAT_POLICIES["dots"]

    def recording(ctx, op, *args, **kwargs):
        decision = save(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            first = args[0] if args and isinstance(args[0], torch.Tensor) else None
            seen.append((op, () if first is None else tuple(first.shape), decision))
        return decision

    monkeypatch.setitem(common.REMAT_POLICIES, "dots", recording)
    cfg = reduced(get_config("phi3.5-moe-42b-a6.6b"))
    model = build_model(cfg)
    params = model.init_params(rng.PRNGKey(0, "cpu"))
    make_grad_fn(model, TrainConfig(compute_dtype=torch.float32, remat_policy="dots"))(
        params, batch_for(cfg))
    MUST = torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    saved = [(op, shape) for op, shape, d in seen if d == MUST]
    recomputed = [(op, shape) for op, shape, d in seen if d != MUST]
    bmm = torch.ops.aten.bmm.default
    L = cfg.n_layers
    assert len(saved) == 5 * L and all(op is bmm and shape[0] == 1 for op, shape in saved)
    batched = [shape for op, shape in recomputed if op is bmm]
    assert len(batched) == 5 * L and all(shape[0] > 1 for shape in batched)
    assert len(recomputed) > len(batched)  # elementwise work is recomputed too


def index_layers(layers):
    """Layer by layer indexing of the stacked leaves (``x[i]``)."""
    n = next(iter(tree_flatten_with_path(layers).values())).shape[0]
    return [tree_map_with_path(lambda _, x: x[i], layers) for i in range(n)]


@pytest.mark.parametrize("arch", ["gemma3-4b", "phi3.5-moe-42b-a6.6b", "rwkv6-1.6b",
                                  "zamba2-7b"])
def test_unstacked_layers_leave_serve_outputs_unchanged(monkeypatch, arch):
    cfg = reduced(get_config(arch))
    model = build_model(cfg)
    params = model.init_params(rng.PRNGKey(0, "cpu"), torch.bfloat16)
    toks = rng.randint(rng.PRNGKey(2, "cpu"), (2, 96), 0, cfg.vocab)

    def serve():
        prefill, decode = make_serve_steps(model)
        logits, state, n = prefill(params, {"tokens": toks[:, :64]}, 100)
        outs = [logits, *tree_flatten_with_path(state).values()]
        for t in range(64, 67):
            logits, state, n = decode(params, state, toks[:, t:t + 1], n)
            outs += [logits, *tree_flatten_with_path(state).values()]
        return outs

    got = serve()
    monkeypatch.setattr(transformer, "unstack_layers", index_layers)
    monkeypatch.setattr(recurrent, "unstack_layers", index_layers)
    want = serve()
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("arch", ["gemma3-4b", "phi3.5-moe-42b-a6.6b", "rwkv6-1.6b",
                                  "zamba2-7b"])
def test_forward_over_the_first_layers(arch):
    """A config with fewer layers than the parameters hold runs the first
    ones (``chip_smoke.py`` checks RWKV6 depth by depth this way), as the
    parameters cut to those layers do."""
    cfg = reduced(get_config(arch))
    params = build_model(cfg).init_params(rng.PRNGKey(0, "cpu"))
    first = dataclasses.replace(cfg, n_layers=cfg.n_layers - 1)
    if first.shared_attn_period:
        first = dataclasses.replace(first, n_layers=first.shared_attn_period)
    cut = dict(params, layers=tree_map_with_path(lambda _, x: x[:first.n_layers],
                                                 params["layers"]))
    batch = batch_for(cfg)
    loss = build_model(first).loss_fn
    assert torch.equal(loss(params, batch, remat=False)[0], loss(cut, batch, remat=False)[0])


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        shape = tuple(out.shape) if isinstance(out, torch.Tensor) else None
        self.names.append((func.overloadpacket.__name__, shape))
        return out


def test_stacked_gradients_are_written_once():
    """No ``select_backward`` into a stacked leaf's shape (a zero tensor the
    size of the whole stack per layer) in the backward: one ``stack`` per
    stacked leaf."""
    cfg = reduced(get_config("rwkv6-1.6b"))
    model = build_model(cfg)
    params = model.init_params(rng.PRNGKey(0, "cpu"))
    leaves = {k: v.requires_grad_(True) for k, v in tree_flatten_with_path(params).items()}
    loss, _ = model.loss_fn(params, batch_for(cfg), remat=False)
    with _Ops() as ops:
        torch.autograd.grad(loss, list(leaves.values()))
    stacked = [tuple(v.shape) for k, v in leaves.items() if k.startswith("layers/")]
    assert not [s for name, s in ops.names if name == "select_backward" and s in stacked]
    assert sorted(s for name, s in ops.names if name == "stack") == sorted(stacked)


def test_loss_decreases_on_markov_stream():
    """tests/test_train_substrate.py's test on the port: 20 steps of
    reduced mistral-nemo-12b (bfloat16 compute, remat on)."""
    cfg = reduced(get_config("mistral-nemo-12b"))
    m = build_model(cfg)
    params, opt = init_train_state(m, rng.PRNGKey(0, "cpu"))
    tcfg = TrainConfig(opt=AdamWConfig(lr=3e-3, warmup_steps=2, weight_decay=0.0,
                                       decay_steps=500))
    step = make_train_step(m, tcfg)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=64, global_batch=8, seed=1)
    losses = []
    for i in range(20):
        b = {k: torch.from_numpy(v) for k, v in data.shard_batch(i).items()}
        params, opt, metrics = step(params, opt, b)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.4, losses
    assert data.entropy_floor() < losses[-1]  # can't beat the floor


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_of_every_arch(arch):
    cfg = reduced(get_config(arch))
    model = build_model(cfg)
    params, opt = init_train_state(model, rng.PRNGKey(0, "cpu"))
    before = {k: v.clone() for k, v in tree_flatten_with_path(params).items()}
    params, opt, metrics = make_train_step(model, TrainConfig())(params, opt,
                                                                 batch_for(cfg, s=32))
    assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0
    after = tree_flatten_with_path(params)
    assert all(torch.isfinite(v).all() for v in after.values())
    assert any(not torch.equal(after[k], before[k]) for k in before)
    assert int(opt["step"]) == 1
