"""Shared helpers of the port's training tests: one reduced arch's state,
batch and train step in either package, from the same numpy inputs, and
the distances the parity rule holds (max|Δ| / max|ref| per leaf)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import build_model as j_build_model
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import TrainConfig as JTrainConfig
from repro.train import init_train_state as j_init_train_state
from repro.train import make_train_step as j_make_train_step
from repro_torch.configs import get_config, reduced
from repro_torch.models import build_model
from repro_torch.models.convert import train_state_from_numpy
from repro_torch.train import AdamWConfig, TrainConfig

B, S = 4, 64  # whole chunks of RWKV's 16 and the SSD's 32
OPT = dict(lr=1e-3, warmup_steps=2)


def rel_err(got, want) -> float:
    """max|Δ| / max|ref|; a leaf that is zero in the reference must be zero."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    norm = np.abs(want).max()
    return float(np.abs(got - want).max() / norm) if norm else float(np.abs(got).max())


def flat_numpy(tree) -> dict:
    """``{"a/b/c": leaf}`` of a JAX tree, as the port names paths."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(k.key) for k in path): np.asarray(x) for path, x in flat}


def make_batch(cfg, seed: int, b: int = B, s: int = S) -> dict:
    """Labels, and tokens or (for the stub frontends) float32 embeddings,
    drawn with numpy."""
    rs = np.random.RandomState(seed)
    batch = {"labels": rs.randint(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend != "none":
        batch["embeds"] = rs.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = rs.randint(0, cfg.vocab, (b, s)).astype(np.int32)
    return batch


def j_tcfg(dtype, microbatches: int = 1):
    # remat changes no value, only what the backward recomputes
    return JTrainConfig(opt=JAdamWConfig(**OPT), compute_dtype=dtype, remat=False,
                        microbatches=microbatches)


def t_tcfg(dtype, microbatches: int = 1, **kw):
    return TrainConfig(opt=AdamWConfig(**OPT), compute_dtype=dtype, microbatches=microbatches,
                       **kw)


class Ref:
    """One reduced arch in the reference: config, model, ``init_train_state
    (PRNGKey(0))``."""

    def __init__(self, arch: str):
        self.arch = arch
        self.cfg = j_reduced(j_get_config(arch))
        self.model = j_build_model(self.cfg)
        self.params, self.opt = j_init_train_state(self.model, jax.random.PRNGKey(0))
        self._grad_fns = {}

    def step(self, batch, dtype=jnp.float32, microbatches: int = 1):
        """The reference's jitted train step from the initial state: (params,
        opt_state, metrics) as numpy trees."""
        fn = jax.jit(j_make_train_step(self.model, j_tcfg(dtype, microbatches)))
        out = fn(self.params, self.opt, {k: jnp.asarray(v) for k, v in batch.items()})
        return jax.tree.map(np.asarray, out)

    def grads(self, batch, dtype=jnp.float32, params=None):
        """(loss, metrics, flat gradients) of the reference's train-step
        loss (params cast to ``dtype``) at the initial state (or at
        ``params``); one jitted function per dtype, traced at its first
        call."""
        from repro.models.common import cast_tree

        if dtype not in self._grad_fns:
            def loss_of(p, b):
                b = dict(b)
                if "embeds" in b:
                    b["embeds"] = b["embeds"].astype(dtype)
                return self.model.loss_fn(cast_tree(p, dtype), b, remat=False)

            self._grad_fns[dtype] = jax.jit(jax.value_and_grad(loss_of, has_aux=True))
        (loss, metrics), g = self._grad_fns[dtype](
            self.params if params is None else params,
            {k: jnp.asarray(v) for k, v in batch.items()})
        return float(loss), jax.tree.map(float, metrics), flat_numpy(g)

    def port(self):
        """The port's model and a copy of this initial state on the CPU."""
        model = build_model(reduced(get_config(self.arch)))
        params, opt = train_state_from_numpy(jax.tree.map(np.asarray, self.params),
                                             jax.tree.map(np.asarray, self.opt), "cpu")
        return model, params, opt


def t_batch(batch) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def one_ulp(tree, seed: int):
    """``tree`` with every element moved one ulp up or down (a seeded coin
    per element): the reference's inputs as another rounding would leave
    them."""
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda a: np.nextafter(
        np.asarray(a), np.where(rs.rand(*a.shape) < 0.5, np.inf, -np.inf).astype(a.dtype)), tree)


# ---------------------------------------------------------------------------
# float32 one-step parity (tests/test_torch_train_step*.py)
# ---------------------------------------------------------------------------
TOL = 1e-4
SMALL_GRAD = 1e-3  # of the leaf's largest: the first step's ill-conditioned elements


def float32_run(arch: str) -> dict:
    """The reference's jitted step, gradients and gradients at one-ulp-moved
    parameters (the MoE's routing recorded while the gradient is traced),
    and the port's gradients and step (remat on, its default; the
    reference's remat off changes no value), from ``init_train_state
    (PRNGKey(0))`` and one batch."""
    from repro.models import mlp as j_mlp
    from repro_torch.train import make_train_step
    from repro_torch.train.steps import make_grad_fn
    from moe_parity import recording_moe_local
    from serve_parity import port_routing

    ref = Ref(arch)
    batch = make_batch(ref.cfg, 5)
    r = {"ref": ref, "step": ref.step(batch), "routing": [], "port_routing": []}
    orig = j_mlp._moe_local
    j_mlp._moe_local = recording_moe_local(r["routing"])
    try:
        r["grads"] = ref.grads(batch)
        jax.effects_barrier()
    finally:
        j_mlp._moe_local = orig
    # the jitted function keeps its callback: later calls append to the old list
    r["routing"] = r["routing"][:]
    r["grads_ulp"] = ref.grads(batch, params=one_ulp(ref.params, 9))[2]
    model, params, opt = ref.port()
    with port_routing(r["port_routing"]):
        r["port_grads"] = make_grad_fn(model, t_tcfg(torch.float32))(params, t_batch(batch))
    r["port_step"] = make_train_step(model, t_tcfg(torch.float32))(params, opt, t_batch(batch))
    return r


def grad_bounds(r) -> dict:
    """Per gradient leaf: 1e-4, or twice the reference's own one-ulp
    distance where that is larger."""
    g, gu = r["grads"][2], r["grads_ulp"]
    return {k: max(TOL, 2 * rel_err(gu[k], g[k])) for k in g}


def check_loss_and_gradients(r) -> None:
    arch = r["ref"].arch
    (jloss, jmetrics, jgrads), (loss, metrics, grads) = r["grads"], r["port_grads"]
    assert abs(float(loss) - jloss) <= TOL * abs(jloss)
    for k in ("xent", "aux"):
        assert abs(float(metrics[k]) - jmetrics[k]) <= TOL * max(abs(jmetrics[k]), 1e-30), k
    _, _, jm = r["step"]
    _, _, tm = r["port_step"]
    for k in ("loss", "xent", "aux", "grad_norm"):
        assert abs(float(tm[k]) - float(jm[k])) <= TOL * max(abs(float(jm[k])), 1e-30), k
    assert float(tm["lr"]) == float(jm["lr"])
    assert grads.keys() == jgrads.keys()
    for k, g in grads.items():
        assert g.dtype == torch.float32 and g.shape == jgrads[k].shape, k
    bound = grad_bounds(r)
    errs = {k: rel_err(grads[k].numpy(), jgrads[k]) for k in jgrads}
    wide = {k: round(b, 7) for k, b in bound.items() if b > TOL}
    print(f"{arch}: worst gradient leaf {max(errs.values()):.3e}; bounds above 1e-4 "
          f"(the reference's own one-ulp distance x2): {wide}")
    assert all(errs[k] <= bound[k] for k in errs), {k: (errs[k], bound[k]) for k in errs
                                                    if errs[k] > bound[k]}


def check_one_step_state(r) -> None:
    check_state(r["ref"].arch, r["port_step"], r["step"], r["grads"][2], grad_bounds(r))


def check_state(label, port_step, ref_step, ref_grads: dict, bound: dict) -> None:
    """The state after one step from the initial state: ``m`` within the
    gradients' bound, ``v`` within twice it (it is quadratic in the
    gradient), the parameters within 1e-4 except where ``ref_grads`` is
    below ``SMALL_GRAD`` of its leaf's largest (counted and logged)."""
    from repro_torch.tree import tree_flatten_with_path

    jp, jo, _ = ref_step
    tp, to, _ = port_step
    assert int(to["step"]) == int(jo["step"]) == 1 and to["step"].dtype == torch.int32
    for name, scale in (("m", 1), ("v", 2)):
        got, want = tree_flatten_with_path(to[name]), flat_numpy(jo[name])
        assert got.keys() == want.keys()
        for k in want:
            assert rel_err(got[k].numpy(), want[k]) <= scale * bound[k], (name, k)
    got, want = tree_flatten_with_path(tp), flat_numpy(jp)
    assert got.keys() == want.keys()
    skipped = {}
    for k in want:
        g = np.abs(ref_grads[k])
        held = g >= SMALL_GRAD * g.max()
        err = np.abs(got[k].numpy().astype(np.float64) - want[k]) / np.abs(want[k]).max()
        assert float(err[held].max(initial=0.0)) <= TOL, k
        if (~held).any():
            skipped[k] = (int((~held).sum()), f"{float(err[~held].max()):.2e}")
    print(f"{label}: parameter elements not held (reference gradient below {SMALL_GRAD} of "
          f"the leaf's largest; count, worst distance): {skipped}")
