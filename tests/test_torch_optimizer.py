"""The port's AdamW (repro_torch.train.optimizer) against the reference's
(repro.train.optimizer, jitted as the train step runs it) on the CPU:
``schedule`` over steps 0-600 (warmup and cosine decay), ``global_norm``,
``apply_updates`` given the same numpy parameters, gradients and state
(synthetic trees with clipping on and off at several steps, and the
reference's own gradients of reduced qwen1.5-4b) within 1e-6 per leaf
(max|Δ| / max|ref|), with the elements that are not bit-equal counted in
ulps; ``init_opt_state`` and ``opt_state_axes``' structure."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as j_opt
from repro_torch.train import optimizer as opt
from repro_torch.tree import tree_flatten_with_path
from train_parity import Ref, flat_numpy, make_batch, rel_err

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

TOL = 1e-6
CFGS = {
    "launcher": dict(lr=3e-3, warmup_steps=5, decay_steps=50),
    "defaults": {},
    "clip0.37": dict(lr=1e-3, warmup_steps=1, clip_norm=0.37, weight_decay=0.05,
                     decay_steps=600),
}


def ulps(got, want) -> np.ndarray:
    """The distance in float32 ulps of each element (same-sign values)."""
    return np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("name", sorted(CFGS))
def test_schedule_matches_reference(name):
    """Equal in the warmup and wherever the cosine's argument is 0 or pi;
    in the decay torch's float32 ``cos`` is not XLA's (an ulp or two
    apart), so the rate may differ there by up to 2**-23 of the peak rate
    (more ulps of the rate itself near the end of the decay, where ``1 +
    cos`` cancels; counted)."""
    cfg_j, cfg_t = j_opt.AdamWConfig(**CFGS[name]), opt.AdamWConfig(**CFGS[name])
    steps = np.arange(601, dtype=np.int32)
    want = np.asarray(jax.vmap(jax.jit(lambda s: j_opt.schedule(cfg_j, s)))(jnp.asarray(steps)))
    got = np.array([opt.schedule(cfg_t, torch.tensor(s)).item() for s in steps], np.float32)
    d = ulps(got, want)
    exact = (steps <= cfg_t.warmup_steps) | (steps >= cfg_t.decay_steps)
    assert (d[exact] == 0).all(), steps[exact][d[exact] != 0]
    assert np.abs(got.astype(np.float64) - want).max() <= 2.0**-23 * cfg_t.lr
    print(f"{name}: {int((d > 0).sum())} of 601 steps differ, by at most {int(d.max())} ulp")


def synthetic(seed: int, clip_active: bool):
    """Params, gradients and state (m, v at some earlier step) of three
    leaves; gradients spread over six orders of magnitude."""
    rs = np.random.RandomState(seed)
    shapes = {"a": (64, 48), "b": {"c": (1000,), "d": (3, 5, 7)}}
    mk = lambda f: {"a": f(shapes["a"]), "b": {k: f(v) for k, v in shapes["b"].items()}}
    scale = 30.0 if clip_active else 1e-3
    p = mk(lambda s: rs.standard_normal(s).astype(np.float32))
    g = mk(lambda s: (rs.standard_normal(s) * np.exp(rs.uniform(-7, 0, s)) * scale).astype(
        np.float32))
    m = mk(lambda s: (rs.standard_normal(s) * 1e-2).astype(np.float32))
    v = mk(lambda s: (np.abs(rs.standard_normal(s)) * 1e-4).astype(np.float32))
    return p, g, m, v


def port_apply(cfg, p, g, state):
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)
    tg = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), g)
    ts = {"m": jax.tree.map(lambda a: torch.from_numpy(np.array(a)), state["m"]),
          "v": jax.tree.map(lambda a: torch.from_numpy(np.array(a)), state["v"]),
          "step": torch.tensor(int(state["step"]), dtype=torch.int32)}
    out = opt.apply_updates(cfg, tp, tg, ts)
    assert out[0] is tp and out[1] is ts  # in place
    return out


def compare_updates(label, cfg_name, p, g, state) -> None:
    """The port's step against the reference's, leaf by leaf within 1e-6.
    ``grad_norm``: the port's float32 sum is within 1e-6 of the float64
    norm, XLA's can be farther (1.1e-6 on qwen's gradients), so the two
    are held within 1e-5; with clipping on, every leaf inherits that
    difference of the scale, and the leaves' bound grows by it."""
    cfg_j, cfg_t = j_opt.AdamWConfig(**CFGS[cfg_name]), opt.AdamWConfig(**CFGS[cfg_name])
    jp, js, jm = jax.tree.map(np.asarray, jax.jit(
        lambda *a: j_opt.apply_updates(cfg_j, *a))(p, g, state))
    tp, ts, tm = port_apply(cfg_t, p, g, state)
    assert int(ts["step"]) == int(js["step"]) and ts["step"].dtype == torch.int32
    exact = np.sqrt(sum(float((a.astype(np.float64) ** 2).sum()) for a in jax.tree.leaves(g)))
    gn, jgn = float(tm["grad_norm"]), float(jm["grad_norm"])
    assert abs(gn - exact) <= TOL * exact and abs(gn - jgn) <= 10 * TOL * jgn
    drift = abs(gn - jgn) / jgn if jgn > cfg_t.clip_norm else 0.0
    assert abs(float(tm["lr"]) - float(jm["lr"])) <= 2.0**-23 * cfg_t.lr
    differ = {}
    for name, got, want in (("params", tp, jp), ("m", ts["m"], js["m"]), ("v", ts["v"], js["v"])):
        got, want = tree_flatten_with_path(got), flat_numpy(want)
        assert got.keys() == want.keys()
        for k in want:
            g_np = got[k].numpy()
            assert g_np.dtype == want[k].dtype, (name, k)
            assert rel_err(g_np, want[k]) <= TOL + 2 * drift, (name, k)
            d = ulps(g_np, want[k])
            if d.any():
                differ[f"{name}/{k}"] = (int((d > 0).sum()), int(d.max()))
    print(f"{label}: grad_norm {gn!r} (reference {jgn!r}, float64 {exact!r}); elements not "
          f"bit-equal (count, most ulps): {differ or 'none'}")


@pytest.mark.parametrize("cfg_name", sorted(CFGS))
@pytest.mark.parametrize("step,clip", [(0, False), (7, True), (30, True), (400, False)])
def test_apply_updates_matches_reference(cfg_name, step, clip):
    p, g, m, v = synthetic(step, clip)
    compare_updates(f"{cfg_name} step {step} clip {clip}", cfg_name, p, g,
                    {"m": m, "v": v, "step": np.int32(step)})


@pytest.fixture(scope="module")
def qwen():
    """Reduced qwen1.5-4b in the reference and its float32 gradients at the
    initial parameters."""
    ref = Ref("qwen1.5-4b")
    return ref, ref.grads(make_batch(ref.cfg, 5))[2]


@pytest.mark.parametrize("step", [0, 6])
def test_apply_updates_on_the_reference_gradients(qwen, step):
    """Given the reference's own float32 gradients of reduced qwen1.5-4b at
    its initial parameters."""
    ref, flat_g = qwen
    g = jax.tree.map(np.asarray, ref.params)
    leaves = jax.tree_util.tree_flatten_with_path(g)[0]
    g = jax.tree_util.tree_unflatten(
        jax.tree.structure(g), [flat_g["/".join(str(k.key) for k in path)] for path, _ in leaves])
    rs = np.random.RandomState(step)
    state = {"m": jax.tree.map(lambda a: (0.1 * a * rs.standard_normal(a.shape)).astype(
        np.float32), g), "v": jax.tree.map(lambda a: (0.05 * a * a).astype(np.float32), g),
        "step": np.int32(step)}
    compare_updates(f"qwen1.5-4b gradients, step {step}", "launcher",
                    jax.tree.map(np.asarray, ref.params), g, state)


def test_global_norm_matches_reference():
    p, g, _, _ = synthetic(3, True)
    want = float(j_opt.global_norm(g))
    got = opt.global_norm(jax.tree.map(lambda a: torch.from_numpy(np.array(a)), g))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= TOL * want


def test_init_opt_state_and_axes():
    ref = Ref("zamba2-7b")
    _, params, state = ref.port()
    fresh = opt.init_opt_state(params)
    assert fresh["step"].dtype == torch.int32 and fresh["step"].shape == () and int(fresh["step"]) == 0
    for name in ("m", "v"):
        got, want = tree_flatten_with_path(fresh[name]), tree_flatten_with_path(state[name])
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) and got[k].dtype == torch.float32 for k in got)
    axes = ref.model.param_axes()
    assert opt.opt_state_axes(axes) == j_opt.opt_state_axes(axes)
