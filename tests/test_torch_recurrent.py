"""The port's recurrent families (repro_torch.models.ssm and .recurrent:
RWKV6 and Zamba2 at ``reduced()``) against the reference's on the CPU:
the chunked scans against the one-token recurrences and against the
reference's scans (over several chunks and at one token, the decode
path's chunk); ``init_params(PRNGKey(0))`` within 1e-5 per leaf; with the
reference's weights carried over, float32 forward logits and ``loss_fn``
within 1e-4 (max|Δ| / max|ref|); ``param_axes``; the reference tests'
properties on the port (RWKV decode token by token against its chunked
forward, Zamba decode finite); and Zamba's shared-attention ring after it
has wrapped (a window shorter than the prompt) against the reference's,
every state leaf by its dtype."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import build_model as j_build_model
from repro.models import recurrent as j_recurrent
from repro.models import ssm as j_ssm
from repro_torch import rng
from repro_torch.configs import get_config, reduced
from repro_torch.models import build_model, recurrent, ssm
from repro_torch.models.convert import params_from_numpy
from repro_torch.tree import tree_flatten_with_path
from serve_parity import assert_serve_close, fp32_steps, rel_err, run_serve
from test_torch_models import flat_numpy

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

ARCHS = ["rwkv6-1.6b", "zamba2-7b"]
TOL = 1e-4
INIT_TOL = 1e-5
B, S = 2, 64
RING_WINDOW, RING_P, RING_GEN = 48, 64, 3  # the prompt wraps the ring


def scan_inputs(kind: str, S: int):
    """Float32 inputs of ``chunked_rwkv`` / ``chunked_ssd`` (B=2, H=3,
    K=N=8, V=P=6) with a nonzero initial state, drawn with numpy."""
    rs = np.random.RandomState(5)
    n = lambda *shape: rs.standard_normal(shape).astype(np.float32)
    if kind == "rwkv":
        logw = -np.exp(n(2, S, 3, 8))  # the floor at -8 binds for a few
        return dict(r=n(2, S, 3, 8), k=n(2, S, 3, 8), v=n(2, S, 3, 6), logw=logw,
                    u=n(3, 8), state=n(2, 3, 8, 6))
    return dict(r=n(2, S, 3, 8), k=n(2, S, 3, 8), v=n(2, S, 3, 6),
                loga=-np.exp(n(2, S, 3)), state=n(2, 3, 8, 6))


@pytest.fixture(scope="module")
def jax_side():
    """Per arch, once: the reference's config, model and PRNGKey(0)
    params, a batch drawn with numpy and its float32 forward logits and
    loss."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = j_reduced(j_get_config(arch))
            model = j_build_model(cfg)
            params = model.init_params(jax.random.PRNGKey(0))
            rs = np.random.RandomState(7)
            batch = {"tokens": rs.randint(0, cfg.vocab, (B, S)).astype(np.int32),
                     "labels": rs.randint(0, cfg.vocab, (B, S)).astype(np.int32)}
            jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
            if cfg.family == "ssm":
                logits = j_recurrent.rwkv_forward(params, cfg, jbatch)[0]
            else:
                logits = j_recurrent.zamba_forward(params, cfg, jbatch)[0]
            cache[arch] = dict(cfg=cfg, model=model, params=params, batch=batch,
                               logits=np.asarray(logits),
                               loss=model.loss_fn(params, jbatch, remat=False))
        return cache[arch]

    return get


@pytest.mark.parametrize("S_", [1, 48])
def test_chunked_rwkv_matches_step_and_reference(S_):
    """3 chunks of 16 (and one token, decode's chunk): the port's chunked
    scan against its own recurrence token by token and against the
    reference's scan, output and final state."""
    a = scan_inputs("rwkv", S_)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    y, st = ssm.chunked_rwkv(t["r"], t["k"], t["v"], t["logw"], t["u"], t["state"])
    wy, wst = j_ssm.chunked_rwkv(*(jnp.asarray(a[k]) for k in ("r", "k", "v", "logw", "u",
                                                              "state")))
    assert rel_err(y.numpy(), wy) <= TOL and rel_err(st.numpy(), wst) <= TOL
    s, ys = t["state"], []
    for i in range(S_):
        yi, s = ssm.rwkv_step(t["r"][:, i], t["k"][:, i], t["v"][:, i], t["logw"][:, i],
                              t["u"], s)
        ys.append(yi)
    assert rel_err(y.numpy(), torch.stack(ys, 1).numpy()) <= TOL
    assert rel_err(st.numpy(), s.numpy()) <= TOL


@pytest.mark.parametrize("S_", [1, 64])
def test_chunked_ssd_matches_step_and_reference(S_):
    """2 chunks of 32 (and one token): as for RWKV, against ``ssd_step``
    and the reference's ``chunked_ssd``."""
    a = scan_inputs("ssd", S_)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    y, st = ssm.chunked_ssd(t["r"], t["k"], t["v"], t["loga"], t["state"])
    wy, wst = j_ssm.chunked_ssd(*(jnp.asarray(a[k]) for k in ("r", "k", "v", "loga", "state")))
    assert rel_err(y.numpy(), wy) <= TOL and rel_err(st.numpy(), wst) <= TOL
    s, ys = t["state"], []
    for i in range(S_):
        yi, s = ssm.ssd_step(t["r"][:, i], t["k"][:, i], t["v"][:, i], t["loga"][:, i], s)
        ys.append(yi)
    assert rel_err(y.numpy(), torch.stack(ys, 1).numpy()) <= TOL
    assert rel_err(st.numpy(), s.numpy()) <= TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_reference(jax_side, arch):
    jparams = jax_side(arch)["params"]
    model = build_model(reduced(get_config(arch)))
    got = tree_flatten_with_path(model.init_params(rng.PRNGKey(0, "cpu")))
    want = flat_numpy(jparams)
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if np.unique(w).size == 1:  # ones, zeros and constant fills
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert rel_err(g, w) <= INIT_TOL, k


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(jax_side, arch):
    ref = jax_side(arch)
    cfg = reduced(get_config(arch))
    model = build_model(cfg)
    params = params_from_numpy(jax.tree.map(np.asarray, ref["params"]), "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    if cfg.family == "ssm":
        got, aux, _ = recurrent.rwkv_forward(params, cfg, tbatch)
    else:
        got, aux = recurrent.zamba_forward(params, cfg, tbatch)
    assert got.shape == (B, S, cfg.vocab) and torch.isfinite(got).all() and float(aux) == 0
    assert rel_err(got.numpy(), ref["logits"]) <= TOL
    (want_loss, want_m), (got_loss, got_m) = ref["loss"], model.loss_fn(params, tbatch)
    for g, w in ((got_loss, want_loss), (got_m["xent"], want_m["xent"])):
        assert abs(float(g) - float(w)) <= TOL * abs(float(w))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_structure(jax_side, arch):
    model = build_model(reduced(get_config(arch)))
    axes = model.param_axes()
    assert axes == jax_side(arch)["model"].param_axes()
    flat_axes = jax.tree_util.tree_flatten_with_path(
        axes, is_leaf=lambda x: isinstance(x, tuple))[0]
    flat_axes = {"/".join(str(k.key) for k in path): a for path, a in flat_axes}
    params = tree_flatten_with_path(model.init_params(rng.PRNGKey(0, "cpu")))
    assert flat_axes.keys() == params.keys()
    for k, p in params.items():
        assert len(flat_axes[k]) == p.ndim, (k, p.shape, flat_axes[k])


def test_rwkv_decode_matches_chunked():
    """tests/test_models.py::test_rwkv_decode_matches_chunked on the port:
    decode token by token from the zero state against the chunked forward
    (rel < 0.01), here over 32 tokens (two chunks)."""
    cfg = reduced(get_config("rwkv6-1.6b"))
    m = build_model(cfg)
    params = m.init_params(rng.PRNGKey(0, "cpu"))
    toks = rng.randint(rng.PRNGKey(0, "cpu"), (1, 32), 0, cfg.vocab)
    full, _, _ = recurrent.rwkv_forward(params, cfg, {"tokens": toks})
    state = recurrent.rwkv_state_init(cfg, 1)
    outs = []
    for t in range(32):
        lg, state = m.decode_fn(params, state, toks[:, t:t + 1], torch.tensor(t))
        outs.append(lg[:, 0])
    got = torch.stack(outs, dim=1)
    rel = float((full - got).abs().max() / (full.abs().max() + 1e-9))
    assert rel < 0.01, rel


def test_zamba_decode_runs_and_is_finite():
    """tests/test_models.py::test_zamba_decode_runs_and_is_finite on the
    port: three steps from the zero state over a 64-slot window."""
    cfg = reduced(get_config("zamba2-7b"))
    m = build_model(cfg)
    params = m.init_params(rng.PRNGKey(0, "cpu"))
    state = recurrent.zamba_state_init(cfg, 2, 64)
    toks = rng.randint(rng.PRNGKey(0, "cpu"), (2, 1), 0, cfg.vocab)
    for t in range(3):
        lg, state = m.decode_fn(params, state, toks, torch.tensor(t, dtype=torch.int32))
    assert torch.isfinite(lg).all()
    assert state["k"].dtype == torch.bfloat16 and state["ssm"].dtype == torch.float32


def test_zamba_wrapped_ring_matches_reference(jax_side):
    """A shared-attention window of 48 under a 64-token prompt: the prefill
    keeps positions 16-63 at slots ``pos % 48``, decode writes 64, 65, 66
    over slots 16-18 and attends over every slot; float32 steps, logits and
    every state leaf against the reference's, each step from its state."""
    ref = jax_side("zamba2-7b")
    jcfg = dataclasses.replace(ref["cfg"], shared_attn_window=RING_WINDOW)
    cfg = dataclasses.replace(reduced(get_config("zamba2-7b")), shared_attn_window=RING_WINDOW)
    jmodel, model = j_build_model(jcfg), build_model(cfg)
    toks = np.random.RandomState(13).randint(0, cfg.vocab, (B, RING_P + RING_GEN)).astype(
        np.int32)
    max_len = RING_P + RING_GEN + 1
    jpre, jdec = fp32_steps(jmodel)
    want = run_serve(jax.jit(jpre, static_argnums=2), jax.jit(jdec), ref["params"], toks,
                     jnp.asarray, RING_P, max_len)
    params = params_from_numpy(jax.tree.map(np.asarray, ref["params"]), "cpu")
    got = run_serve(*fp32_steps(model), params, toks, torch.from_numpy, RING_P, max_len,
                    states=want[1])
    assert got[1][0]["k"][0].shape[2] == RING_WINDOW
    assert_serve_close(got, want, "fp32")
