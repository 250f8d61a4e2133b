"""The port's MoE (repro_torch.models.mlp, and the MoE transformers
phi3.5-moe and qwen3-moe at ``reduced()``) against the reference's on the
CPU: the single-card ``_moe_local``'s output, aux loss, routing ids and
kept assignments, also with the router's column 0 raised by 3.0 so that
assignments are dropped at capacity; ``init_params(PRNGKey(0))`` within
1e-5 per leaf; with the reference's weights carried over, float32
``forward`` logits, the summed aux loss and ``loss_fn`` within 1e-4
(max|Δ| / max|ref|); ``param_axes``; and the reference tests' own
properties on the port (decode against the full forward, the loss
depends on the routing)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import build_model as j_build_model
from repro.models import mlp as j_mlp
from repro.models import transformer as j_transformer
from repro_torch import rng
from repro_torch.configs import get_config, reduced
from repro_torch.models import build_model, mlp, transformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.tree import tree_flatten_with_path, tree_map_with_path
from moe_parity import reference_routing
from serve_parity import rel_err
from test_torch_models import flat_numpy

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

ARCHS = ["phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b"]
TOL = 1e-4
INIT_TOL = 1e-5
B, S = 2, 64
CASES = {"plain": 0.0, "router0+3": 3.0}


def raise_router(layer_params, by: float):
    """The MoE params with the router's column 0 raised by ``by``."""
    p = dict(layer_params)
    p["router"] = p["router"].at[:, 0].add(by)
    return p


@pytest.fixture(scope="module")
def jax_side():
    """Per arch, once: the reference's config, model and PRNGKey(0) params,
    a batch drawn with numpy, its float32 forward (logits, aux) and loss,
    and per case of ``CASES`` ``_moe_local`` of layer 0 on ``x`` (normal
    with mean 0.5: its sum over d is positive, so a raised column 0 takes
    nearly every token, past the capacity) with the reference's routing."""
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
            fwd = j_transformer.forward(params, cfg, jbatch, remat=False)
            loss = model.loss_fn(params, jbatch, remat=False)
            x = (rs.standard_normal((B, S, cfg.d_model)) + 0.5).astype(np.float32)
            p0 = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
            local = {}
            for case, by in CASES.items():
                p = raise_router(p0, by)
                out, aux = j_mlp._moe_local(jnp.asarray(x), p, cfg, 1, 0)
                local[case] = [np.asarray(a) for a in (out, aux, *reference_routing(
                    jnp.asarray(x), p, cfg))]
            cache[arch] = dict(cfg=cfg, model=model, params=params, batch=batch, fwd=fwd,
                               loss=loss, x=x, local=local)
        return cache[arch]

    return get


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_local_matches_reference(jax_side, arch, case):
    ref = jax_side(arch)
    want_out, want_aux, _, want_ids, want_keep = ref["local"][case]
    cfg = reduced(get_config(arch))
    layers = params_from_numpy(jax.tree.map(np.asarray, ref["params"]["layers"]), "cpu")
    p = {k: v[0] for k, v in layers["moe"].items()}
    p["router"][:, 0] += CASES[case]
    x = torch.from_numpy(ref["x"])
    out, aux = mlp.moe(x, p, cfg)
    r = mlp.moe_routing(x.reshape(-1, cfg.d_model), p["router"], cfg)
    np.testing.assert_array_equal(r["ids"].numpy(), want_ids)
    np.testing.assert_array_equal(r["keep"].numpy(), want_keep)
    if CASES[case]:
        assert (~want_keep).sum() > 0  # the raised column overflows its expert
    assert rel_err(out.numpy(), want_out) <= TOL
    assert abs(float(aux) - float(want_aux)) <= TOL * abs(float(want_aux))


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
        if k.endswith(("norm1", "norm2", "final_norm")):
            np.testing.assert_array_equal(g, w, err_msg=k)  # ones
        else:
            assert rel_err(g, w) <= INIT_TOL, k


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(jax_side, arch):
    ref = jax_side(arch)
    cfg = reduced(get_config(arch))
    model = build_model(cfg)
    params = params_from_numpy(jax.tree.map(np.asarray, ref["params"]), "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    want, want_aux = ref["fwd"]
    got, aux = transformer.forward(params, cfg, tbatch)
    assert got.shape == (B, S, cfg.vocab) and torch.isfinite(got).all()
    assert rel_err(got.numpy(), want) <= TOL
    assert float(want_aux) > 0 and abs(float(aux) - float(want_aux)) <= TOL * float(want_aux)
    (want_loss, want_m), (got_loss, got_m) = ref["loss"], model.loss_fn(params, tbatch)
    for g, w in ((got_loss, want_loss), (got_m["xent"], want_m["xent"]),
                 (got_m["aux"], want_m["aux"])):
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


def decode_vs_full_forward(full, dec) -> float:
    ref, got = full[:, 15], dec[:, 0]
    return float(abs(ref - got).max() / (abs(ref).max() + 1e-9))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(jax_side, arch):
    """tests/test_models.py::test_decode_matches_full_forward on the port:
    the decode step's logits at position 15 (over the bf16 KV cache)
    against the full forward's, float32 params from PRNGKey(0).  The
    reference test holds phi3.5-moe to rel < 0.03; on qwen3-moe the bf16
    cache's rounding moves it to 0.265, in the reference too: the port's
    value equals the reference's within 1e-3 on both, and over a float32
    cache the port's decode computes what its forward computes."""
    cfg = reduced(get_config(arch))
    m = build_model(cfg)
    params = m.init_params(rng.PRNGKey(0, "cpu"))
    toks = rng.randint(rng.PRNGKey(0, "cpu"), (2, 16), 0, cfg.vocab)
    full, _ = transformer.forward(params, cfg, {"tokens": toks})
    _, cache, clen = m.prefill_fn(params, {"tokens": toks[:, :15]}, max_len=20)
    ld, _ = m.decode_fn(params, cache, toks[:, 15:16], clen)
    got = decode_vs_full_forward(full.numpy(), ld.numpy())

    ref = jax_side(arch)
    jm, jparams = ref["model"], ref["params"]
    jtoks = jnp.asarray(toks.numpy())
    jfull, _ = j_transformer.forward(jparams, ref["cfg"], {"tokens": jtoks}, remat=False)
    _, jcache, jlen = jm.prefill_fn(jparams, {"tokens": jtoks[:, :15]}, max_len=20)
    jdec, _ = jm.decode_fn(jparams, jcache, jtoks[:, 15:16], jlen)
    want = decode_vs_full_forward(np.asarray(jfull), np.asarray(jdec))
    assert abs(got - want) <= 1e-3, (got, want)
    if arch == "phi3.5-moe-42b-a6.6b":
        assert got < 0.03, f"{arch}: rel err {got}"
    _, cache, clen = transformer.prefill(params, cfg, {"tokens": toks[:, :15]}, 20,
                                         cache_dtype=torch.float32)
    ld, _ = transformer.decode_step(params, cfg, cache, toks[:, 15:16], clen)
    assert decode_vs_full_forward(full.numpy(), ld.numpy()) <= TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_outputs_depend_on_routing(arch):
    """tests/test_models.py::test_moe_outputs_depend_on_routing on the port:
    raising the router's column 0 (asymmetric: a uniform shift would be
    softmax-invariant) changes the loss."""
    cfg = reduced(get_config(arch))
    m = build_model(cfg)
    params = m.init_params(rng.PRNGKey(0, "cpu"))
    toks = rng.randint(rng.PRNGKey(0, "cpu"), (2, 32), 0, cfg.vocab)
    batch = {"tokens": toks, "labels": toks}
    loss1, _ = m.loss_fn(params, batch)
    params2 = tree_map_with_path(
        lambda path, x: x + torch.nn.functional.one_hot(torch.tensor(0), x.shape[-1])
        * 3.0 if path.endswith("router") else x, params)
    loss2, _ = m.loss_fn(params2, batch)
    assert abs(float(loss1) - float(loss2)) > 1e-6


def test_sharded_experts_raise():
    """Parameters holding a shard of the experts with no mesh to hold the
    rest: the layer raises rather than routing to experts it does not hold
    (expert parallelism runs over a mesh: tests/test_torch_moe_ep.py)."""
    cfg = reduced(get_config("qwen3-moe-235b-a22b"))
    p = mlp.init_moe_params(rng.PRNGKey(0, "cpu"), cfg)
    half = {k: v if k == "router" else v[:cfg.n_experts // 2] for k, v in p.items()}
    with pytest.raises(ValueError, match=f"hold {cfg.n_experts // 2} of {cfg.n_experts} experts"):
        mlp.moe(torch.zeros((1, 4, cfg.d_model)), half, cfg)
