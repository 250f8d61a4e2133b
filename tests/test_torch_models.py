"""The port's transformer family (repro_torch.models) against the
reference's (repro.models) on the CPU, for the six archs it builds at
``reduced()``: its own ``init_params(PRNGKey(0))`` within 1e-5 of JAX's leaf
by leaf (relative to the leaf's largest value; torch's erfinv is not
XLA's), and with the reference's weights carried over (``params_from_numpy``)
float32 ``forward`` logits and ``loss_fn`` within 1e-4 (matmuls round
differently); ``param_axes``' structure; ``flash_attention`` with a KV chunk
wholly outside the window.  The MoE, RWKV6 and Zamba2 archs are held in
``test_torch_moe.py``, ``test_torch_recurrent.py`` and
``test_torch_serve_families.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import attention as j_attn
from repro.models import build_model as j_build_model
from repro.models import transformer as j_transformer
from repro_torch import rng
from repro_torch.configs import get_config, reduced
from repro_torch.models import attention, build_model, transformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.tree import tree_flatten_with_path

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

ARCHS = ["gemma3-4b", "gemma-7b", "mistral-nemo-12b", "qwen1.5-4b", "musicgen-large",
         "llava-next-mistral-7b"]
FP32_TOL = 1e-4
INIT_TOL = 1e-5
B, S = 2, 96  # past reduced gemma3's 64-token window


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def flat_numpy(tree) -> dict:
    """``{"a/b/c": leaf}`` of a JAX parameter tree, as the port names paths."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(k.key) for k in path): np.asarray(x) for path, x in flat}


@pytest.fixture(scope="module")
def jax_side():
    """Per arch, built once: the reference model, its PRNGKey(0) params and
    a float32 batch (tokens, or frame/patch embeddings for the stub
    frontends, and labels) drawn with numpy."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = j_reduced(j_get_config(arch))
            model = j_build_model(cfg)
            params = model.init_params(jax.random.PRNGKey(0))
            rs = np.random.RandomState(7)
            batch = {"labels": rs.randint(0, cfg.vocab, (B, S)).astype(np.int32)}
            if cfg.frontend != "none":
                batch["embeds"] = rs.standard_normal((B, S, cfg.d_model)).astype(np.float32)
            else:
                batch["tokens"] = rs.randint(0, cfg.vocab, (B, S)).astype(np.int32)
            cache[arch] = (cfg, model, params, batch)
        return cache[arch]

    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_reference(jax_side, arch):
    _, _, jparams, _ = jax_side(arch)
    model = build_model(reduced(get_config(arch)))
    got = tree_flatten_with_path(model.init_params(rng.PRNGKey(0, "cpu")))
    want = flat_numpy(jparams)
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k.endswith(("norm1", "norm2", "final_norm")) or "/b" in k:
            np.testing.assert_array_equal(g, w, err_msg=k)  # ones and zeros
        else:
            assert rel_err(g, w) <= INIT_TOL, k


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(jax_side, arch):
    jcfg, jmodel, jparams, batch = jax_side(arch)
    cfg = reduced(get_config(arch))
    model = build_model(cfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    want, _ = j_transformer.forward(jparams, jcfg, jbatch, remat=False)
    got, aux = transformer.forward(params, cfg, tbatch)
    assert got.dtype == torch.float32 and got.shape == (B, S, cfg.vocab)
    assert torch.isfinite(got).all() and float(aux) == 0.0
    assert rel_err(got.numpy(), want) <= FP32_TOL

    want_loss, want_m = jmodel.loss_fn(jparams, jbatch, remat=False)
    got_loss, got_m = model.loss_fn(params, tbatch)
    assert abs(float(got_loss) - float(want_loss)) <= FP32_TOL * abs(float(want_loss))
    assert abs(float(got_m["xent"]) - float(want_m["xent"])) <= FP32_TOL * abs(
        float(want_m["xent"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_structure(jax_side, arch):
    _, jmodel, jparams, _ = jax_side(arch)
    model = build_model(reduced(get_config(arch)))
    axes = model.param_axes()
    assert axes == jmodel.param_axes()
    flat_axes = jax.tree_util.tree_flatten_with_path(
        axes, is_leaf=lambda x: isinstance(x, tuple))[0]
    flat_axes = {"/".join(str(k.key) for k in path): a for path, a in flat_axes}
    params = tree_flatten_with_path(model.init_params(rng.PRNGKey(0, "cpu")))
    assert flat_axes.keys() == params.keys()
    for k, p in params.items():
        assert len(flat_axes[k]) == p.ndim, (k, p.shape, flat_axes[k])


@pytest.mark.parametrize("hk", [4, 2])
def test_flash_attention_with_a_wholly_masked_chunk(hk):
    """chunk 16, window 8, S 64: for queries at 16 and beyond the first KV
    chunk lies wholly outside the window (scores all NEG_INF)."""
    rs = np.random.RandomState(3)
    q = rs.standard_normal((2, 64, 4, 32)).astype(np.float32)
    k = rs.standard_normal((2, 64, hk, 32)).astype(np.float32)
    v = rs.standard_normal((2, 64, hk, 32)).astype(np.float32)
    pos = np.arange(64, dtype=np.int32)
    want = np.asarray(j_attn.flash_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                                             window=8, chunk=16))
    got = attention.flash_attention(*map(torch.from_numpy, (q, k, v, pos, pos)),
                                    window=8, chunk=16).numpy()
    assert np.isfinite(got).all()
    assert rel_err(got, want) <= 1e-5
    # the masked chunk takes no weight: the same as attending to the window alone
    full = attention.flash_attention(*map(torch.from_numpy, (q, k, v, pos, pos)), window=8,
                                     chunk=64).numpy()
    assert rel_err(got, full) <= 1e-5


def test_carry_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"embed": np.zeros((4, 2), np.float32)})


def test_normal_matches_jax_within_erfinv_rounding():
    """rng.normal is jax.random.normal's construction; torch's erfinv is
    not XLA's, so the draws agree to ~2e-5 (not bit for bit).  A draw made
    in chunks of the flat index (start=) equals the draw made at once."""
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (1 << 16,)))
    got = rng.normal(rng.PRNGKey(5, "cpu"), (1 << 16,))
    assert got.dtype == torch.float32
    assert float(np.abs(got.numpy() - want).max()) <= 3e-5
    parts = [rng.normal(rng.PRNGKey(5, "cpu"), (n,), start=s)
             for s, n in ((0, 1000), (1000, 30000), (31000, (1 << 16) - 31000))]
    assert torch.equal(torch.cat(parts), got)
    shaped = rng.normal(rng.PRNGKey(5, "cpu"), (256, 256))
    assert torch.equal(shaped.reshape(-1), got)


def test_decode_vs_full_forward_at_full_depth_is_the_references():
    """gemma3's 34 layers (at reduced width): the port's decode-against-full-
    forward error over the bf16 KV cache is the reference's own (the cache's
    rounding, amplified by depth; it passes 0.03 at full width on the card),
    and with a float32 cache the port's decode computes what its forward
    computes."""
    import dataclasses

    jcfg = dataclasses.replace(j_reduced(j_get_config("gemma3-4b")), n_layers=34)
    cfg = dataclasses.replace(reduced(get_config("gemma3-4b")), n_layers=34)
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    toks = np.random.RandomState(5).randint(0, cfg.vocab, (4, 32)).astype(np.int32)

    full, _ = j_transformer.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)}, remat=False)
    _, cache, n = jmodel.prefill_fn(jparams, {"tokens": jnp.asarray(toks[:, :31])}, max_len=33)
    dec, _ = jmodel.decode_fn(jparams, cache, jnp.asarray(toks[:, 31:]), n)
    want = rel_err(np.asarray(dec[:, 0]), np.asarray(full[:, 31]))

    t = torch.from_numpy(toks)
    full, _ = transformer.forward(params, cfg, {"tokens": t})
    got = {}
    for dtype in (torch.bfloat16, torch.float32):
        _, cache, n = transformer.prefill(params, cfg, {"tokens": t[:, :31]}, 33,
                                          cache_dtype=dtype)
        assert cache["k"].dtype == dtype
        dec, _ = transformer.decode_step(params, cfg, cache, t[:, 31:], n)
        got[dtype] = rel_err(dec[:, 0].numpy(), full[:, 31].numpy())
    assert abs(got[torch.bfloat16] - want) <= 1e-3, (got, want)
    assert got[torch.float32] <= 1e-4, got
