"""The port's serving path (repro_torch.train.make_serve_steps over
repro_torch.models, and repro_torch.launch.serve) against the reference's on
the CPU, for the six transformer archs at ``reduced()`` with the
reference's weights carried over: prefill, then three decode steps, logits
within 1e-4 in float32 and 3e-2 through the bfloat16 serve steps
(max|Δ| / max|ref|; matmuls round differently, and bfloat16 rounds at other
points), the bfloat16 KV cache within one bfloat16 step (2**-7) in float32
and 3e-2 in bfloat16, each decode step from the reference's cache; the
port's own decode against its full forward
(tests/test_models.py::test_decode_matches_full_forward); the serve CLI's
prompts bit-equal to JAX's, and the CLI on the CPU."""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import build_model as j_build_model
from repro.train import make_serve_steps as j_make_serve_steps
from repro_torch import rng
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve
from repro_torch.models import build_model, transformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import make_serve_steps

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

ARCHS = ["gemma3-4b", "gemma-7b", "mistral-nemo-12b", "qwen1.5-4b", "musicgen-large",
         "llava-next-mistral-7b"]
TOL = {"fp32": 1e-4, "bf16": 3e-2}
CACHE_TOL = {"fp32": 2.0**-7, "bf16": 3e-2}
B, P, GEN = 2, 80, 3  # prompt past reduced gemma3's 64-token window
MAX_LEN = P + GEN + 1


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def as_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


def run_serve(prefill, decode, params, toks, wrap, caches=None):
    """Prefill on the first P tokens, then GEN decode steps fed the next
    tokens.  Returns the logits of every step and the cache after every
    step, as float32 numpy.  ``caches`` (another run's caches, as numpy)
    makes each decode step start from that run's cache, so that a step is
    held against the reference from the same inputs: the cache is bfloat16,
    and a float32 K that rounds the other way at one element moves the
    next step's logits by more than the matmuls' own rounding."""
    logits, cache, clen = prefill(params, {"tokens": wrap(toks[:, :P])}, MAX_LEN)
    logits_out, cache_out = [as_np(logits)], [{k: as_np(v) for k, v in cache.items()}]
    for i, t in enumerate(range(P, P + GEN)):
        if caches is not None:
            cache = {k: wrap(v).to(cache[k].dtype) for k, v in caches[i].items()}
        logits, cache, clen = decode(params, cache, wrap(toks[:, t:t + 1]), clen)
        logits_out.append(as_np(logits))
        cache_out.append({k: as_np(v) for k, v in cache.items()})
    assert int(clen) == P + GEN
    return logits_out, cache_out


def fp32_steps(model):
    """The serve steps without the bfloat16 cast (the model's own prefill
    and decode), with decode returning cache_len + 1 as the serve step does."""
    def decode(params, cache, tokens, clen):
        return (*model.decode_fn(params, cache, tokens, clen), clen + 1)

    return model.prefill_fn, decode


@pytest.fixture(scope="module")
def jax_side():
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = j_reduced(j_get_config(arch))
            model = j_build_model(cfg)
            params = model.init_params(jax.random.PRNGKey(0))
            toks = np.random.RandomState(11).randint(0, cfg.vocab, (B, P + GEN)).astype(np.int32)
            jit = lambda pre, dec: (jax.jit(pre, static_argnums=2), jax.jit(dec))
            runs = {"fp32": run_serve(*jit(*fp32_steps(model)), params, toks, jnp.asarray),
                    "bf16": run_serve(*jit(*j_make_serve_steps(model)), params, toks,
                                      jnp.asarray)}
            cache[arch] = (jax.tree.map(np.asarray, params), toks, runs)
        return cache[arch]

    return get


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(jax_side, arch, mode):
    np_params, toks, runs = jax_side(arch)
    model = build_model(reduced(get_config(arch)))
    params = params_from_numpy(np_params, "cpu")
    steps = fp32_steps(model) if mode == "fp32" else make_serve_steps(model)
    want_logits, want_caches = runs[mode]
    got_logits, got_caches = run_serve(*steps, params, toks, torch.from_numpy, want_caches)
    for i, (g, w) in enumerate(zip(got_logits, want_logits)):
        assert g.shape == w.shape and np.isfinite(g).all()
        assert rel_err(g, w) <= TOL[mode], f"step {i}: {rel_err(g, w)}"
    for i, (g, w) in enumerate(zip(got_caches, want_caches)):
        for k in ("k", "v"):
            assert g[k].shape == w[k].shape
            assert rel_err(g[k], w[k]) <= CACHE_TOL[mode], f"step {i}: cache {k}"


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """The reference test's property on the port: the decode step's logits
    at position 15 against the full forward's (rel < 0.03)."""
    cfg = reduced(get_config(arch))
    m = build_model(cfg)
    params = m.init_params(rng.PRNGKey(0, "cpu"))
    toks = rng.randint(rng.PRNGKey(0, "cpu"), (2, 16), 0, cfg.vocab)
    full, _ = transformer.forward(params, cfg, {"tokens": toks})
    _, cache, clen = m.prefill_fn(params, {"tokens": toks[:, :15]}, max_len=20)
    ld, new_cache = m.decode_fn(params, cache, toks[:, 15:16], clen)
    ref, got = full[:, 15], ld[:, 0]
    rel = float((ref - got).abs().max() / ((ref).abs().max() + 1e-9))
    assert rel < 0.03, f"{arch}: rel err {rel}"
    assert not torch.equal(new_cache["k"], cache["k"])  # decode wrote position 15
    assert torch.equal(new_cache["k"][:, :, :15], cache["k"][:, :, :15])


@pytest.mark.parametrize("vocab", [512, 65536, 65537, 262144])
def test_serve_prompts_bit_equal(vocab):
    """launch/serve's prompts, randint(PRNGKey(1), (4, 32), 0, vocab), above
    2**16 too (JAX's wrapping multiplier)."""
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 32), 0, vocab))
    got = rng.randint(rng.PRNGKey(1, "cpu"), (4, 32), 0, vocab)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_serve_cli_runs_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run = serve.main(["--arch", "gemma3-4b", "--reduced", "--batch", "2", "--prompt-len",
                          "8", "--gen", "4", "--device", "cpu"])
    lines = out.getvalue().splitlines()
    assert len(lines) == 3
    assert lines[0].startswith("prefill 2x8: ") and lines[0].endswith("ms")
    assert lines[1].startswith("decode 3 steps: ") and "tok/s" in lines[1]
    gen = run["tokens"]
    assert lines[2] == f"sample: {gen[0][:12].tolist()}"
    assert gen.shape == (2, 4) and int(gen.min()) >= 0 and int(gen.max()) < 512
    np.testing.assert_array_equal(run["prompts"].numpy(), np.asarray(
        jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0, 512)))
