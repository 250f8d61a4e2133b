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
prompts bit-equal to JAX's, and the CLI on the CPU.  The run and the rule
are ``tests/serve_parity.py``'s."""
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
from serve_parity import assert_serve_close, fp32_steps, run_serve

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

ARCHS = ["gemma3-4b", "gemma-7b", "mistral-nemo-12b", "qwen1.5-4b", "musicgen-large",
         "llava-next-mistral-7b"]
B, P, GEN = 2, 80, 3  # prompt past reduced gemma3's 64-token window
MAX_LEN = P + GEN + 1


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
            runs = {mode: run_serve(*jit(*steps), params, toks, jnp.asarray, P, MAX_LEN)
                    for mode, steps in (("fp32", fp32_steps(model)),
                                        ("bf16", j_make_serve_steps(model)))}
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
    got = run_serve(*steps, params, toks, torch.from_numpy, P, MAX_LEN, states=runs[mode][1])
    assert_serve_close(got, runs[mode], mode)


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
