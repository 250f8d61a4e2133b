"""The port's serving path for the MoE, RWKV6 and Zamba2 families
(repro_torch.train.make_serve_steps over repro_torch.models) against the
reference's on the CPU, at ``reduced()`` with the reference's weights
carried over: prefill, then three decode steps, each decode step from the
reference's state.  Through the models' own float32 steps: logits and
every state leaf by its dtype (``tests/serve_parity.py``), and every MoE
call's routing ids and kept assignments equal.  Through the bfloat16 serve
steps: logits and state blocks within 3e-2, with routing flips and the
reference's own bf16 excursions found, not absorbed
(``serve_parity.assert_bf16_close``).  And the serve CLI on the CPU for
each family."""
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
from repro.models import mlp as j_mlp
from repro.train import make_serve_steps as j_make_serve_steps
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import make_serve_steps
from moe_parity import recording_moe_local
from serve_parity import (assert_bf16_close, assert_serve_close, fp32_steps, port_routing,
                          routing_divergence, run_serve)

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

ARCHS = ["phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b", "rwkv6-1.6b", "zamba2-7b"]
B, P, GEN = 2, 64, 3  # P: whole chunks of RWKV's 16 and the SSD's 32
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
            runs, routing = {}, {}
            for mode, steps in (("fp32", fp32_steps(model)), ("bf16", j_make_serve_steps(model))):
                routing[mode] = []
                with pytest.MonkeyPatch.context() as mp:
                    mp.setattr(j_mlp, "_moe_local", recording_moe_local(routing[mode]))
                    runs[mode] = run_serve(*jit(*steps), params, toks, jnp.asarray, P, MAX_LEN)
            cache[arch] = (jax.tree.map(np.asarray, params), toks, runs, routing)
        return cache[arch]

    return get


@pytest.mark.parametrize("mode", ["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(jax_side, arch, mode):
    np_params, toks, runs, routing = jax_side(arch)
    cfg = reduced(get_config(arch))
    model = build_model(cfg)
    params = params_from_numpy(np_params, "cpu")
    steps = fp32_steps(model) if mode == "fp32" else make_serve_steps(model)
    calls = []
    with port_routing(calls):
        got = run_serve(*steps, params, toks, torch.from_numpy, P, MAX_LEN,
                        states=runs[mode][1])
    n_calls = cfg.n_layers * (1 + GEN) if cfg.n_experts else 0
    assert len(calls) == len(routing[mode]) == n_calls
    if mode == "fp32":
        for (_, gi, gk), (_, wi, wk) in zip(calls, routing[mode]):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gk, wk)
        assert_serve_close(got, runs[mode], mode)
    else:
        diverged = routing_divergence(calls, routing[mode], cfg.n_layers, B) if calls else None
        res = assert_bf16_close(got, runs[mode], runs["fp32"], diverged)
        print(f"{arch} bf16: held {res['held']}; diverged rows {diverged}; "
              f"found {res['found']}")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_on_the_cpu(arch):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run = serve.main(["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "16",
                          "--gen", "4", "--device", "cpu"])
    lines = out.getvalue().splitlines()
    assert len(lines) == 3
    assert lines[0].startswith("prefill 2x16: ") and lines[0].endswith("ms")
    assert lines[1].startswith("decode 3 steps: ") and "tok/s" in lines[1]
    gen = run["tokens"]
    assert lines[2] == f"sample: {gen[0][:12].tolist()}"
    assert gen.shape == (2, 4) and int(gen.min()) >= 0 and int(gen.max()) < 512
