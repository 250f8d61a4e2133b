"""The port's train step against the reference's on the CPU in bfloat16
compute (the launcher's default), from the same ``init_train_state
(PRNGKey(0))`` and numpy batch at ``reduced()``, five families: loss and
``grad_norm`` within 3e-2 (max|Δ| / max|ref|).  At step 1 AdamW moves
each parameter by ~±lr whatever its gradient's size, so where bf16
rounding flips the sign of a tiny gradient the update takes the other
sign: such elements are counted and logged, not held.  phi3.5-moe's
routing is recorded on both sides; a bf16 routing flip (a near tie on one
side, ``serve_parity.routing_divergence``) is found and named.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mlp as j_mlp
from repro_torch.train import make_train_step
from repro_torch.tree import tree_flatten_with_path
from moe_parity import recording_moe_local
from serve_parity import port_routing, routing_divergence
from train_parity import B, Ref, flat_numpy, make_batch, t_batch, t_tcfg

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

ARCHS = ["qwen1.5-4b", "phi3.5-moe-42b-a6.6b", "musicgen-large", "rwkv6-1.6b", "zamba2-7b"]
BF16_TOL = 3e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_step_matches_reference(arch):
    ref = Ref(arch)
    batch = make_batch(ref.cfg, 5)
    moe = ref.cfg.n_experts > 0
    want_routing, got_routing = [], []
    orig = j_mlp._moe_local
    if moe:
        j_mlp._moe_local = recording_moe_local(want_routing)
    try:
        jp, _, jm = ref.step(batch, jnp.bfloat16)
        jax.effects_barrier()
    finally:
        j_mlp._moe_local = orig
    model, params, opt = ref.port()
    before = {k: v.clone() for k, v in tree_flatten_with_path(params).items()}
    with port_routing(got_routing):
        tp, _, tm = make_train_step(model, t_tcfg(torch.bfloat16, remat=False))(
            params, opt, t_batch(batch))
    for k in ("loss", "grad_norm"):
        assert np.isfinite(float(tm[k]))
        assert abs(float(tm[k]) - float(jm[k])) <= BF16_TOL * abs(float(jm[k])), k
    assert float(tm["lr"]) == float(jm["lr"])
    got, want = tree_flatten_with_path(tp), flat_numpy(jp)
    flips, n = {}, 0
    for k, w in want.items():
        d_got = np.sign(got[k].numpy() - before[k].numpy())
        d_want = np.sign(w - before[k].numpy())
        n += w.size
        if (d_got != d_want).any():
            flips[k] = int((d_got != d_want).sum())
    found = []
    if moe:
        n_layers = ref.cfg.n_layers
        assert len(want_routing) == n_layers
        found = routing_divergence(got_routing[:n_layers], want_routing, n_layers, B)[0]
    print(f"{arch} bf16: loss {float(tm['loss']):.5f} (reference {float(jm['loss']):.5f}), "
          f"grad_norm {float(tm['grad_norm']):.5f} ({float(jm['grad_norm']):.5f}); step-1 "
          f"updates of the other sign: {sum(flips.values())} of {n} ({flips}); routing flips "
          f"found, not held ({{row: layer}}): {found}")
