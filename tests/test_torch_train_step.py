"""The port's float32 train step (repro_torch.train.make_train_step) against
the reference's (repro.train.make_train_step, jitted) on the CPU, one step
from the same ``init_train_state(PRNGKey(0))`` and the same numpy batch,
for the five families at ``reduced()``: here qwen1.5-4b (dense, qkv
biases), phi3.5-moe (MoE) and musicgen-large (the ``embeds`` stub);
rwkv6-1.6b and zamba2-7b in ``test_torch_train_step_recurrent.py``.  The
port runs with remat on (its default), the reference with remat off:
checkpointing changes no value.

The parity rule, max|Δ| / max|ref| per leaf:

* loss, ``xent``, ``aux`` and ``grad_norm`` within 1e-4; ``lr`` equal;
  MoE routing ids and kept assignments equal.
* Every gradient leaf within 1e-4, or, where the reference's own gradient
  moves farther than that when its parameters move by one ulp (its
  conditioning, measured here: RWKV6's random-init stack turns a 1-ulp
  change of the weights into ~1e-4 of its gradients), within twice that
  distance.  ``m`` is held like the gradient, ``v`` (quadratic in it) to
  twice the gradient's bound.
* Every parameter leaf within 1e-4, except the elements whose reference
  gradient is below 1e-3 of the leaf's largest: the first AdamW step moves
  a parameter by ``lr * g / (|g| + eps)`` (plus the decay), whose slope
  ``eps / (|g| + eps)**2`` turns a gradient difference far inside the
  gradient's bound into an update difference of order one there (a
  zero-initialised bias has many such elements).  They are counted and
  logged, not held.
"""
import numpy as np
import pytest
import torch

from train_parity import check_loss_and_gradients, check_one_step_state, float32_run

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

ARCHS = ["qwen1.5-4b", "phi3.5-moe-42b-a6.6b", "musicgen-large"]


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = float32_run(arch)
        return cache[arch]

    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(runs, arch):
    check_loss_and_gradients(runs(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_state_matches_reference(runs, arch):
    check_one_step_state(runs(arch))


def test_moe_routing_equal_in_float32(runs):
    r = runs("phi3.5-moe-42b-a6.6b")
    n_layers = r["ref"].cfg.n_layers
    want, got = r["routing"][:n_layers], r["port_routing"][:n_layers]  # the forwards' calls
    assert len(want) == len(got) == n_layers
    for (_, gi, gk), (_, wi, wk) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gk, wk)
