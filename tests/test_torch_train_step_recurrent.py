"""The port's float32 train step against the reference's for the
recurrent families at ``reduced()``, rwkv6-1.6b and zamba2-7b: the rule
and the checks of ``test_torch_train_step.py`` (``train_parity``).  RWKV6's
random-init stack is where the reference's own gradient moves by ~1e-4
when its weights move by one ulp, so its gradient bounds are that
distance's double."""
import pytest
import torch

from train_parity import check_loss_and_gradients, check_one_step_state, float32_run

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

ARCHS = ["rwkv6-1.6b", "zamba2-7b"]


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
