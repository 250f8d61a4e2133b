"""The recurrent presets (rwkv6-1.6b, zamba2-7b): the reduced train step's FLOPs, remat on and off, as
``repro_torch.launch.op_cost`` counts them, equal the reference's
``analyze_hlo`` less the gaps named in ``tests/op_cost_parity.py``."""
import pytest

from op_cost_parity import check_train_step_flops


@pytest.mark.parametrize("arch", ['rwkv6-1.6b', 'zamba2-7b'])
def test_train_step_flops_match_reference(arch):
    check_train_step_flops(arch)
