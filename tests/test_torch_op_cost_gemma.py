"""The Gemma and Qwen presets (gemma-7b, gemma3-4b, qwen1.5-4b): the reduced train step's FLOPs, remat on and off, as
``repro_torch.launch.op_cost`` counts them, equal the reference's
``analyze_hlo`` less the gaps named in ``tests/op_cost_parity.py``."""
import pytest

from op_cost_parity import check_train_step_flops


@pytest.mark.parametrize("arch", ['gemma-7b', 'gemma3-4b', 'qwen1.5-4b'])
def test_train_step_flops_match_reference(arch):
    check_train_step_flops(arch)
