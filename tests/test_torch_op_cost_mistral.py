"""The Mistral-based and MusicGen presets (llava-next-mistral-7b, mistral-nemo-12b, musicgen-large): the reduced train step's FLOPs, remat on and off, as
``repro_torch.launch.op_cost`` counts them, equal the reference's
``analyze_hlo`` less the gaps named in ``tests/op_cost_parity.py``."""
import pytest

from op_cost_parity import check_train_step_flops


@pytest.mark.parametrize("arch", ['llava-next-mistral-7b', 'mistral-nemo-12b', 'musicgen-large'])
def test_train_step_flops_match_reference(arch):
    check_train_step_flops(arch)
