"""The port's microbatch accumulation on the CPU, in float32 at reduced
qwen1.5-4b on the reference test's batch: its own property (4
microbatches against the full batch, max|Δ params| < 5e-3, the
reference's ``test_microbatch_accumulation_matches_full_batch``), and its 4
microbatches against the reference's 4 under the float32 rule of
``test_torch_train_step.py`` (loss, ``grad_norm`` 1e-4, ``lr`` equal,
``m``/``v``/params held as there, ``m / (1 - b1)`` standing for the
accumulated gradient)."""
import numpy as np
import pytest
import torch

from repro_torch.train import make_train_step
from repro_torch.tree import tree_flatten_with_path
from train_parity import TOL, Ref, check_state, flat_numpy, make_batch, t_batch, t_tcfg

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

MB_TOL = 5e-3  # tests/test_train_substrate.py's


@pytest.fixture(scope="module")
def qwen_mb():
    """Reduced qwen1.5-4b on the reference test's batch (8 x 32, seed 2):
    the reference's float32 step with 4 microbatches, and the port's with 1
    and with 4."""
    ref = Ref("qwen1.5-4b")
    batch = make_batch(ref.cfg, 2, b=8, s=32)
    out = {"ref": ref, "ref4": ref.step(batch, microbatches=4)}
    for n in (1, 4):
        model, params, opt = ref.port()
        out[n] = make_train_step(model, t_tcfg(torch.float32, microbatches=n))(
            params, opt, t_batch(batch))
    return out


def test_microbatch_accumulation_matches_full_batch(qwen_mb):
    p1, p4 = (tree_flatten_with_path(qwen_mb[n][0]) for n in (1, 4))
    diff = max(float((p1[k] - p4[k]).abs().max()) for k in p1)
    assert diff < MB_TOL, diff
    assert set(qwen_mb[4][2]) == {"loss", "grad_norm", "lr"}  # no xent / aux, as the scan's


def test_microbatches_match_reference(qwen_mb):
    jp, jo, jm = qwen_mb["ref4"]
    tm = qwen_mb[4][2]
    assert set(tm) == set(jm)
    for k in ("loss", "grad_norm"):
        assert abs(float(tm[k]) - float(jm[k])) <= TOL * abs(float(jm[k])), k
    assert float(tm["lr"]) == float(jm["lr"])
    c1 = np.float32(1 - 0.9)
    acc = {k: v / c1 for k, v in flat_numpy(jo["m"]).items()}
    check_state("qwen1.5-4b, 4 microbatches", qwen_mb[4], qwen_mb["ref4"], acc,
                {k: TOL for k in acc})
