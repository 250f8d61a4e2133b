"""The port's training launcher (``python -m repro_torch.launch.train``) on
the CPU: the CLI at ``--reduced --device cpu`` against the reference's CLI
(the printed lines' loss and grad norm within the bfloat16 rule's 3e-2); a
run checkpointed at step 5 and resumed equal, bit for bit, to an
uninterrupted 10-step run (params and optimizer state); the watchdog's
line; no ``--device``: raises where there is no GPU."""
import functools
import re
import sys

import pytest
import torch

from repro_torch.ft import StepWatchdog
from repro_torch.launch import train
from repro_torch.tree import tree_flatten_with_path

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

REF_ARGS = ["--reduced", "--batch", "4", "--seq", "32"]
ARGS = REF_ARGS + ["--device", "cpu"]
LINE = re.compile(r"step +(\d+) loss=([-\d.]+) gnorm=([-\d.]+) lr=([-\d.e+]+)")


def lines(out: str) -> dict:
    return {int(m[1]): (float(m[2]), float(m[3]), m[4]) for m in LINE.finditer(out)}


def test_cli_matches_reference_cli(capsys, monkeypatch):
    from repro.launch import train as j_train

    run = train.main(ARGS + ["--steps", "6"])
    got = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["train"] + REF_ARGS + ["--steps", "6"])
    j_train.main()
    want = capsys.readouterr().out
    g, w = lines(got), lines(want)
    assert sorted(g) == sorted(w) == [0, 5]
    for i in w:
        assert abs(g[i][0] - w[i][0]) <= 3e-2 * w[i][0] and abs(g[i][1] - w[i][1]) <= 3e-2 * w[i][1]
        assert g[i][2] == w[i][2]  # the printed rate
    assert got.splitlines()[-1] == want.splitlines()[-1]  # the Markov chain's entropy floor
    assert len(run["losses"]) == len(run["step_s"]) == 6 and run["start"] == 0
    assert all(map(torch.isfinite, map(torch.tensor, run["losses"])))


def test_resume_equals_uninterrupted_run(tmp_path, capsys):
    whole = train.main(ARGS + ["--steps", "10", "--ckpt-every", "5",
                               "--ckpt-dir", str(tmp_path / "a")])
    train.main(ARGS + ["--steps", "5", "--ckpt-every", "5", "--ckpt-dir", str(tmp_path / "b")])
    resumed = train.main(ARGS + ["--steps", "10", "--ckpt-every", "5",
                                 "--ckpt-dir", str(tmp_path / "b"), "--resume"])
    assert f"resumed from {tmp_path / 'b' / 'step_5'} at step 5" in capsys.readouterr().out
    assert resumed["start"] == 5 and resumed["losses"] == whole["losses"][5:]
    for name in ("params", "opt"):
        a, b = tree_flatten_with_path(whole[name]), tree_flatten_with_path(resumed[name])
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), (name, k)
    assert int(resumed["opt"]["step"]) == 10
    assert sorted(p.name for p in (tmp_path / "b").iterdir()) == ["step_10", "step_5"]


def test_watchdog_line(capsys, monkeypatch):
    # factor 0: every step is slower than 0 x the average, so the third
    # straggling step in a row (step 2) triggers
    monkeypatch.setattr(train, "StepWatchdog", functools.partial(StepWatchdog, factor=0.0))
    train.main(ARGS + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "step 2: WATCHDOG straggling steps detected" in out
    assert "step 1: WATCHDOG" not in out


def test_device_omitted_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--reduced", "--steps", "1"])
