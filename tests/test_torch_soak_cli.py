"""``python -m repro_torch.bench.soak_fig07 --inject-spine`` against the
reference CLI (``benchmarks/soak_fig07.py``): the spine is injected where
the cursor stands on ``--inject-at``, a chunk boundary, and nowhere else, so
both CLIs write the same record byte for byte, with the injection and
without it."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _cli(module: str, *args: str) -> subprocess.CompletedProcess:
    # one thread per process: the suite's parallel workers share the host's cores
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}{os.pathsep}{REPO}", JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    return subprocess.run([sys.executable, "-m", module, "--ticks", "120", "--chunk", "60",
                           *args], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("inject_at, injected", [(60, True), (30, False)])
def test_inject_spine_record_equals_reference(tmp_path, inject_at, injected):
    """At a boundary (60) the spine goes in at that tick; off the chunk grid
    (30) the cursor never stands there and nothing is injected."""
    inj = ["--inject-spine", "1", "--inject-at", str(inject_at)]
    port, ref = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    r = _cli("repro_torch.bench.soak_fig07", "--ckpt", str(tmp_path / "cp"), "--device", "cpu",
             "--out", port, *inj)
    assert r.returncode == 0, r.stderr
    r = _cli("benchmarks.soak_fig07", "--ckpt", str(tmp_path / "cr"), "--out", ref, *inj)
    assert r.returncode == 0, r.stderr
    text = open(port).read()
    assert text == open(ref).read()
    rec = json.loads(text)
    assert rec["cursor"] == 240
    assert [i["at_tick"] for i in rec["injections"]] == ([inject_at] if injected else [])
