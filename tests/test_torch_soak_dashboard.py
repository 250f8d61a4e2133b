"""The port's soak dashboard (``repro_torch.bench.soak_dashboard``) against
the reference's ``benchmarks/soak_dashboard.py``: the plain frames, printed
from ``SoakRunner.inspect`` chunk by chunk with the flight recorder on and a
spine injected, equal the reference CLI's byte for byte."""
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def _cli(module: str, *args: str) -> subprocess.CompletedProcess:
    # one thread per process: the suite's parallel workers share the host's cores
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}{os.pathsep}{REPO}", JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")
    return subprocess.run([sys.executable, "-m", module, "--plain", "--ticks", "80",
                           "--chunk", "40", "--trace", "256", "--inject-spine", "1", *args],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def test_dashboard_frames_equal_reference(tmp_path):
    port = _cli("repro_torch.bench.soak_dashboard", "--ckpt", str(tmp_path / "p"),
                "--device", "cpu")
    assert port.returncode == 0, port.stderr
    ref = _cli("benchmarks.soak_dashboard", "--ckpt", str(tmp_path / "r"))
    assert ref.returncode == 0, ref.stderr
    strip = lambda out, ck: out.replace(str(tmp_path / ck), "CKPT")
    assert strip(port.stdout, "p") == strip(ref.stdout, "r")
    frames = port.stdout.split("-" * 72)
    assert len(frames) == 5  # a frame per chunk to the AllReduce block's 160, then the tail
    assert "injections=1" in frames[-2] and "flight:" in frames[-2]
    assert "first drop t" in port.stdout
