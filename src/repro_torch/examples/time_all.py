"""Time the five examples at full length, each in its own process as a user
runs it (``python -m repro_torch.examples.<name>``), and the bench runner's
fig06 grid untraced and with ``--trace 64``; prints the card's name and
power limit (``nvidia-smi``), then one line per command with its exit code
and wall seconds, the process's start-up and the kernels' build included.

    PYTHONPATH=src python -m repro_torch.examples.time_all [--device cpu] [--logs DIR]

Each command's output goes to ``DIR/<name>.log`` (a temporary directory by
default, removed at the end).  Exits 1 if a command failed.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

EXAMPLES = ("quickstart", "failover_demo", "paper_figures", "serve_batched", "train_lm")


def commands(device, out_dir: str) -> dict:
    """``{name: argv}`` of every timed command."""
    dev = [] if device is None else ["--device", str(device)]
    cmds = {n: [sys.executable, "-m", f"repro_torch.examples.{n}", *dev] for n in EXAMPLES}
    for trace in (0, 64):
        cmds[f"bench_fig06_trace{trace}"] = [
            sys.executable, "-m", "repro_torch.bench.run", "--only", "fig06", "--trace",
            str(trace), "--out", os.path.join(out_dir, f"bench_fig06_trace{trace}.json"), *dev]
    return cmds


def main(device=None, logs: str | None = None) -> dict:
    """Run and time every command; returns ``{name: (exit code, seconds)}``."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p)}
    if device in (None, "cuda"):
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
    out = {}
    with tempfile.TemporaryDirectory(prefix="repro_torch_time_all_") as tmp:
        log_dir = logs or tmp
        os.makedirs(log_dir, exist_ok=True)
        for name, argv in commands(device, tmp).items():
            with open(os.path.join(log_dir, f"{name}.log"), "w") as log:
                t0 = time.perf_counter()
                rc = subprocess.run(argv, stdout=log, stderr=subprocess.STDOUT, env=env).returncode
                out[name] = (rc, time.perf_counter() - t0)
            print(f"{name}: exit {rc}, {out[name][1]:.3f} s", flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--logs", default=None, help="keep each command's output here")
    args = ap.parse_args()
    sys.exit(1 if any(rc for rc, _ in main(args.device, args.logs).values()) else 0)
