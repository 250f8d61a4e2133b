#!/usr/bin/env python3
"""The control of ``correct``: a cell run with the plain reference put in
the program's place, its congestion-control state (float32 in the
configuration) kept in bfloat16, at the cell's own rows; the benchmark's
usual comparison then has to come out as not correct.

    python3 portbench/control.py --workload fig06_ft128.rows3072 --seeds 11,12,13 --seconds 10

Prints one JSON line per seed with the compared numbers; exits 1 if any
seed's control came out correct.  The benchmark's own runs never run it.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def control_program(dtype):
    """A program builder for ``harness.run_cell``: every row of the batch,
    stepped by the reference with its congestion state in ``dtype``."""
    from portbench import reference

    return lambda fabric, batch, device: reference.Rows(
        fabric, batch, range(len(batch.rows)), device, cc_dtype=dtype)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    if args.device == "cuda" and not torch.cuda.is_available():
        print("portbench control: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    came_out_correct = 0
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.run_cell(cell, seed, args.seconds, False, args.device, time.perf_counter(),
                               program=control_program(torch.bfloat16))
        out = harness.result(run)
        came_out_correct += bool(out["correct"])
        print(json.dumps({"seed": seed, "correct": out["correct"], "ticks": run.ticks,
                          "rows_compared": run.attempted, "rows_failed": run.failed,
                          "checks": out["checks"]}), flush=True)
    return 1 if came_out_correct else 0


if __name__ == "__main__":
    sys.exit(main())
