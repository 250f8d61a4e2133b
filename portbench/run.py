#!/usr/bin/env python3
"""The port's benchmark: one run of one cell on one card.

    python3 portbench/run.py --workload fig06_ft128.rows3072 --seed 7 --seconds 40 --trace 0

The cell is named in ``BENCHMARK.json``; its configuration, traffic and
run parameters are files under ``portbench/`` (``harness.load_cell``).
With ``--trace 0`` the last line of standard output carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics from a
profiled sub-window; both check the timed path's rows against the plain
reference (``portbench/reference``) and print each compared number with
its limit as the last lines of standard error.  The run exits non-zero and
prints no result without enough CUDA devices, or when JAX or the JAX
package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}  # top-level module names, compared whole


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        print(f"portbench: {args.workload} needs {entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    from repro_torch.kernels import build

    build.library()  # built once per checkout under build/repro_torch/, then loaded
    cell = harness.load_cell(args.workload, bench)
    run = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START,
                           log=lambda m: print(m, file=sys.stderr))
    out = harness.result(run)
    found = sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    info = {"ticks": run.ticks, "row_ticks": run.row_ticks, "window_s": run.window_s,
            "batches_done": run.batches_done, "verify_s": run.verify_s,
            "init_rows_s": run.init_rows_s, "setup_s": run.setup_s}
    if run.prof is not None:
        info["profiled"] = {k: run.prof[k] for k in (
            "ticks", "n_events", "busy_s", "window_s", "unprofiled_s_per_tick", "op_bytes",
            "op_time_s", "counter_delta",
            "mismatch")}
        info["launches_per_tick_by_name"] = {
            k: v / run.prof["ticks"] for k, v in sorted(run.prof["launches_by_name"].items())}
    print("run " + json.dumps(info), file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
