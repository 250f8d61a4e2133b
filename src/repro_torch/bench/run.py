"""Run the port's figure grids and write their rows to the port's BENCH file.

    python -m repro_torch.bench.run --only fig06                  # on the card
    python -m repro_torch.bench.run --only fig02,fig06 --smoke --device cpu
    python -m repro_torch.bench.run --only fig06 --full            # paper scale
    python -m repro_torch.bench.run --only scale --scale-conns 1000000 --scale-ticks 1000
    python -m repro_torch.bench.run --only bins --full             # fig13/14, fig16, fig17
    python -m repro_torch.bench.run --only fig18 --full            # one Simulator per cell
    python -m repro_torch.bench.run --only reps_channels           # ft/'s channel scheduler
    python -m repro_torch.bench.run --only fig06 --trace 256       # with the flight recorder

Prints ``name,us_per_call,derived`` CSV rows and merges them into
``build/repro_torch/BENCH_torch.json`` (``--out`` to write elsewhere): the
rows of the figures run replace their earlier rows, the other figures'
rows are kept.  It never writes the reference's
``benchmarks/BENCH_netsim.json``.  ``--full``, ``--smoke``, ``--seeds``,
``--collect`` and ``--trace`` default to the reference's BENCH_FULL,
BENCH_SMOKE, BENCH_SEEDS, BENCH_COLLECT and BENCH_TRACE.  ``--trace N``
folds the flight recorder, an N-slot ring per row, into every summary-mode
figure grid; it only observes, so the rows' metrics are those of the
untraced run, and every row is stamped with its ``trace``.  The file's
``meta`` takes ``full_scale``, ``smoke``, ``seeds``, ``collect`` and
``trace`` from the merged rows (``"mixed"`` where they differ) and lists
the figures' ``sweep_totals`` and the ``failed`` modules: a module that
raises prints ``<module>,0,ERROR=<repr>``, the others still run, the file
is written and the process exits 1.  The scale modules (``scale_smoke``: one
scale-mode sweep row; ``table1_footprint``: REPS's per-connection bytes)
run only when ``--only`` names them; ``--scale-conns`` / ``--scale-ticks``
(BENCH_SCALE_CONNS, BENCH_SCALE_TICKS; default 10**5 and 300) size them,
and ``--scale-conn-devices N`` (BENCH_SCALE_CONN_DEVICES, default 1) splits
the scale row's connection axis over N ranks of the backend
``--scale-backend`` names.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import platform
import time
import traceback

from repro_torch.bench import common

MODULES = [  # the reference's order (benchmarks/run.py); bins holds its fig13, fig16, fig17
    "bins",
    "fig01_tornado_micro",
    "fig03_asym_micro",
    "fig05_background",
    "fig06_failures_micro",
    "fig09_fpga_analogue",
    "fig15_forced_freezing",
    "fig18_three_tier",
    "fig11_ack_coalescing",
    "fig12_evs_cc",
    "fig04_asym_macro",
    "fig07_failures_macro",
    "fig08_extreme",
    "fig19_incremental",
    "fig02_symmetric",
    "arena",
    "reps_channels_bench",
]
SCALE_MODULES = ["scale_smoke", "table1_footprint"]  # run only when --only names them


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default=os.environ.get("BENCH_ONLY", ""),
                    help="comma-separated figure prefixes (default: every grid figure)")
    ap.add_argument("--full", action="store_true", default=common.full_scale(),
                    help="paper scale (FATTREE_128's fabric, MiB messages)")
    ap.add_argument("--smoke", action="store_true", default=common.smoke(),
                    help="each figure's CI subset")
    ap.add_argument("--seeds", type=int, default=common.n_seeds(), help="seeds per cell")
    ap.add_argument("--collect", choices=common.COLLECTS, default=common.default_collect())
    ap.add_argument("--trace", type=int, default=int(os.environ.get("BENCH_TRACE", "0")),
                    help="flight-recorder ring of summary-mode figure grids (0 = off)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--out", default=common.bench_path(), help="the BENCH file to merge into")
    ap.add_argument("--scale-conns", type=int,
                    default=int(os.environ.get("BENCH_SCALE_CONNS", "100000")),
                    help="connections of the scale modules' row")
    ap.add_argument("--scale-ticks", type=int,
                    default=int(os.environ.get("BENCH_SCALE_TICKS", "300")),
                    help="ticks of the scale row")
    ap.add_argument("--scale-conn-devices", type=int,
                    default=int(os.environ.get("BENCH_SCALE_CONN_DEVICES", "1")),
                    help="ranks the scale row's connection axis is split over")
    ap.add_argument("--scale-backend", choices=("gloo", "nccl"), default=None,
                    help="the backend of those ranks (gloo for ranks sharing a card)")
    args = ap.parse_args(argv)
    if args.scale_conn_devices > 1 and args.scale_backend is None:
        ap.error("--scale-conn-devices > 1 needs --scale-backend gloo or nccl")
    if args.seeds < 1:
        ap.error(f"--seeds must be >= 1, got {args.seeds}")
    if args.trace < 0:
        ap.error(f"--trace must be >= 0, got {args.trace}")
    os.environ["BENCH_SEEDS"] = str(args.seeds)  # sweep_case's seed axis
    os.environ["BENCH_TRACE"] = str(args.trace)  # run_sweep's flight recorder
    keys = [k.strip() for k in args.only.split(",") if k.strip()]
    selected = [m for m in MODULES if not keys or any(m.startswith(k) for k in keys)]
    selected += [m for m in SCALE_MODULES if any(m.startswith(k) for k in keys)]
    if not selected:
        ap.error(f"--only {args.only!r} selects no module of {MODULES + SCALE_MODULES}")

    if args.device in (None, "cuda"):
        from repro_torch.kernels import build

        build.library()  # build (or load) the kernels before any bucket is timed
    rows = common.Rows(full_scale=args.full, smoke=args.smoke, seeds=args.seeds,
                       collect=args.collect, trace=args.trace, device=args.device or "cuda")
    print("name,us_per_call,derived")
    t0 = time.time()
    failed = []
    for name in selected:
        mod = importlib.import_module(f"repro_torch.bench.{name}")
        n_before = len(rows.records)
        try:
            if name in SCALE_MODULES:
                mod.main(rows, conns=args.scale_conns, ticks=args.scale_ticks, device=args.device,
                         conn_devices=args.scale_conn_devices, backend=args.scale_backend)
            else:
                mod.main(rows, full=args.full, smoke=args.smoke, collect=args.collect,
                         device=args.device)
        except Exception as e:  # noqa: BLE001 - the run goes on and exits 1, as the reference's
            del rows.rows[n_before:], rows.records[n_before:]  # a failed module leaves no rows
            failed.append(name)
            traceback.print_exc()
            print(f"{name},0,ERROR={e!r}", flush=True)
    wall = time.time() - t0
    print(f"# total_wall_s={wall:.0f} failed={len(failed)}")
    records = {r["name"]: {k: v for k, v in r.items() if k != "name"} for r in rows.records}

    prev = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            prev = json.load(f)
    # a figure run again replaces all its rows (its bucket rows may differ)
    ran = {n.split("/")[0] for n in records}
    kept = {k: v for k, v in prev.get("rows", {}).items() if k.split("/")[0] not in ran}
    merged = {**kept, **records}

    def consensus(key, default):
        # a row without the stamp counts as its own value, so that a merged
        # file of unstamped and stamped rows reads "mixed"
        vals = {rec.get(key) for rec in merged.values()}
        if len(vals) != 1:
            return "mixed"
        v = vals.pop()
        return default if v is None else v

    payload = {
        "meta": {
            "full_scale": consensus("full_scale", args.full),
            "smoke": consensus("smoke", args.smoke),
            "seeds": consensus("seeds", args.seeds),
            "collect": consensus("collect", args.collect),
            "trace": consensus("trace", args.trace),
            "modules": sorted(set(prev.get("meta", {}).get("modules", [])) | set(selected)),
            "sweep_totals": sorted(k for k in merged if k.endswith("/sweep_total")),
            "failed": failed,
            "total_wall_s": wall,
            "platform": platform.platform(),
            "python": platform.python_version(),
        },
        "rows": merged,
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
    print(f"# wrote {args.out} ({len(payload['rows'])} rows) in {wall:.1f} s")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
