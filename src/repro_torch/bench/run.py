"""Run the port's figure grids and write their rows to the port's BENCH file.

    python -m repro_torch.bench.run --only fig06                  # on the card
    python -m repro_torch.bench.run --only fig02,fig06 --smoke --device cpu
    python -m repro_torch.bench.run --only fig06 --full            # paper scale
    python -m repro_torch.bench.run --only scale --scale-conns 1000000 --scale-ticks 1000
    python -m repro_torch.bench.run --only bins --full             # fig13/14, fig16, fig17

Prints ``name,us_per_call,derived`` CSV rows and merges them into
``build/repro_torch/BENCH_torch.json`` (``--out`` to write elsewhere): the
rows of the figures run replace their earlier rows, the other figures'
rows are kept.  It never writes the reference's
``benchmarks/BENCH_netsim.json``.  ``--full``, ``--smoke``, ``--seeds`` and
``--collect`` default to the reference's BENCH_FULL, BENCH_SMOKE,
BENCH_SEEDS and BENCH_COLLECT.  The scale modules (``scale_smoke``: one
scale-mode sweep row; ``table1_footprint``: REPS's per-connection bytes)
run only when ``--only`` names them; ``--scale-conns`` / ``--scale-ticks``
(BENCH_SCALE_CONNS, BENCH_SCALE_TICKS; default 10**5 and 300) size them.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import platform
import time

from repro_torch.bench import common

MODULES = [
    "fig03_asym_micro",
    "fig05_background",
    "fig06_failures_micro",
    "fig04_asym_macro",
    "fig07_failures_macro",
    "fig08_extreme",
    "fig02_symmetric",
    "bins",
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
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--out", default=common.bench_path(), help="the BENCH file to merge into")
    ap.add_argument("--scale-conns", type=int,
                    default=int(os.environ.get("BENCH_SCALE_CONNS", "100000")),
                    help="connections of the scale modules' row")
    ap.add_argument("--scale-ticks", type=int,
                    default=int(os.environ.get("BENCH_SCALE_TICKS", "300")),
                    help="ticks of the scale row")
    args = ap.parse_args(argv)
    if args.seeds < 1:
        ap.error(f"--seeds must be >= 1, got {args.seeds}")
    os.environ["BENCH_SEEDS"] = str(args.seeds)  # sweep_case's seed axis
    keys = [k.strip() for k in args.only.split(",") if k.strip()]
    selected = [m for m in MODULES if not keys or any(m.startswith(k) for k in keys)]
    selected += [m for m in SCALE_MODULES if any(m.startswith(k) for k in keys)]
    if not selected:
        ap.error(f"--only {args.only!r} selects no module of {MODULES + SCALE_MODULES}")

    if args.device in (None, "cuda"):
        from repro_torch.kernels import build

        build.library()  # build (or load) the kernels before any bucket is timed
    rows = common.Rows(full_scale=args.full, smoke=args.smoke, seeds=args.seeds,
                       collect=args.collect, device=args.device or "cuda")
    print("name,us_per_call,derived")
    t0 = time.time()
    for name in selected:
        mod = importlib.import_module(f"repro_torch.bench.{name}")
        if name in SCALE_MODULES:
            mod.main(rows, conns=args.scale_conns, ticks=args.scale_ticks, device=args.device)
        else:
            mod.main(rows, full=args.full, smoke=args.smoke, collect=args.collect,
                     device=args.device)
    wall = time.time() - t0
    records = {r["name"]: {k: v for k, v in r.items() if k != "name"} for r in rows.records}

    prev = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            prev = json.load(f)
    # a figure run again replaces all its rows (its bucket rows may differ)
    ran = {n.split("/")[0] for n in records}
    kept = {k: v for k, v in prev.get("rows", {}).items() if k.split("/")[0] not in ran}
    payload = {
        "meta": {
            "modules": sorted(set(prev.get("meta", {}).get("modules", [])) | set(selected)),
            "total_wall_s": wall,
            "platform": platform.platform(),
            "python": platform.python_version(),
        },
        "rows": {**kept, **records},
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
    print(f"# wrote {args.out} ({len(payload['rows'])} rows) in {wall:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
