#!/usr/bin/env python3
"""Count what one simulator tick issues, by name, and compare source trees.

    python3 tools/tick_ops.py                                   # this tree, on the card
    python3 tools/tick_ops.py --device cpu                      # the same, on the CPU
    python3 tools/tick_ops.py --root build/parent --root .      # the launches that changed
    python3 tools/tick_ops.py --rows 1 --rows 64                # one run against a 64-row fleet
    python3 tools/tick_ops.py --rows 1 --rows 64 --summary      # each without and with telemetry

The cell is ``chip_smoke.py``'s fig06 REPS cell (FATTREE_128, 128-connection
permutation, ToR-0 uplink failures), stepped ``--warm`` ticks, then timed
over ``--ticks`` ticks without the profiler (wall time per tick, host loop
included, ending in a synchronize), then profiled with ``torch.profiler``
over ``--ticks`` more.

- On the card it counts the device kernels the tick launches, by kernel
  name, with their device time per tick.
- On the CPU it counts the aten calls the tick makes at its top level; each
  of the port's kernel entry points (``repro_torch.kernels.ops``) counts
  as one call and its plain version's insides are not counted.  That is the
  tick's launch count as far as the CPU can show it: a view (``aten::slice``,
  ``aten::select``, ...) is counted here and launches nothing on the card.

With ``--rows B`` the cell is stepped as a fleet of B seeds
(``FleetRunner``, one tick over a row axis; trees that have it), ticks
through ``Simulator.step_rows``.  ``--summary`` adds, after each (tree,
rows) run, the same run with ``FleetRunner.run_summary``'s tick
(``step_probe_rows`` and ``TelemetrySpec.default()``'s update; trees that
have it, and as a fleet of 1 where ``--rows`` is not given).  With several ``--root`` trees or
``--rows`` values each (tree, rows) runs in its own process, in the order
given (a tree may be named twice, e.g. parent, change, change, parent); the
script prints each run's wall time and total per tick and, name by name,
how every later run's launches differ from the first's.  Every tree builds its own kernels under its own
``build/``.  It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def profile_tree(root: Path, device: str, warm: int, ticks: int, rows: int = 0,
                 summary: bool = False) -> dict:
    """Time, then profile, ``ticks`` ticks each of the fig06 REPS cell of the
    tree at ``root`` (``rows`` > 0: as a fleet of that many seeds;
    ``summary``: with the default telemetry folded in); returns the wall
    time per tick, ``{name: [calls per tick, device us per tick]}`` and the
    total."""
    sys.path.insert(0, str(REPO))
    import chip_smoke  # the cell; it imports the port only when called

    sys.path.insert(0, str(root / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels import ops

    if device == "cpu":
        torch.set_num_threads(1)
        for name in ops.KERNEL_MODULES:  # each entry point is one call
            def counted(*args, _fn=getattr(ops, name), _tag=f"repro_torch::{name}", **kw):
                with record_function(_tag):
                    return _fn(*args, **kw)
            setattr(ops, name, counted)
    elif not torch.cuda.is_available():
        raise SystemExit("tick_ops: no CUDA device (pass --device cpu to count on the CPU)")
    dev = torch.device(device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    if summary:
        from repro_torch.netsim import TelemetrySpec

        fleet = chip_smoke.fig06_fleet(range(rows or 1), dev)
        sim, keys = fleet.sim, fleet.base_keys()
        state, _ = fleet.run(warm)
        draws = sim.tick_draws(keys, warm, 2 * ticks)
        prog = fleet.program(TelemetrySpec.default(), warm + 2 * ticks)
        tel = prog.init_rows(fleet.n_runs)

        def step(st, t, d):
            new, probe = sim.step_probe_rows(st, t, d)
            prog.update(tel, probe)
            return new, None
    elif rows:
        fleet = chip_smoke.fig06_fleet(range(rows), dev)
        sim, keys = fleet.sim, fleet.base_keys()
        state, _ = fleet.run(warm)
        draws = sim.tick_draws(keys, warm, 2 * ticks)
        step = lambda st, t, d: sim.step_rows(st, t, d)
    else:
        sim = chip_smoke.fig06_cell("reps", dev)
        state, _ = sim.run(warm)
        draws = sim.tick_draws(sim.base_key, warm, 2 * ticks)
        step = sim.tick_fn
    sync()
    t0 = time.perf_counter()
    for i in range(ticks):
        state, _ = step(state, warm + i, draws.row(i))
    sync()
    wall_us = (time.perf_counter() - t0) / ticks * 1e6
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    with profile(activities=acts) as prof:
        for i in range(ticks, 2 * ticks):
            # on the CPU a range marks the tick's top level; on the card it
            # would be one more device event, so none is recorded there
            with record_function("tick") if device == "cpu" else contextlib.nullcontext():
                state, _ = step(state, warm + i, draws.row(i))
        sync()
    per = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if device == "cuda":
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = e.time_range.elapsed_us()
        else:
            if e.cpu_parent is None or e.cpu_parent.name != "tick":
                continue
            us = 0.0
        per[e.name][0] += 1
        per[e.name][1] += us
    table = {k: [n / ticks, us / ticks] for k, (n, us) in sorted(per.items())}
    tag = (f" (fleet, B={rows or 1})" if rows or summary else "") + (" + telemetry" if summary
                                                                       else "")
    return dict(root=str(root) + tag, device=device,
                warm=warm, ticks=ticks, wall_us=wall_us, per_tick=table,
                total=sum(v[0] for v in table.values()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", action="append", type=Path,
                    help="source tree to profile (repeatable; default: this one)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--warm", type=int, default=300)
    ap.add_argument("--ticks", type=int, default=100)
    ap.add_argument("--rows", action="append", type=int,
                    help="step the cell as a fleet of this many seeds (repeatable; default: "
                         "one run through tick_fn)")
    ap.add_argument("--summary", action="store_true",
                    help="after each run, the same run with the default telemetry folded in")
    ap.add_argument("--out", type=Path, help="write every tree's full table here as JSON")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    roots = [r.resolve() for r in (args.root or [REPO])]
    if args.one:
        print(json.dumps(profile_tree(roots[0], args.device, args.warm, args.ticks,
                                      (args.rows or [0])[0], args.summary)))
        return 0
    results = []
    modes = (False, True) if args.summary else (False,)
    for root, rows, summary in [(r, b, m) for r in roots for b in (args.rows or [0])
                                for m in modes]:
        cmd = [sys.executable, str(Path(__file__).resolve()), "--one", "--root", str(root),
               "--device", args.device, "--warm", str(args.warm), "--ticks", str(args.ticks),
               "--rows", str(rows)] + (["--summary"] if summary else [])
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode != 0:
            sys.stderr.write(out.stdout + out.stderr)
            return out.returncode
        results.append(json.loads(out.stdout.strip().splitlines()[-1]))
    what = "device launches" if args.device == "cuda" else "top-level aten calls"
    for r in results:
        busy = sum(v[1] for v in r["per_tick"].values())
        print(f"{r['root']}: {r['wall_us']:.1f} us wall per tick unprofiled; "
              f"{r['total']:.2f} {what} per tick"
              + (f", {busy:.1f} us device time per tick" if args.device == "cuda" else ""))
    base = results[0]["per_tick"]
    for r in results[1:]:
        print(f"{r['root']} against {results[0]['root']}, per tick:")
        for name in sorted(set(base) | set(r["per_tick"])):
            a, b = base.get(name, [0, 0.0]), r["per_tick"].get(name, [0, 0.0])
            if a[0] != b[0]:
                print(f"  {b[0] - a[0]:+8.2f} calls {b[1] - a[1]:+9.2f} us  "
                      f"({a[0]:.2f} -> {b[0]:.2f})  {name[:100]}")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
