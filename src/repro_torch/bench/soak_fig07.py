"""Fig 7-class soak entry on the port: the failure-modes macro grid driven
through the checkpointed soak runtime (``repro_torch.netsim.soak``), the
port of the reference's ``benchmarks/soak_fig07.py`` CLI, with its own copy
of that module's ``cases`` and ``record`` (which import the reference).

    # uninterrupted golden
    python -m repro_torch.bench.soak_fig07 --ckpt /tmp/ck_a --out straight.json
    # killed mid-run (exits 137 after the boundary checkpoint commits) ...
    python -m repro_torch.bench.soak_fig07 --ckpt /tmp/ck_b --kill-at 240 || true
    # ... resumed, must be bit-identical to the golden
    python -m repro_torch.bench.soak_fig07 --ckpt /tmp/ck_b --resume --out resumed.json
    diff straight.json resumed.json

The JSON is a canonical byte-stable record of what a figure reads: every
cell and seed's ``RunSummary`` field and a sha256 of each cell's raw
telemetry carry, so equal files mean equal figures.  ``--inject-spine N``
kills one spine mid-run through ``SoakRunner.inject``; ``--trace R``
carries the flight recorder (ring R) and streams ``<ckpt>/flight`` parts.
Runs on the card unless ``--device cpu``; ``chip_smoke.py`` drives the same
grid on FATTREE_128's fabric through ``build`` and ``drive``.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os

from repro_torch.bench.common import ci_cfg, msg, sweep_case
from repro_torch.netsim import SoakConfig, SoakRunner, SweepEngine, failures, workloads
from repro_torch.netsim.tracer import TraceSpec

LBS = ["ops", "reps"]
MIN_FAILURE_SLOTS = 16  # headroom for --inject-spine deltas


def cases(cfg, ticks: int):
    """The fig07 structure (static partial failures + permutation and ring
    AllReduce blocks x LB columns) at soak horizons: the AllReduce block
    runs 2x the permutation horizon, so the grid has horizon-heterogeneous
    buckets under the soak cursor."""
    fs = failures.random_down_uplinks(cfg, 0.05, max(ticks // 8, 1), failures.FOREVER, seed=7)
    n = cfg.n_hosts
    blocks = [
        ("permutation", workloads.permutation(n, msg(48, 2048), seed=1), ticks),
        ("ring_allreduce", workloads.ring_allreduce(16, msg(24, 1024)), 2 * ticks),
    ]
    out = []
    for wname, wl, t in blocks:
        for lbn in LBS:
            kw = {"freezing_timeout": 800} if lbn == "reps" else {}
            out.append(sweep_case(f"fig07soak/{wname}/{lbn}", wl, lbn, t, cfg, failures=fs,
                                  **kw))
    return out


def record(soak: SoakRunner) -> dict:
    """Canonical JSON-able record of the finished run: exact RunSummary
    fields per cell and seed, and the sha256 of each cell's sketch rows."""
    res = soak.result()
    summaries = {name: [dataclasses.asdict(s) for s in ss]
                 for name, ss in sorted(res.summaries().items())}
    tel_sha = {}
    for b in res.buckets:
        for c in b.cells:
            h = hashlib.sha256()
            for row in c.rows:
                h.update(b.telemetry[row].tobytes())
            tel_sha[c.case.name] = h.hexdigest()
    return {
        "cursor": int(soak.cursor),
        "injections": soak.injections,
        "summaries": summaries,
        "telemetry_sha256": dict(sorted(tel_sha.items())),
    }


def build(cfg, ticks: int, chunk: int, ckpt_dir: str, trace: int = 0,
          device=None) -> SoakRunner:
    """The grid's engine and a checkpointing runner (a flight ring of
    ``trace`` entries, or none)."""
    engine = SweepEngine(cfg, cases(cfg, ticks), min_failure_slots=MIN_FAILURE_SLOTS,
                         device=device)
    spec = TraceSpec(ring=trace) if trace else None
    return SoakRunner(engine, SoakConfig(chunk=chunk, ckpt_dir=ckpt_dir, trace=spec))


def drive(soak: SoakRunner, chunk: int, kill_at=None, inject_spine=None, inject_at=None,
          cfg=None) -> bool:
    """Advance to the horizon in chunks, injecting a spine failure when the
    cursor stands at ``inject_at`` (a tick that is no chunk boundary is never
    reached, and nothing is injected, as in the reference CLI); returns False
    where ``kill_at`` stopped the run (the caller exits)."""
    while not soak.done:
        if inject_spine is not None and soak.cursor == inject_at and not soak.injections:
            soak.inject(failures.spine_down(cfg, inject_spine, start=inject_at))
            print(f"injected spine_down({inject_spine}) at {inject_at}")
        soak.advance(chunk)
        if kill_at is not None and soak.cursor >= kill_at:
            return False
    return True


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True, help="checkpoint root dir")
    ap.add_argument("--ticks", type=int, default=480,
                    help="permutation-block horizon (AllReduce runs 2x)")
    ap.add_argument("--chunk", type=int, default=120, help="ticks per chunk == checkpoint cadence")
    ap.add_argument("--kill-at", type=int, default=None,
                    help="os._exit(137) at the first boundary >= this tick (after its "
                         "checkpoint commits): the simulated preemption")
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest committed snapshot first")
    ap.add_argument("--inject-spine", type=int, default=None,
                    help="inject a spine_down delta mid-run")
    ap.add_argument("--inject-at", type=int, default=None,
                    help="cursor tick for --inject-spine (defaults to one chunk in; must be "
                         "a boundary the run reaches)")
    ap.add_argument("--trace", type=int, default=0,
                    help="flight-recorder ring size (0 = off): stream flight_*.npz parts "
                         "under <ckpt>/flight; the record is the same traced or not")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--out", default=None, help="write the record JSON here")
    args = ap.parse_args(argv)

    cfg = ci_cfg()
    soak = build(cfg, args.ticks, args.chunk, args.ckpt, args.trace, args.device)
    if args.resume:
        soak.resume()
        print(f"resumed at cursor {soak.cursor} ({len(soak.injections)} injection(s) replayed)")
    inject_at = None
    if args.inject_spine is not None:
        inject_at = args.inject_at if args.inject_at is not None else args.chunk
    if not drive(soak, args.chunk, args.kill_at, args.inject_spine, inject_at, cfg):
        print(f"killed at cursor {soak.cursor} (checkpoint committed)")
        os._exit(137)  # hard preemption: no atexit, no cleanup

    rec = record(soak)
    blob = json.dumps(rec, indent=1, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(blob + "\n")
    for name, sha in rec["telemetry_sha256"].items():
        done = rec["summaries"][name][0]["completed"]
        print(f"{name}: completed={done} sketch={sha[:12]}")
    print(f"cursor={rec['cursor']}")
    return rec


if __name__ == "__main__":
    main()
