"""Live soak dashboard: watch a checkpointed sweep run, chunk by chunk (the
reference's ``benchmarks/soak_dashboard.py``).

Drives the fig07-class soak grid (``repro_torch.bench.soak_fig07.cases``)
through ``SoakRunner`` and prints a frame per cell after every ``advance``
without finalizing anything: every number comes from ``inspect()`` (the
telemetry's live rows and the flight recorder's decoded ring tail), so the
view means something long before the horizon.

Per cell: a progress bar, delivered / drops / timeouts counters, a
per-window utilization sparkline, the recovery tracker's first drop ->
first redelivery span once the redelivery lands, and, when tracing, the
flight ring's cursor and its latest decision events.  ``--inject-spine N``
kills a spine one chunk in.  On a terminal the frames redraw in place
through ``curses.wrapper`` (``run_curses``, reference
``benchmarks/soak_dashboard.py:119-141``; ``q`` quits with the checkpoints
kept); with ``--plain``, or when stdout is not a terminal, they go to
stdout, one per chunk.  Runs on the card unless ``--device cpu``.

    python -m repro_torch.bench.soak_dashboard --plain --ticks 240 --chunk 80
    python -m repro_torch.bench.soak_dashboard --ckpt /tmp/ck --trace 512 --device cpu
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.bench.common import ci_cfg
from repro_torch.bench.soak_fig07 import MIN_FAILURE_SLOTS, cases
from repro_torch.netsim import SoakConfig, SoakRunner, SweepEngine, failures
from repro_torch.netsim.tracer import CODE_NAMES, TraceSpec

SPARK = " .:-=+*#%@"


def sparkline(fracs, width: int = 16) -> str:
    """Map [0, 1] window values onto a fixed-width character ramp."""
    if len(fracs) == 0:
        return " " * width
    fracs = np.asarray(fracs, np.float64)[-width:]
    chars = [SPARK[int(min(max(f, 0.0), 1.0) * (len(SPARK) - 1))] for f in fracs]
    return "".join(chars).ljust(width)


def bar(cursor: int, ticks: int, width: int = 20) -> str:
    fill = int(width * min(cursor, ticks) / max(ticks, 1))
    return "[" + "#" * fill + "-" * (width - fill) + "]"


def cell_lines(name: str, info: dict) -> list[str]:
    """One cell of an ``inspect()`` snapshot as text lines."""
    head = (
        f"{name:<34} {bar(info['cursor'], info['ticks'])} "
        f"{info['cursor']:>6}/{info['ticks']:<6}"
        f"{' done' if info['done'] else ''}"
    )
    lines = [head]
    tel = info.get("telemetry")
    if tel is not None:
        c = tel["counters"]
        body = (
            f"  delivered={c['delivered']:<8} drops={c['drops_cong']}"
            f"+{c['drops_fail']:<6} timeouts={c['timeouts']:<6}"
        )
        if "windows" in tel and len(tel["windows"]["util_frac"]):
            util = tel["windows"]["util_frac"].mean(axis=1)
            peak = float(util.max())
            scaled = util / peak if peak > 0 else util
            body += f" util|{sparkline(scaled)}| peak={peak:.2f}"
        lines.append(body)
        rec = tel.get("recovery")
        if rec is not None and rec["first_drop_tick"] >= 0:
            span = (
                f"recovered in {rec['recovery_us']:.2f}us "
                f"(t{rec['first_drop_tick']}->t{rec['first_redeliver_tick']})"
                if rec["recovery_ticks"] >= 0
                else "awaiting redelivery"
            )
            lines.append(f"  first drop t{rec['first_drop_tick']}: {span}")
    fl = info.get("flight")
    if fl is not None:
        tail = [f"{CODE_NAMES.get(int(k), '?')}@t{int(t)}"
                for t, k in zip(fl["tick"][-4:], fl["code"][-4:])]
        lines.append(
            f"  flight: {fl['cursor']} events"
            + (f", lost {fl['lost']}" if fl["lost"] else "")
            + ("  last: " + " ".join(tail) if tail else "")
        )
    return lines


def frame(soak: SoakRunner) -> list[str]:
    lines = [
        f"soak cursor {soak.cursor}/{soak.horizon}  "
        f"chunk={soak.config.chunk}  "
        f"injections={len(soak.injections)}  "
        f"trace={'on' if soak.trace is not None else 'off'}"
    ]
    for name, info in sorted(soak.inspect().items()):
        lines.extend(cell_lines(name, info))
    return lines


def run_plain(soak: SoakRunner, chunk: int, inject_at, inject_spine, cfg):
    while not soak.done:
        if inject_at is not None and soak.cursor == inject_at and not soak.injections:
            soak.inject(failures.spine_down(cfg, inject_spine, start=inject_at))
        soak.advance(chunk)
        print("\n".join(frame(soak)))
        print("-" * 72, flush=True)


def run_curses(soak: SoakRunner, chunk: int, inject_at, inject_spine, cfg):
    """The curses view: one frame per chunk, redrawn in place, clipped to
    the screen, with a ``q`` prompt on the last line; ``q`` (or ``Q``)
    stops the run between chunks, leaving the checkpoints written so far."""
    import curses

    def loop(scr):
        curses.use_default_colors()
        scr.nodelay(True)
        while not soak.done:
            if inject_at is not None and soak.cursor == inject_at and not soak.injections:
                soak.inject(failures.spine_down(cfg, inject_spine, start=inject_at))
            soak.advance(chunk)
            scr.erase()
            h, w = scr.getmaxyx()
            for y, line in enumerate(frame(soak)[: h - 1]):
                scr.addnstr(y, 0, line, w - 1)
            scr.addnstr(h - 1, 0, "q: quit (checkpoints kept)", w - 1)
            scr.refresh()
            if scr.getch() in (ord("q"), ord("Q")):
                return

    curses.wrapper(loop)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=480,
                    help="permutation-block horizon (AllReduce runs 2x)")
    ap.add_argument("--chunk", type=int, default=120,
                    help="ticks per chunk == frames per refresh")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint root (enables resume + flight parts)")
    ap.add_argument("--trace", type=int, default=512,
                    help="flight-recorder ring size (0 disables tracing)")
    ap.add_argument("--inject-spine", type=int, default=None,
                    help="inject a spine_down delta one chunk in")
    ap.add_argument("--plain", action="store_true",
                    help="print frames to stdout instead of curses")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = ci_cfg()
    engine = SweepEngine(cfg, cases(cfg, args.ticks), min_failure_slots=MIN_FAILURE_SLOTS,
                         device=args.device)
    trace = TraceSpec(ring=args.trace) if args.trace else None
    soak = SoakRunner(engine, SoakConfig(chunk=args.chunk, ckpt_dir=args.ckpt, trace=trace))
    inject_at = args.chunk if args.inject_spine is not None else None
    if args.plain or not sys.stdout.isatty():
        run_plain(soak, args.chunk, inject_at, args.inject_spine, cfg)
    else:
        run_curses(soak, args.chunk, inject_at, args.inject_spine, cfg)
    print(f"finished at cursor {soak.cursor}/{soak.horizon} "
          f"(checkpoints{' at ' + args.ckpt if args.ckpt else ' off'})")
    return soak


if __name__ == "__main__":
    main()
