#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # the full check (one card, ~minutes)
    python3 chip_smoke.py --ticks 500 --check-ticks 300   # a shorter pass

Phases, in order; any failure exits non-zero and prints no result:

  1. device line — the card's name and power limit (``nvidia-smi``) and the
     torch / CUDA versions;
  2. build — compiles ``src/repro_torch/csrc/*.cu`` (one ``nvcc`` per source,
     all in parallel) into one library and loads it;
  3. kernels — each of the four kernels against its plain PyTorch version on
     the card, bit for bit, at the main path's shapes and at edge shapes;
     then each is timed with CUDA events (median of repeated batches)
     beside its plain version and, for ``seg_sum``, ``index_add_``;
  4. main path — the paper's FATTREE_128 fabric (128 hosts, 16 ToR
     uplinks), a 128-connection permutation of 4096-packet messages and the
     fig06 failure schedule (ToR-0 uplinks 0 and 1 down over ticks
     150-800 and 1200-2400), run for OPS and for REPS (freezing timeout
     800) with every backend on the kernels; each kernel's launch count
     must equal its per-tick count times the ticks;
     A profiled window of 100 REPS ticks then shows where a tick's time
     goes (device busy share, launches per tick, kernel device times);
  5. card vs CPU — the REPS cell for a shorter horizon (past the first
     failure and REPS freezing) on the card with the kernels and on the
     CPU through the plain versions; every ``SimState`` leaf must be equal.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Bounds: bytes = each input read once + each output written once, over the
# HBM rate; operations = one integer operation per element the function
# must touch (per valid event-field for seg_sum), over the CUDA-core rate.
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12  # H100 SXM CUDA-core float32 peak; int32 work counted against it


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
def time_ms(fn, reps: int = 5, inner: int = 50) -> float:
    """Device time of one call, in ms: ``inner`` back-to-back calls are
    captured in one CUDA graph and replayed ``reps`` times between CUDA
    events (median).  The graph takes the host's per-launch cost out, so
    this is what the card spends on the call."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture needs
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / inner)
    return statistics.median(samples)


def eager_ms(fn, reps: int = 5, inner: int = 50) -> float:
    """Time of one call issued eagerly from Python, in ms (CUDA events over
    ``inner`` back-to-back calls, median of ``reps``): the host's wrapper and
    launch cost when it exceeds the device time."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / inner)
    return statistics.median(samples)


def bound_ms(bytes_moved: int, ops: int) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def equal_all(a, b, what: str) -> float:
    """Hold the outputs ``a`` bit-exactly against ``b``; returns the largest
    ``|a - b|`` over them (bools as 0/1), which is 0 when this returns."""
    import torch

    err = 0.0
    for i, (x, y) in enumerate(zip(a, b)):
        if x.shape != y.shape or x.dtype != y.dtype or not torch.equal(x, y):
            bad = (x != y).nonzero()[:5].tolist() if x.shape == y.shape else "shape"
            raise AssertionError(f"{what}: output {i} differs from the plain version at {bad}")
        if x.numel():
            wide = torch.float64 if x.is_floating_point() else torch.int64
            err = max(err, float((x.to(wide) - y.to(wide)).abs().max()))
    return err


# ---------------------------------------------------------------------------
def kernel_phase(dev, shapes: dict) -> list[dict]:
    """Hold every kernel bit-exactly against its plain version on the card,
    then time it at the main path's shapes."""
    import numpy as np
    import torch

    from repro_torch.kernels import queue_tick as qt_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels import reps_update as ru_mod
    from repro_torch.kernels import seg_rank as sr_mod
    from repro_torch.kernels import seg_sum as ss_mod

    rs = np.random.RandomState(11)
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    rows = []
    err = 0.0  # largest |kernel - plain| over the current kernel's cases

    # ---- seg_sum -----------------------------------------------------------
    def seg_case(B, F, K, S, sentinel_frac=0.3):
        seg = rs.randint(0, S, size=(B, K))
        seg[rs.rand(B, K) < sentinel_frac] = S  # the engine's sentinel id
        seg[rs.rand(B, K) < 0.02] = S + 7  # further out of range
        seg[rs.rand(B, K) < 0.02] = -1
        vals = rs.randint(-3, 50, size=(B, F, K))
        return i32(seg), i32(vals)

    NC, NH, R = shapes["NC"], shapes["NH"], shapes["R"]
    main_ss = (5, shapes["MAX_EV"], (R + 1) * (NC + 1))  # the feedback call
    cases = [(1, *main_ss), (1, 2, NH, NC + 1), (1, 4, NH, NC + 1), (3, 5, 300, 387),
             (1, 5, 128, 3 * 1025), (2, 5, 700, 20000), (1, 1, 1, 1)]
    for B, F, K, S in cases:
        seg, vals = seg_case(B, F, K, S)
        got = ss_mod.seg_sum_cuda(seg, vals, S)
        want = ref.seg_sum_ref(seg, vals, S)
        torch.cuda.synchronize()
        err = max(err, equal_all([got], [want], f"seg_sum B={B} F={F} K={K} S={S}"))
        got1 = ss_mod.seg_sum_cuda(seg[0], vals[0], S)
        err = max(err, equal_all([got1], [want[0]], f"seg_sum unbatched F={F} K={K} S={S}"))
    seg, vals = seg_case(1, *main_ss)
    seg, vals, S = seg[0].contiguous(), vals[0].contiguous(), main_ss[2]
    seg64 = torch.where((seg >= 0) & (seg < S), seg, S).long()
    F = vals.shape[0]

    def library():
        return torch.zeros((F, S + 1), dtype=torch.int32, device=dev).index_add_(1, seg64, vals)

    out = ss_mod.seg_sum_cuda(seg, vals, S)
    valid = int(((seg >= 0) & (seg < S)).sum())
    b, why = bound_ms(nbytes(seg, vals, out), valid * F)
    rows.append(dict(
        name="seg_sum", route="cuda", source="src/repro_torch/csrc/seg_sum.cu",
        replaces="src/repro/kernels/seg_sum.py:65",
        ms=time_ms(lambda: ss_mod.seg_sum_cuda(seg, vals, S)),
        eager_ms=eager_ms(lambda: ss_mod.seg_sum_cuda(seg, vals, S)),
        plain_ms=time_ms(lambda: ref.seg_sum_ref(seg, vals, S)),
        bound_ms=b, bound_by=why, library_ms=time_ms(library), max_abs_err=err,
        shape=f"F={F} K={seg.numel()} S={S}",
    ))
    err = 0.0

    # ---- seg_rank ----------------------------------------------------------
    def rank_case(B, K, S, n_ids):
        seg = rs.randint(0, n_ids, size=(B, K))
        seg[rs.rand(B, K) < 0.25] = S
        seg[rs.rand(B, K) < 0.02] = -5
        return i32(seg)

    main_sr = (shapes["MAX_EV"], NC + 1)
    for B, K, S, n_ids in [(1, *main_sr, NC + 1), (1, shapes["MAX_ARR"], shapes["NQ"] + 1, 40),
                           (2, 1000, 50, 7), (1, 300, 70000, 70000), (3, 129, 129, 3),
                           (1, 1, 1, 1)]:
        seg = rank_case(B, K, S, n_ids)
        got = sr_mod.seg_rank_cuda(seg, S)
        want = ref.seg_rank_ref(seg, S)
        torch.cuda.synchronize()
        err = max(err, equal_all([got], [want], f"seg_rank B={B} K={K} S={S}"))
    seg = rank_case(1, *main_sr, NC + 1)[0].contiguous()
    S = main_sr[1]
    out = sr_mod.seg_rank_cuda(seg, S)
    b, why = bound_ms(nbytes(seg, out), seg.numel())
    rows.append(dict(
        name="seg_rank", route="cuda", source="src/repro_torch/csrc/seg_rank.cu",
        replaces="src/repro/kernels/seg_rank.py:60",
        ms=time_ms(lambda: sr_mod.seg_rank_cuda(seg, S)),
        eager_ms=eager_ms(lambda: sr_mod.seg_rank_cuda(seg, S)),
        plain_ms=time_ms(lambda: ref.seg_rank_ref(seg, S)),
        bound_ms=b, bound_by=why, library_ms=None, max_abs_err=err,
        shape=f"K={seg.numel()} S={S}",
    ))
    err = 0.0

    # ---- reps_tick ---------------------------------------------------------
    def reps_case(shape, frozen_frac=0.3, with_events=(True,) * 6):
        n = int(np.prod(shape))
        b = lambda p: torch.as_tensor(rs.rand(n) < p, device=dev).reshape(shape)
        i = lambda lo, hi: i32(rs.randint(lo, hi, size=n)).reshape(shape)
        state = [
            i32(rs.randint(0, 65536, size=(n, 8))).reshape(*shape, 8),
            torch.as_tensor(rs.rand(n, 8) < 0.5, device=dev).reshape(*shape, 8),
            i(0, 8), i(0, 9), i(0, 3), b(frozen_frac), i(0, 3000), i(0, 3),
        ]
        ev = [b(0.5), i(0, 65536), b(0.3), b(0.2), b(0.6), i(0, 65536)]
        ev = [e if w else None for e, w in zip(ev, with_events)]
        return state, ev, int(rs.randint(0, 3000))

    N = NC
    for shape, events in [((N,), (True,) * 6), ((1000,), (True,) * 6), ((3, N), (True,) * 6),
                          ((N,), (True, True, True, False, False, False)),
                          ((N,), (False, False, False, True, False, False)),
                          ((N,), (False,) * 4 + (True, True))]:
        state, ev, now = reps_case(shape, with_events=events)
        got = ru_mod.reps_tick_cuda(*state, *ev, now, 32, 800)
        want = ref.reps_tick_ref(*state, *ev, now, 32, 800)
        torch.cuda.synchronize()
        err = max(err, equal_all(got, want, f"reps_tick shape={shape} events={events}"))
    state, ev, now = reps_case((N,))
    outs = ru_mod.reps_tick_cuda(*state, *ev, now, 32, 800)
    b, why = bound_ms(nbytes(*state, *ev, *outs), N * 8)
    rows.append(dict(
        name="reps_tick", route="cuda", source="src/repro_torch/csrc/reps_update.cu",
        replaces="src/repro/kernels/reps_update.py:109",
        ms=time_ms(lambda: ru_mod.reps_tick_cuda(*state, *ev, now, 32, 800)),
        eager_ms=eager_ms(lambda: ru_mod.reps_tick_cuda(*state, *ev, now, 32, 800)),
        plain_ms=time_ms(lambda: ref.reps_tick_ref(*state, *ev, now, 32, 800)),
        bound_ms=b, bound_by=why, library_ms=None, max_abs_err=err, shape=f"N={N}",
    ))
    err = 0.0

    # ---- queue_tick --------------------------------------------------------
    def queue_case(B, K, Q, cap, busy, serve):
        tgt = rs.randint(0, busy, size=(B, K))
        tgt[rs.rand(B, K) < 0.3] = Q  # the engine's padding target
        qlen = rs.randint(0, cap + 1, size=(B, Q))
        qlen[:, : max(1, Q // 8)] = cap  # saturated queues
        u = torch.as_tensor(rs.rand(B, K).astype(np.float32), device=dev)
        sv = torch.as_tensor(rs.rand(B, Q) < 0.5, device=dev) if serve else None
        return i32(tgt), u, i32(qlen), sv

    Q, K, cap = shapes["NQ"], shapes["MAX_ARR"], shapes["QCAP"]
    kmin, kmax = shapes["KMIN"], shapes["KMAX"]
    for B, KK, QQ, busy, serve in [(1, K, Q, Q, False), (1, K, Q, 12, True), (2, 300, Q, 9, True),
                                   (1, 1000, 60000, 20, False), (1, 5, 3, 3, True)]:
        args = queue_case(B, KK, QQ, cap, busy, serve)
        got = qt_mod.queue_tick_cuda(*args, cap, kmin, kmax)
        want = ref.queue_tick_ref(*args, cap, kmin, kmax, tile=qt_mod.TILE)
        torch.cuda.synchronize()
        err = max(err, equal_all(
            got, want, f"queue_tick B={B} K={KK} Q={QQ} busy={busy} serve={serve}"))
    tgt, u, qlen, _ = (t[0].contiguous() if t is not None else None
                       for t in queue_case(1, K, Q, cap, Q, False))
    outs = qt_mod.queue_tick_cuda(tgt, u, qlen, None, cap, kmin, kmax)
    b, why = bound_ms(nbytes(tgt, u, qlen, *outs), K + Q)
    rows.append(dict(
        name="queue_tick", route="cuda", source="src/repro_torch/csrc/queue_tick.cu",
        replaces="src/repro/kernels/queue_tick.py:75",
        ms=time_ms(lambda: qt_mod.queue_tick_cuda(tgt, u, qlen, None, cap, kmin, kmax)),
        eager_ms=eager_ms(lambda: qt_mod.queue_tick_cuda(tgt, u, qlen, None, cap, kmin, kmax)),
        plain_ms=time_ms(lambda: ref.queue_tick_ref(tgt, u, qlen, None, cap, kmin, kmax)),
        bound_ms=b, bound_by=why, library_ms=None, max_abs_err=err, shape=f"K={K} Q={Q}",
    ))
    return rows


# ---------------------------------------------------------------------------
def fig06_cell(lb_name: str, device):
    """The FATTREE_128 fig06 cell: permutation of 4096-packet messages under
    two transient ToR-0 uplink failures."""
    from repro_torch.configs import FATTREE_128
    from repro_torch.core import make_lb
    from repro_torch.netsim import FailureSchedule, Simulator, Topology, failures, workloads

    cfg = FATTREE_128.replace(kernels_backend="cuda", arrivals_backend="cuda")
    ups = Topology.build(cfg).t0_up_queues(0)
    fs = FailureSchedule.concat(
        failures.link_down([int(ups[0])], 150, 800),
        failures.link_down([int(ups[1])], 1200, 2400),
    )
    wl = workloads.permutation(cfg.n_hosts, 4096, seed=3)
    kw = dict(evs_size=cfg.evs_size)
    if lb_name == "reps":
        kw.update(freezing_timeout=800, backend="cuda")
    return Simulator(cfg, wl, make_lb(lb_name, **kw), failures=fs,
                     watch_queues=Topology.build(cfg).t0_up_queues(0), device=device)


def check_invariants(sim, state) -> None:
    """Packet-slot conservation and counter sanity of a finished run."""
    import torch

    from repro_torch.netsim.engine import FREE, PS, ST_ALLOC_FAIL, ST_UNPROC

    NP = sim.NP
    live = int((state.pkt[PS, :NP] != FREE).sum())
    fl = int(state.fl_count)
    assert live + fl == NP, f"packet slots leak: {live} live + {fl} free != {NP}"
    s = state.s_stats.cpu().tolist()
    assert s[ST_ALLOC_FAIL] == 0 and s[ST_UNPROC] == 0, f"alloc fails / unprocessed events: {s}"
    assert bool(torch.isfinite(state.c_cwnd).all()) and bool(torch.isfinite(state.c_alpha).all())
    assert int(state.c_inflight.min()) >= 0


def main_path(dev, ticks: int) -> dict:
    import torch

    from repro_torch.kernels import ops
    from repro_torch.netsim import summarize

    per_tick = {"ops": {"seg_sum": 4, "seg_rank": 1, "queue_tick": 1, "reps_tick": 0},
                "reps": {"seg_sum": 4, "seg_rank": 1, "queue_tick": 1, "reps_tick": 4}}
    totals = {k: 0 for k in ops.KERNEL_MODULES}
    for lb in ("ops", "reps"):
        sim = fig06_cell(lb, dev)
        state = sim.init_state()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, trace = sim.run(ticks, state)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        s = summarize(sim, state)
        check_invariants(sim, state)
        assert trace.max_qlen.shape == (ticks,) and trace.watch_qlen.shape == (ticks, 16)
        log(f"main path fig06/{lb}: {ticks} ticks in {secs:.3f} s = {ticks / secs:.1f} ticks/s; "
            f"runtime_ticks={s.runtime_ticks} completed={s.completed}/{s.n_conns} "
            f"drops_fail={s.drops_fail} timeouts={s.timeouts} launches={counts}")
        for k, n in per_tick[lb].items():
            if counts[k] != n * ticks:
                raise AssertionError(
                    f"fig06/{lb}: {k} launched {counts[k]} times, expected {n} x {ticks}")
            totals[k] += counts[k]
    return totals


def profile_window(dev, warm: int, ticks: int) -> None:
    """Where a main-path tick's time goes: ``torch.profiler`` over ``ticks``
    ticks of the REPS cell (after ``warm`` ticks): wall time per tick, the
    device's busy share (summed kernel time / wall; one stream, so kernels
    do not overlap), device launches per tick and the port's four kernels'
    device time per launch inside the real tick."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    sim = fig06_cell("reps", dev)
    state, _ = sim.run(warm)
    draws = sim.tick_draws(sim.base_key, warm, ticks)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(ticks):
            state, _ = sim.tick_fn(state, warm + i, draws.row(i))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_events:
        log("profile: the profiler recorded no device time; busy share not measured")
        return
    busy_us = sum(e.time_range.elapsed_us() for e in dev_events)
    by_name = collections.defaultdict(list)
    for e in dev_events:
        by_name[e.name].append(e.time_range.elapsed_us())
    ours = {}
    for key, tag in (("seg_sum", "seg_sum"), ("seg_rank_kernel", "seg_rank"),
                     ("reps_tick_kernel", "reps_tick"), ("queue_tick_kernel", "queue_tick")):
        durs = [d for n, ds in by_name.items() if key in n for d in ds]
        if durs:
            ours[tag] = (len(durs) / ticks, statistics.median(durs), sum(durs) / ticks)
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:6]
    log(f"profile (REPS, ticks {warm}-{warm + ticks}): {wall_us / ticks:.1f} us wall per tick "
        f"(profiler on), device busy {busy_us / ticks:.1f} us per tick = "
        f"{100 * busy_us / wall_us:.2f} % busy, {len(dev_events) / ticks:.1f} device "
        f"launches per tick")
    for tag, (per_tick, med, tot) in ours.items():
        log(f"profile: {tag}: {per_tick:.1f} launches per tick, median {med:.2f} us device "
            f"per launch, {tot:.2f} us per tick")
    for name, durs in top:
        log(f"profile top: {sum(durs) / ticks:8.2f} us/tick {len(durs) / ticks:5.1f}x  {name[:90]}")


def card_vs_cpu(dev, ticks: int) -> None:
    import numpy as np

    from repro_torch.netsim import sim_state_to_numpy
    from repro_torch.netsim.engine import ST_TIMEOUTS

    finals = []
    for d in (dev, "cpu"):
        sim = fig06_cell("reps", d)
        t0 = time.perf_counter()
        state, _ = sim.run(ticks)
        finals.append(sim_state_to_numpy(state))
        log(f"card vs CPU: REPS {ticks} ticks on {d} in {time.perf_counter() - t0:.3f} s")
    gpu, cpu = finals
    assert gpu.keys() == cpu.keys()
    for k in gpu:
        a, b = gpu[k], cpu[k]
        if a.dtype != b.dtype or a.shape != b.shape or a.tobytes() != b.tobytes():
            bad = np.argwhere(a != b)[:5].tolist() if a.shape == b.shape else "shape"
            raise AssertionError(f"card and CPU differ in SimState leaf {k} at {bad}")
    froze = int((gpu["lb_state.exit_freezing"] > 0).sum())  # set only on entering freezing
    log(f"card vs CPU: all {len(gpu)} SimState leaves bit-equal after {ticks} ticks "
        f"(timeouts={int(gpu['s_stats'][ST_TIMEOUTS])}, REPS conns that entered freezing={froze})")


# ---------------------------------------------------------------------------
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ticks", type=int, default=8000, help="main-path ticks per cell")
    ap.add_argument("--check-ticks", type=int, default=1200, help="card-vs-CPU horizon")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.configs import FATTREE_128
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    lib = build.build(force=True)
    build.library()
    log(f"build: {lib.relative_to(ROOT) if lib.is_relative_to(ROOT) else lib} "
        f"in {time.perf_counter() - t0:.3f} s")

    sim = fig06_cell("reps", dev)
    cfg = FATTREE_128
    shapes = dict(NC=sim.wl.n_conns, NH=sim.NH, NQ=sim.NQ, R=cfg.feedback_rounds,
                  MAX_EV=sim.MAX_EV, MAX_ARR=sim.MAX_ARR, QCAP=cfg.queue_capacity,
                  KMIN=cfg.kmin, KMAX=cfg.kmax)
    log(f"main-path shapes: {shapes} NP={sim.NP}")
    rows = kernel_phase(dev, shapes)
    for r in rows:
        lib_ms = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.5f} ms"
        log(f"kernel {r['name']} ({r['shape']}): bit-exact; device {r['ms']:.5f} ms per call "
            f"(eager from Python {r['eager_ms']:.5f} ms), plain {r['plain_ms']:.5f} ms, "
            f"library {lib_ms}, bound {r['bound_ms']:.3e} ms")

    totals = main_path(dev, args.ticks)
    profile_window(dev, warm=300, ticks=100)
    card_vs_cpu(dev, args.check_ticks)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    for r in rows:
        r["launches"] = totals[r["name"]]
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
