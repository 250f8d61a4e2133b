#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # the full check (one card, ~minutes)
    python3 chip_smoke.py --ticks 500 --arena-ticks 300 --check-ticks 300 --zoo-check-ticks 200 --fig18-ticks 300 --fig18-check-ticks 200 --fleet-ticks 300 --fleet-check-ticks 200 --fleet-bench-ticks 100 --tel-ticks 600 --tel-check-ticks 300 --tel-bench-ticks 60 --tel-rounds 1 --sweep-fig06-ticks 1500 --scale-row6-ticks 300 --bins-steps 4000

Phases, in order; any failure exits non-zero and prints no result:

  1. device line — the card's name and power limit (``nvidia-smi``) and the
     torch / CUDA versions;
  2. build — compiles ``src/repro_torch/csrc/*.cu`` (one ``nvcc`` per source,
     all in parallel) into one library and loads it;
  3. kernels — each of the seven kernels against its plain PyTorch version on
     the card, bit for bit, at the main path's shapes and at edge shapes:
     ``reps_tick`` in the TPU kernel's one-round form and with R = 2 and 4
     ACK rounds (every event class, and with classes absent; one row and
     with a row axis), ``seg_sum`` on the stacked int32 form and on fields as
     they are (F = 1 ... 8 bool / int32 fields, the engine's four calls among
     them), ``queue_tick`` in the TPU kernel's form and in the engine's (its
     RED mark and ring slot inside the launch) on busy queues whose tail
     drops fall in later tiles (K = 300, 512, 2048; Q = 20, 384 and 12000,
     the last in global scratch; one row and row axes), ``seg_rank`` over
     many passes, on one repeated key, on ids all out of range and past its
     count table, the flat ``ecmp_hash`` (one port count, and one per lane),
     and ``next_queue`` (the routing step, the redesign of ``ecmp_hash``) in
     both its forms on five fabrics (2-tier FATTREE_128,
     FATTREE_128_OVERSUB4, FATTREE_1024; 3-tier FATTREE_128_3T and a 32-host
     one) with empty slots, fresh injections (queue -1), every region as the
     current queue, tied queue lengths, with and without adaptive routing
     and penalty, and with a fleet's row axis (B = 1, 4, 64 rows in one
     launch, against the plain version and B one-row launches; penalty
     shared and per row; connection tables shared and one per row), its
     table form ``next_queue_table`` on four generated fabrics (clos3, rail,
     mesh at 128 hosts and a one-ToR mesh corner; both forms, adaptive and
     ECMP, penalty or none, B = 1, 4, 64 rows, connection tables shared, per
     row or one row expanded), and ``seg_sum`` / ``seg_rank`` / ``reps_tick``
     at the scale rows' shapes (NC = 10**5 and 10**6, B = 1 and 2: S = 3 (NC
     + 1), NC + 1 and N = NC, timed beside their bounds), the traced form
     of ``reps_tick`` (the flight recorder's per-row decision counts in the
     same launch: N = 128, R = 2, every class, one row and 64; N = 10**6;
     its state == the untraced launch's, its counts == the plain
     version's, device time traced against untraced), and ``seg_rank`` /
     ``seg_sum`` at the balls-into-bins shapes (a recycled step, K = S = n
     for n = 8, 32, 128; an OPS run's 10000 x 128 rows; fig16's K = 2**21
     onto S = 32 as 8 and 64 rows), with bytes and bound; then
     each is timed with
     CUDA events (median of repeated batches) at the engine's call
     (``reps_tick``: N = 128, R = 2, every class; ``seg_sum``: the feedback
     call's five fields; ``queue_tick``: K = 512, Q = 384, engine form;
     ``next_queue``: K = 512, NQ = 384, engine form, ECMP; ``next_queue_table``:
     the same call on the 128-host rail fabric) beside its plain
     version, the engine's former call form where there is one and, for
     ``seg_sum``, ``index_add_`` (and ``next_queue`` at a 64-row fleet's call);
  4. main path — the paper's FATTREE_128 fabric (128 hosts, 16 ToR
     uplinks), a 128-connection permutation of 4096-packet messages and the
     fig06 failure schedule (ToR-0 uplinks 0 and 1 down over ticks
     150-800 and 1200-2400), run for OPS and for REPS (freezing timeout
     800) on the kernels; each kernel's launch count must equal its
     per-tick count times the ticks (``next_queue`` 1, ``ecmp_hash`` 0,
     ``reps_tick`` 1 per tick where REPS runs, ``seg_sum`` 4).
     A profiled window of 50 REPS ticks then shows where a tick's time
     goes (device busy share, launches per tick, kernel device times);
  5. fig18/3tier/reps — the 3-tier fabric at full width (FATTREE_128_3T), a
     permutation of 2048-packet messages, REPS, with exact launch counts and
     every queue region carrying traffic; card == CPU on every leaf after
     a shorter horizon;
  6. arena — the LB arena's failure block at full width: FATTREE_128, a
     permutation of 1024-packet messages and 5 % of the ToR uplinks down
     from tick 150 on (``benchmarks/arena.py``), 300 ticks (past the first
     failure; the first cell, PLB, 100 ticks past 150 + the RTO, where it
     must have timed out), for each of the nine zoo
     load balancers beyond ECMP/OPS/REPS, plus ``mixed`` (REPS foreground,
     ECMP background) on fig05's background cohort; exact launch counts
     per load balancer (``next_queue`` once per tick for every LB, adaptive
     RoCE included; ``reps_tick`` 1 per tick where REPS runs (reps, mixed));
  7. card vs CPU — the REPS fig06 cell for a shorter horizon (past the
     first failure and REPS freezing), then every zoo load balancer on
     FATTREE_32_CI through a ToR-uplink failure (past the RTO they are held
     card == CPU by the sweep phase's traced zoo grid), each on the
     card with the kernels and on the CPU through the plain versions (in
     two helper processes while the card runs); every ``SimState`` leaf
     must be equal;
  8. fleet — the fig06/reps cell under many seeds (``FleetRunner``, one
     tick over a row axis): B = 4 rows equal four serial card runs on every
     leaf and trace field; a small fleet (FATTREE_32_CI, B = 3) equals its
     CPU run; each kernel's launches per tick are exact and the same at
     B = 1, 4, 16, 64; row-ticks/s against B from interleaved rounds
     (median, min, max per B; the fleet of seeds 0..B-1 is the first B rows
     of one warmed B = 64 fleet), each set against B = 1 and against the
     main path's one run; a profiled window of 100 ticks at B = 64;
  9. telemetry — the summary path (``FleetRunner.run_summary``, the default
     ``TelemetrySpec``): four FATTREE_128 REPS rows with their own
     scenarios (fig08's 12.5, 25 and 50 % uplinks down, and fig06) equal
     their serial card runs on every leaf and carry slot after 600 ticks;
     three FATTREE_32_CI rows with their own scenarios and cohort channels,
     card == CPU; the telemetry's device launches per tick by name at B = 1
     and 64 (the same; no device-to-host copy or synchronize inside a
     tick); row-ticks/s of ``FleetRunner.run_summary`` against ``run``'s
     body (``Simulator.run_rows``) at B = 1 and 64, each resumed at the
     fleet phase's warmed rows, from interleaved rounds;
 10. sweep — the sweep engine (``SweepEngine`` through the port's
     ``figure_grid``, ``collect="summary"`` with quiescence early exit):
     (a) the fig06 grid at the BENCH_FULL config (FATTREE_128's fabric,
     4096-packet messages) and its full 8000-tick horizon, its two cells one
     bucket behind ``SwitchLB(ops, reps)``, with exact launch counts; each
     row equals its serial card run (the main path's run, continued to the
     bucket's ``ticks_run``) on every leaf, the active SwitchLB slot against
     the plain load balancer, the other slot at its init, and its sketch
     summary equals ``summarize``; the grid runs traced (``trace=TraceSpec``
     with a ring that holds the whole run), so its rows equal their
     *untraced* serial runs, each row's ring shows ``fail_active`` at ticks
     150 and 1200 with one queue each, and its ``fail_rerouted`` value and
     first-drop / re-delivery ticks equal its RecoveryTracker's; (b) the fig04 (with one shorter cell, so
     that its bucket merges horizons; ECMP, OPS and REPS) and fig07
     (permutation and ring-AllReduce blocks) smoke grids at FATTREE_32_CI,
     shrunk as tests/test_figure_parity.py shrinks them: card == CPU on every
     leaf and carry slot; (b') every zoo LB, REPS and ``mixed`` as one
     traced FATTREE_32_CI grid under two ToR-0 uplinks down, past the RTO,
     card == CPU on every ring carry, telemetry carry and leaf; (c) device launches
     per tick by name of (a)'s bucket against a B = 2 fig06/reps
     ``run_summary`` fleet and against itself traced (the tracer's added
     launches by name), and of (b)'s horizon-merged bucket against the same
     bucket unmasked (equal on ticks no row's horizon falls on);
 11. generated fabrics — the clos3 table form of FATTREE_128_3T equals the
     fig18 phase's arithmetic card run on every leaf; rail (16 rails) and
     mesh (2 planes) at 128 hosts, REPS and adaptive RoCE, ToR-0's first two
     up queues down from tick 100, card == CPU after 200 ticks; the table
     form launches once per tick, ``next_queue`` and ``ecmp_hash`` never;
 12. scale mode — fig06/reps with ``conn_sharding=True`` equals phase 7's
     dense card run of the cell on every leaf but ``as_idx`` / ``as_count``, its
     active set exactly the non-FREE slots, and device launches per tick,
     sparse against dense; a binding ``active_slots`` cell card == CPU; the
     10**5-connection row (``bench/scale_smoke.py``, 150 ticks) card == CPU;
     the 10**6 row through ``SweepEngine(collect="none")`` for 400 ticks
     (done > 0, NP = A by the lifetime bound, ticks/s, peak memory, exact
     kernel launches) and a profiled window of 100 ticks after it; its live
     REPS state packs to <= 25 B/conn and round-trips, and
     ``measure_scale(10**6)``.  Phases 11 and 12 run after phase 7.
 13. balls into bins — ``repro_torch.core.balls_bins``: fig13/14 at n = 8,
     32, 128 for 10000 steps and fig17's coalescing ratios, card == CPU on
     every output; fig16's full grid on the card, == CPU on every trial or
     on the first 4 where the CPU run of 64 is too long; Theorem 5.1's
     assertions at n = 128; exact seg_rank / seg_sum launches per step and
     steps/s;
 14. soak — ``bench/soak_fig07``'s grid on FATTREE_128's fabric, 480 ticks
     (AllReduce 960), chunk 120, traced, checkpointing to a temporary
     directory: straight; killed at 240 and resumed by a fresh engine and
     runner (records equal, flight parts equal array by array); a spine
     injected at 40 through ``inject`` against the same spine declared
     statically (records equal); snapshot bytes and save seconds,
     synchronous and asynchronous.

The line before the last is a JSON object with one entry per kernel
(``launches`` counts the main path's, fig18's, the arena's, the fleet's,
the telemetry, the sweep, the fabric, the scale, the balls-into-bins and
the soak phases' runs; the flat
``ecmp_hash`` is launched there no more); the last line
is ``{"ok": true, "device": {...}}``.  It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
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
# the traced zoo grid of the sweep phase: every zoo LB (those whose trace
# port counts decisions, and mprdma, bitmap and adaptive_roce, which count
# none), REPS and mixed, run past the RTO
ZOO_TRACED = (("reps", {"freezing_timeout": 200}), ("plb", {}), ("flowlet", {}), ("mptcp", {}),
              ("prime", {}), ("seqbalance", {}), ("flowlet_table", {}), ("mprdma", {}),
              ("bitmap", {}), ("adaptive_roce", {}),
              ("mixed", {"fg": "reps", "bg": "plb", "bg_conns": (1, 3, 5, 8)}))
# the load balancers of the zoo beyond ECMP / OPS / REPS, in registry order
ZOO = ("plb", "flowlet", "mptcp", "mprdma", "bitmap", "adaptive_roce", "prime",
       "seqbalance", "flowlet_table")


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

    from repro_torch.kernels import ecmp_hash as eh_mod
    from repro_torch.kernels import next_queue as nq_mod
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

    # fields as they are (the engine's form): "b" a bool field, "i" an int32
    # one, each a contiguous view at an offset into a longer tensor
    def field_case(B, kinds, K, S):
        seg = seg_case(B, 1, K, S)[0]
        shape = (B, K) if B > 1 else (K,)
        fields = []
        for k in kinds:
            raw = rs.rand(B * K + 5) < 0.4 if k == "b" else rs.randint(-3, 50, size=B * K + 5)
            t = torch.as_tensor(raw.astype(bool if k == "b" else np.int32), device=dev)
            fields.append(t[5:].view(shape))
        return (seg if B > 1 else seg[0]), fields

    main_fb = ("ibiii", shapes["MAX_EV"], (R + 1) * (NC + 1))  # the feedback call
    for B, kinds, K, S in [(1, *main_fb), (1, "ibiiibb", *main_fb[1:]),  # with trimming
                           (1, "bb", NH, NC + 1),  # RTO, injection
                           (1, "bbbb", shapes["NHD"], NC + 1),  # delivery
                           (1, "i", 1, 1), (1, "b", 77, 5), (3, "bi", 300, 387),
                           (2, "bbiibi", 130, 40), (2, "ibibibib", 1000, 129),
                           (1, "iiiiiiii", 129, 3 * 1025), (2, "bib", 700, 20000),
                           (2, "bi", 500, 40000)]:  # past shared memory: global atomics
        seg, fields = field_case(B, kinds, K, S)
        got = ss_mod.seg_sum_cuda(seg, fields, S)
        want = ref.seg_sum_ref(seg, fields, S)
        torch.cuda.synchronize()
        err = max(err, equal_all([got], [want], f"seg_sum fields={kinds} B={B} K={K} S={S}"))
    # the telemetry's histograms (the default spec's real edges): bin ids of
    # every (B, K) lane from torch.searchsorted, as Histogram.update makes
    # them (all in range, no sentinel), one bool field, at the main path's
    # K = NQ (qlen, 32 bins) and K = NC (FCT, 64 bins) and its B
    from types import SimpleNamespace

    from repro_torch.netsim.telemetry import Histogram, TelemetrySpec

    like = SimpleNamespace(cfg=SimpleNamespace(queue_capacity=shapes["QCAP"]), NQ=shapes["NQ"],
                           device=dev, wl=SimpleNamespace(n_conns=NC))
    hists = {c.source: (c, c.build(like, shapes["TEL_TICKS"]))
             for c in TelemetrySpec.default().channels if isinstance(c, Histogram)}
    n_hist = 0
    for B, source in [(1, "qlen"), (4, "qlen"), (64, "qlen"), (1, "fct"), (4, "fct"),
                      (64, "fct")]:
        chan, built = hists[source]
        K = shapes["NQ"] if source == "qlen" else NC
        hi = shapes["QCAP"] if source == "qlen" else shapes["TEL_TICKS"]
        vals = i32(np.minimum(rs.geometric(4 / hi, size=(B, K)) - 1, hi + 1))  # every bin
        mask = vals > 0 if source == "qlen" else torch.as_tensor(rs.rand(B, K) < 0.3,
                                                                  device=dev)
        idx = torch.searchsorted(built["inner"], vals.float(), right=True, out_int32=True)
        got = ss_mod.seg_sum_cuda(idx, (mask,), chan.n_bins)
        want = ref.seg_sum_ref(idx, (mask,), chan.n_bins)
        torch.cuda.synchronize()
        err = max(err, equal_all([got], [want], f"seg_sum {source} histogram B={B} K={K} "
                                                f"S={chan.n_bins}"))
        n_hist += 1
    log(f"kernel seg_sum: {n_hist} histogram cases (qlen K={shapes['NQ']} S=32, fct K={NC} "
        f"S=64; B = 1, 4, 64) bit-exact")
    seg, fields = field_case(1, *main_fb)
    S = main_fb[2]
    vals = torch.stack([f.to(torch.int32) for f in fields])  # the library call's input
    seg64 = torch.where((seg >= 0) & (seg < S), seg, S).long()
    F = len(fields)

    def library():
        return torch.zeros((F, S + 1), dtype=torch.int32, device=dev).index_add_(1, seg64, vals)

    def stacked():  # the engine's call before the kernel took fields as they are
        return ss_mod.seg_sum_cuda(seg, torch.stack([f.to(torch.int32) for f in fields]), S)

    out = ss_mod.seg_sum_cuda(seg, fields, S)
    valid = int(((seg >= 0) & (seg < S)).sum())
    b, why = bound_ms(nbytes(seg, *fields, out), valid * F)
    rows.append(dict(
        name="seg_sum", route="cuda", source="src/repro_torch/csrc/seg_sum.cu",
        replaces="src/repro/kernels/seg_sum.py:65",
        ms=time_ms(lambda: ss_mod.seg_sum_cuda(seg, fields, S)),
        eager_ms=eager_ms(lambda: ss_mod.seg_sum_cuda(seg, fields, S)),
        eager_old_ms=eager_ms(stacked), ms_old=time_ms(stacked),
        old_form="torch.stack of the int32-cast fields, then the kernel",
        plain_ms=time_ms(lambda: ref.seg_sum_ref(seg, fields, S)),
        bound_ms=b, bound_by=why, library_ms=time_ms(library), max_abs_err=err,
        shape=f"fields={main_fb[0]} K={seg.numel()} S={S}",
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
                           (1, 1, 1, 1),
                           # many passes of the count table; past the table: warp turns
                           (1, 4096, 50, 7), (2, 2500, 129, 60), (1, 1000, 5000, 5000)]:
        seg = rank_case(B, K, S, n_ids)
        got = sr_mod.seg_rank_cuda(seg, S)
        want = ref.seg_rank_ref(seg, S)
        torch.cuda.synchronize()
        err = max(err, equal_all([got], [want], f"seg_rank B={B} K={K} S={S}"))
    for what, seg, S in [("one repeated key", i32(np.full((1, 1000), 3)), NC + 1),
                         ("one key, many passes", i32(np.zeros((2, 4096))), 1),
                         ("all ids out of range", i32(np.where(rs.rand(1, 1000) < 0.5, -1, 129)),
                          NC + 1)]:
        got = sr_mod.seg_rank_cuda(seg, S)
        err = max(err, equal_all([got], [ref.seg_rank_ref(seg, S)], f"seg_rank {what}"))
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
    def reps_case(shape, rounds=None, frozen_frac=0.3, with_events=(True,) * 6):
        """State and events; ``rounds=None`` is the TPU kernel's one-round
        form, else the ACK classes are tuples of ``rounds`` tensors."""
        n = int(np.prod(shape))
        b = lambda p: torch.as_tensor(rs.rand(n) < p, device=dev).reshape(shape)
        i = lambda lo, hi: i32(rs.randint(lo, hi, size=n)).reshape(shape)
        state = [
            i32(rs.randint(0, 65536, size=(n, 8))).reshape(*shape, 8),
            torch.as_tensor(rs.rand(n, 8) < 0.5, device=dev).reshape(*shape, 8),
            i(0, 8), i(0, 9), i(0, 3), b(frozen_frac), i(0, 3000), i(0, 3),
        ]
        acks = [(b(0.5), i(0, 65536), b(0.3)) for _ in range(rounds or 1)]
        ev = list(acks[0]) if rounds is None else [tuple(a[c] for a in acks) for c in range(3)]
        ev += [b(0.2), b(0.6), i(0, 65536)]
        ev = [e if w else None for e, w in zip(ev, with_events)]
        return state, ev, int(rs.randint(0, 3000))

    N = NC
    every, acks_only = (True,) * 6, (True, True, True, False, False, False)
    for shape, rounds, events in [
        ((N,), None, every), ((1000,), None, every), ((3, N), None, every),
        ((N,), None, acks_only), ((N,), None, (False, False, False, True, False, False)),
        ((N,), None, (False,) * 4 + (True, True)),
        # the engine's one launch per tick: R feedback rounds, timeouts, sends
        ((N,), R, every), ((N,), 2, every), ((N,), 4, every), ((3, N), 2, every),
        ((2, 300), 4, every), ((N,), 2, acks_only), ((1000,), 4, (True, False, False) * 2),
        ((N,), 2, (True, True, False, False, True, True)), ((3, N), 4, (False,) * 3 + (True,) * 3),
    ]:
        state, ev, now = reps_case(shape, rounds, with_events=events)
        got = ru_mod.reps_tick_cuda(*state, *ev, now, 32, 800)
        want = ref.reps_tick_ref(*state, *ev, now, 32, 800)
        torch.cuda.synchronize()
        err = max(err, equal_all(
            got, want, f"reps_tick shape={shape} rounds={rounds} events={events}"))
    state, ev, now = reps_case((N,), R)  # the engine's call: R rounds, every class
    outs = ru_mod.reps_tick_cuda(*state, *ev, now, 32, 800)

    def stages():  # the same tick as the engine launched it before: one per stage
        st = state
        for r in range(R):
            st = ru_mod.reps_tick_cuda(*st[:8], ev[0][r], ev[1][r], ev[2][r], None, None, None,
                                       now, 32, 800)
        st = ru_mod.reps_tick_cuda(*st[:8], None, None, None, ev[3], None, None, now, 32, 800)
        return ru_mod.reps_tick_cuda(*st[:8], None, None, None, None, ev[4], ev[5], now, 32, 800)

    err = max(err, equal_all(stages(), outs, "reps_tick one launch vs one per stage"))
    flat_ev = [t for e in ev for t in (e if isinstance(e, tuple) else (e,))]
    b, why = bound_ms(nbytes(*state, *flat_ev, *outs), N * 8 * (R + 2))
    rows.append(dict(
        name="reps_tick", route="cuda", source="src/repro_torch/csrc/reps_update.cu",
        replaces="src/repro/kernels/reps_update.py:109",
        ms=time_ms(lambda: ru_mod.reps_tick_cuda(*state, *ev, now, 32, 800)),
        eager_ms=eager_ms(lambda: ru_mod.reps_tick_cuda(*state, *ev, now, 32, 800)),
        eager_old_ms=eager_ms(stages), ms_old=time_ms(stages),
        old_form="one launch per ACK round, timeout and send",
        plain_ms=time_ms(lambda: ref.reps_tick_ref(*state, *ev, now, 32, 800)),
        bound_ms=b, bound_by=why, library_ms=None, max_abs_err=err, shape=f"N={N} R={R}",
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

    def busy_case(B, K, Q, cap):
        """Arrivals crowded on a few queues near capacity, so that tail drops
        fall in later 128-arrival tiles too."""
        hot = rs.randint(0, Q, size=min(Q, 6))
        tgt = np.where(rs.rand(B, K) < 0.6, hot[rs.randint(0, len(hot), size=(B, K))],
                       rs.randint(0, Q, size=(B, K)))
        tgt[rs.rand(B, K) < 0.3] = Q
        tgt[rs.rand(B, K) < 0.02] = -2
        qlen = rs.randint(0, cap + 1, size=(B, Q))
        qlen[:, hot] = cap - rs.randint(0, 40, size=len(hot))
        u = torch.as_tensor(rs.rand(B, K).astype(np.float32), device=dev)
        return i32(tgt), u, i32(qlen), torch.as_tensor(rs.rand(B, Q) < 0.5, device=dev)

    Q, K, cap = shapes["NQ"], shapes["MAX_ARR"], shapes["QCAP"]
    kmin, kmax, pmax = shapes["KMIN"], shapes["KMAX"], shapes["PMAX"]
    red_rcp = float(np.float32(1.0) / np.float32(kmax - kmin))  # the engine's
    cases = [(queue_case(B, KK, QQ, cap, busy, serve), f"B={B} K={KK} Q={QQ} busy={busy}")
             for B, KK, QQ, busy, serve in [
                 (1, K, Q, Q, False), (1, K, Q, 12, True), (2, 300, Q, 9, True),
                 (1, 1000, 60000, 20, False), (1, 5, 3, 3, True)]]
    cases += [(busy_case(B, KK, QQ, cap), f"busy B={B} K={KK} Q={QQ}")
              for KK in (300, 512, 2048) for B, QQ in [(1, 20), (1, Q), (3, Q), (2, 12000)]]
    for (tgt_c, u_c, qlen_c, sv_c), what in cases:
        q_head_c = i32(rs.randint(0, 4 * cap, size=qlen_c.shape))
        for sv in (None, sv_c):
            for form in ({}, dict(red_rcp=red_rcp, pmax=pmax, q_head=q_head_c, qcap=cap),
                         dict(red_rcp=red_rcp, pmax=0.5, q_head=q_head_c, qcap=cap)):
                args = (tgt_c, u_c, qlen_c, sv, cap, kmin, kmax)
                got = qt_mod.queue_tick_cuda(*args, **form)
                want = ref.queue_tick_ref(*args, **form, tile=qt_mod.TILE)
                torch.cuda.synchronize()
                err = max(err, equal_all(got, want, f"queue_tick {what} serve={sv is not None} "
                                                    f"form={sorted(form)} pmax={form.get('pmax')}"))
    tgt, u, qlen, _ = (t[0].contiguous() for t in queue_case(1, K, Q, cap, Q, True))
    q_head = i32(rs.randint(0, cap, size=Q))
    a_valid = tgt < Q  # the engine pads with Q
    engine = dict(red_rcp=red_rcp, pmax=pmax, q_head=q_head, qcap=cap)

    def call():  # the engine's launch: mark and slot inside
        return qt_mod.queue_tick_cuda(tgt, u, qlen, None, cap, kmin, kmax, **engine)

    def former():  # the engine's arrivals stage before: the default launch, then its glue
        new_qlen, k_accept, _, pos = qt_mod.queue_tick_cuda(tgt, u, qlen, None, cap, kmin, kmax)
        accept = a_valid & k_accept
        mark_p = torch.clamp((pos.to(torch.float32) - kmin) * red_rcp, 0.0, 1.0) * pmax
        mark = accept & (u < mark_p)
        ok = (tgt >= 0) & (tgt < Q)
        slot = (torch.where(ok, q_head[tgt.clamp(0, Q - 1)], 0) + pos) % cap
        return new_qlen, accept, mark, pos, slot

    outs = call()
    err = max(err, equal_all(former(), outs, "queue_tick one launch vs the engine's former glue"))
    b, why = bound_ms(nbytes(tgt, u, qlen, q_head, *outs), K + Q)
    rows.append(dict(
        name="queue_tick", route="cuda", source="src/repro_torch/csrc/queue_tick.cu",
        replaces="src/repro/kernels/queue_tick.py:75",
        ms=time_ms(call), eager_ms=eager_ms(call),
        eager_old_ms=eager_ms(former), ms_old=time_ms(former),
        old_form="the default launch, then the mark, slot and accept glue (17 launches)",
        plain_ms=time_ms(lambda: ref.queue_tick_ref(tgt, u, qlen, None, cap, kmin, kmax,
                                                    **engine)),
        bound_ms=b, bound_by=why, library_ms=None, max_abs_err=err,
        shape=f"K={K} Q={Q} engine form",
    ))
    err = 0.0

    # ---- ecmp_hash ---------------------------------------------------------
    def hash_case(shape, salt_hi=False):
        flow = rs.randint(-2**31, 2**31, size=shape, dtype=np.int64)
        ev = rs.randint(0, 65536, size=shape)
        salt = (2**31 - 1 - rs.randint(0, 9000, size=shape) if salt_hi
                else rs.randint(0, 64, size=shape))  # 3-tier agg_global + 7919 / ToR ids
        return i32(flow), i32(ev), i32(salt)

    U = shapes["U"]
    for shape, nports, salt_hi in [((K,), U, False), ((K,), 1, False), ((K,), 13, True),
                                   ((1000,), 16, True), ((77,), 13, False),
                                   ((3, K), U, True), ((2, 300), 1, True)]:
        args = hash_case(shape, salt_hi)
        got = eh_mod.ecmp_hash_cuda(*args, nports)
        want = ref.ecmp_hash_ref(*args, nports)
        torch.cuda.synchronize()
        err = max(err, equal_all([got], [want], f"ecmp_hash shape={shape} nports={nports}"))
    # one port count per lane (1..16, a seventh of the lanes at 1), as the
    # reference's TableTopology hashes: shaped like flow, one (K,) row of
    # counts broadcast over (B, K), and one count per row (B, 1)
    for shape, lanes in [((K,), (K,)), ((3, K), (3, K)), ((4, 300), (300,)), ((77,), (77,)),
                         ((5, 300), (5, 1))]:
        args = hash_case(shape, True)
        counts = rs.randint(1, 17, size=lanes)
        counts.reshape(-1)[::7] = 1
        nports = i32(counts)
        got = eh_mod.ecmp_hash_cuda(*args, nports)
        want = ref.ecmp_hash_ref(*args, nports)
        torch.cuda.synchronize()
        err = max(err, equal_all([got], [want], f"ecmp_hash shape={shape} per-lane nports"))
    flow, ev, salt = hash_case((K,))
    lanes = i32(rs.randint(1, 17, size=K))
    lane_b, lane_why = bound_ms(nbytes(flow, ev, salt, lanes, flow), 15 * K)
    log("kernel ecmp_hash: per-lane nports (1..16, lanes at 1; shaped like flow, broadcast "
        f"over rows and per row) bit-exact; at K={K}: device "
        f"{time_ms(lambda: eh_mod.ecmp_hash_cuda(flow, ev, salt, lanes)):.5f} ms, eager "
        f"{eager_ms(lambda: eh_mod.ecmp_hash_cuda(flow, ev, salt, lanes)):.5f} ms, plain "
        f"{time_ms(lambda: ref.ecmp_hash_ref(flow, ev, salt, lanes)):.5f} ms, bound "
        f"{lane_b:.3e} ms ({lane_why})")
    flow, ev, salt = hash_case((K,))
    out = eh_mod.ecmp_hash_cuda(flow, ev, salt, U)
    # ~15 integer operations per element: 3 multiplies and 2 xors to combine,
    # the finalizer's 3 shifts, 3 xors and 2 multiplies, one modulo
    b, why = bound_ms(nbytes(flow, ev, salt, out), 15 * K)
    rows.append(dict(
        name="ecmp_hash", route="cuda", source="src/repro_torch/csrc/ecmp_hash.cu",
        replaces="src/repro/kernels/ecmp_hash.py:40",
        ms=time_ms(lambda: eh_mod.ecmp_hash_cuda(flow, ev, salt, U)),
        eager_ms=eager_ms(lambda: eh_mod.ecmp_hash_cuda(flow, ev, salt, U)),
        plain_ms=time_ms(lambda: ref.ecmp_hash_ref(flow, ev, salt, U)),
        bound_ms=b, bound_by=why, library_ms=None, max_abs_err=err,
        shape=f"K={K} nports={U}",
    ))
    err = 0.0

    # ---- next_queue: the routing step, the redesign of ecmp_hash -------------
    from repro_torch.configs import arcane_paper as presets
    from repro_torch.netsim import Topology
    from repro_torch.netsim.engine import PCONN, PCURQ, PEV, PF, PHOP

    def route_case(topo, K, NP, NC, penalty):
        """Arrivals in the engine's form: empty slots among them, fresh
        injections (hop 0, queue -1), every region's first and last queue as
        a current queue, lengths in [0, 3) (ties: the first-least rule
        decides) and 4 x capacity of penalty on 15 % of queues."""
        cfg, NQ = topo.cfg, topo.n_queues
        conn_src = rs.randint(0, cfg.n_hosts, size=NC)
        near = rs.rand(NC) < 0.3  # same-ToR pairs as well as far ones
        conn_dst = np.where(near, conn_src // cfg.hosts_per_tor * cfg.hosts_per_tor
                            + rs.randint(0, cfg.hosts_per_tor, size=NC),
                            rs.randint(0, cfg.n_hosts, size=NC))
        pkt = np.zeros((PF, NP + 1), np.int64)
        pkt[PCONN] = rs.randint(0, NC, size=NP + 1)
        pkt[PEV] = rs.randint(0, 65536, size=NP + 1)
        pkt[PHOP] = rs.randint(1, 5, size=NP + 1)
        pkt[PCURQ] = rs.randint(0, NQ, size=NP + 1)
        bounds = sorted({topo.t0_up_base, topo.agg_up_base, topo.core_down_base,
                         topo.agg_down_base, topo.t0_down_base, NQ} - {-1})
        edges = [q for lo, hi in zip(bounds[:-1], bounds[1:]) for q in (lo, hi - 1)]
        pkt[PCURQ, : len(edges)] = edges
        inj = rs.rand(NP + 1) < 0.3
        inj[: len(edges)] = False
        pkt[PHOP, inj] = 0
        pkt[PCURQ, inj] = -1
        a_idx = rs.randint(0, NP, size=K)
        a_idx[rs.rand(K) < 0.25] = NP
        a_idx[: min(K, len(edges))] = np.arange(min(K, len(edges)))
        if K > 5:
            a_idx[-5:] = NP
        q_pen = np.where(rs.rand(NQ) < 0.15, 4 * cfg.queue_capacity, 0)
        a_idx, pkt = i32(a_idx), i32(pkt)
        A = pkt[:, a_idx.clamp(max=NP - 1)]
        return dict(a_idx=a_idx, rows=(A[PHOP], A[PCURQ], A[PCONN], A[PEV]), NP=NP,
                    conn_src=i32(conn_src), conn_dst=i32(conn_dst),
                    q_len=i32(rs.randint(0, 3, size=NQ)), q_pen=i32(q_pen) if penalty else None)

    def route_forms(g, c, adaptive):
        """The engine's form, and the reference form on the same arrivals
        (one run's ``(K,)`` or a fleet's ``(B, K)``)."""
        hop, cur, conn, ev = c["rows"]
        cc = conn.clamp(0, c["conn_src"].shape[-1] - 1)
        # the hosts of each arrival: from one shared table, or from its row's
        host = lambda t: torch.gather(t, -1, cc.long()) if t.dim() == 2 else t[cc]
        engine = (g, hop, cur, conn, ev, c["conn_src"], c["conn_dst"], c["q_len"], adaptive,
                  c["q_pen"], c["a_idx"], c["NP"])
        reference = (g, hop == 0, cur, conn, ev, host(c["conn_src"]), host(c["conn_dst"]),
                     c["q_len"], adaptive, c["q_pen"])
        return engine, reference

    fabrics = [("FATTREE_128", {}), ("FATTREE_128_OVERSUB4", {}), ("FATTREE_1024", {}),
               ("FATTREE_128_3T", {}),
               ("FATTREE_32_CI", dict(hosts_per_tor=4, tiers=3, tors_per_pod=2,
                                      aggs_per_pod=4, agg_uplinks=2))]
    n_cases = 0
    for name, kw in fabrics:
        topo = Topology.build(getattr(presets, name).replace(**kw))
        g, main_k = topo.geometry, topo.n_queues + topo.cfg.n_hosts  # the engine's MAX_ARR
        for K in (main_k, 77, 1):
            for penalty in (True, False):
                c = route_case(topo, K, 32768 if K == main_k else 600, 128, penalty)
                for adaptive in (False, True):
                    for form, args in zip(("engine", "reference"), route_forms(g, c, adaptive)):
                        got = nq_mod.next_queue_cuda(*args)
                        want = ref.next_queue_ref(*args)
                        torch.cuda.synchronize()
                        err = max(err, equal_all([got], [want], (
                            f"next_queue {name} K={K} {form} form adaptive={adaptive} "
                            f"penalty={penalty}")))
                        n_cases += 1
    log(f"kernel next_queue: {n_cases} cases bit-exact (5 fabrics x K in (MAX_ARR, 77, 1) x "
        f"penalty x adaptive x both forms)")

    def fleet_route(topo, B):
        """B rows of the engine's arrivals on one fabric: each row its own
        packet table, slots and queue lengths; the connection tables of one
        workload (shared) or one per row; the penalty shared (one failure
        schedule) or per row."""
        K = topo.n_queues + topo.cfg.n_hosts
        cs = [route_case(topo, K, 32768, 128, True) for _ in range(B)]
        stack = lambda f: torch.stack([f(c) for c in cs])
        return dict(rows=tuple(stack(lambda c, j=j: c["rows"][j]) for j in range(4)),
                    a_idx=stack(lambda c: c["a_idx"]), q_len=stack(lambda c: c["q_len"]),
                    NP=32768, conn_src=cs[0]["conn_src"], conn_dst=cs[0]["conn_dst"],
                    src_rows=stack(lambda c: c["conn_src"]),
                    dst_rows=stack(lambda c: c["conn_dst"]),
                    pen_shared=cs[0]["q_pen"], pen_rows=stack(lambda c: c["q_pen"]))

    topo = Topology.build(presets.FATTREE_128)
    n_rows_cases = n_table_cases = 0
    for B in (1, 4, 64):
        c = fleet_route(topo, B)
        # the engine's shared scenario: one row's tables and penalty expanded
        # to (B, ...) views, row stride 0
        c["pen_expanded"] = c["pen_rows"][0].expand(B, -1)
        for pen, tables in [(p, "shared") for p in ("pen_shared", "pen_rows", None)] + [
                (p, "rows") for p in ("pen_shared", "pen_rows")] + [
                ("pen_expanded", "expanded")]:
            cc = dict(c, q_pen=c[pen] if pen else None)
            if tables == "rows":  # one connection table pair per row
                cc.update(conn_src=c["src_rows"], conn_dst=c["dst_rows"])
            if tables == "expanded":
                cc.update(conn_src=c["src_rows"][0].expand(B, -1),
                          conn_dst=c["dst_rows"][0].expand(B, -1))
            for adaptive in (False, True):
                for form, args in zip(("engine", "reference"), route_forms(
                        topo.geometry, cc, adaptive)):
                    args = tuple(a.contiguous() if isinstance(a, torch.Tensor) and (
                        a.dim() < 2 or a.stride(0)) else a for a in args)  # keep stride 0
                    got = nq_mod.next_queue_cuda(*args)
                    want = ref.next_queue_ref(*args)
                    # row by row: (B, ...) inputs sliced, the shared ones as they are
                    one = torch.stack([nq_mod.next_queue_cuda(*(
                        a[b].contiguous() if isinstance(a, torch.Tensor) and a.dim() == 2 else a
                        for a in args)) for b in range(B)])
                    torch.cuda.synchronize()
                    what = (f"next_queue rows B={B} {form} form adaptive={adaptive} penalty={pen} "
                            f"connection tables {tables}")
                    err = max(err, equal_all([got], [want], what))
                    err = max(err, equal_all([got], [one], what + " vs one-row launches"))
                    n_rows_cases += tables == "shared"
                    n_table_cases += tables != "shared"
    log(f"kernel next_queue with rows: {n_rows_cases} cases bit-exact against the plain version "
        f"and against B one-row launches (FATTREE_128, B in (1, 4, 64) x penalty shared / per "
        f"row / none x adaptive x both forms)")
    log(f"kernel next_queue with per-row connection tables: {n_table_cases} cases bit-exact "
        f"against the plain version and against B one-row launches (FATTREE_128, B in (1, 4, 64) "
        f"x (penalty shared / per row, or tables and penalty one row expanded, row stride 0) x "
        f"adaptive x both forms)")

    def timed(name, adaptive):  # the engine's call on one fabric: K = MAX_ARR, NP = 32768
        topo = Topology.build(getattr(presets, name))
        c = route_case(topo, topo.n_queues + topo.cfg.n_hosts, 32768, 128, True)
        args = route_forms(topo.geometry, c, adaptive)[0]
        return topo, c, args, time_ms(lambda: nq_mod.next_queue_cuda(*args))

    for name, adaptive in (("FATTREE_128", True), ("FATTREE_128_3T", False),
                           ("FATTREE_128_3T", True)):
        topo, _, args, ms = timed(name, adaptive)
        log(f"kernel next_queue at {name} (K={args[10].numel()}, engine form, "
            f"adaptive={adaptive}): device {ms:.5f} ms, plain "
            f"{time_ms(lambda: ref.next_queue_ref(*args)):.5f} ms")

    # the main path's call: FATTREE_128, K = 512, engine form, ECMP (fig06)
    topo, c, args, ms = timed("FATTREE_128", False)
    g, NQ, NP = topo.geometry, topo.n_queues, c["NP"]
    hop, cur, conn, ev = c["rows"]
    a_idx, conn_src, conn_dst = c["a_idx"], c["conn_src"], c["conn_dst"]
    a_valid = a_idx < NP  # the engine computes it for later stages either way

    def former():  # the arrivals stage before: its glue, the 2-tier body, the flat hash
        a_conn = torch.where(a_valid, conn, 0)
        a_ev = torch.where(a_valid, ev, 0)
        a_inj = torch.where(a_valid, hop, 1) == 0
        a_cur = torch.where(a_valid, cur, 0)
        a_cc = a_conn.clamp(0, conn_src.numel() - 1)
        src, dst = conn_src[a_cc], conn_dst[a_cc]
        H, U, T = g.hosts_per_tor, g.uplinks_per_tor, g.n_tors
        src_tor, dst_tor = src // H, dst // H
        same_tor = src_tor == dst_tor
        t0_down = g.t0_down_base + dst_tor * H + dst % H
        t0_up = g.t0_up_base + src_tor * U + eh_mod.ecmp_hash_cuda(a_conn, a_ev, src_tor, U)
        at_t0_up = a_cur < g.core_down_base
        spine = torch.where(at_t0_up, a_cur - g.t0_up_base, 0) % U
        sp_down = g.core_down_base + spine * T + dst_tor
        nxt = torch.where(a_inj, torch.where(same_tor, t0_down, t0_up),
                          torch.where(at_t0_up, sp_down, t0_down)).to(torch.int32)
        return torch.where(a_valid, nxt, NQ)

    out = nq_mod.next_queue_cuda(*args)
    err = max(err, equal_all([former()], [out], "next_queue one launch vs the engine's former glue"))
    K, valid = a_idx.numel(), int(a_valid.sum())
    # a_idx read and the target written for every slot; per arrival four
    # packet-row words and two connection-table words (ECMP: no q_len);
    # ~40 integer operations per arrival (the hash's ~15, the routing's ~25)
    b, why = bound_ms(4 * K + 4 * K + 24 * valid, 40 * valid)
    # a fleet's call: B = 64 rows of the engine's arrivals, penalty shared
    c64 = fleet_route(topo, 64)
    args64 = route_forms(g, dict(c64, q_pen=c64["pen_shared"]), False)[0]
    valid64 = int((c64["a_idx"] < NP).sum())
    b64, why64 = bound_ms(8 * c64["a_idx"].numel() + 24 * valid64, 40 * valid64)
    log(f"kernel next_queue at B=64 rows (K=64x{K}, {valid64} arrivals, engine form, ECMP): "
        f"device {time_ms(lambda: nq_mod.next_queue_cuda(*args64)):.5f} ms, eager "
        f"{eager_ms(lambda: nq_mod.next_queue_cuda(*args64)):.5f} ms, plain "
        f"{time_ms(lambda: ref.next_queue_ref(*args64)):.5f} ms, bound {b64:.3e} ms ({why64}); "
        f"B=1: device {ms:.5f} ms")
    # the same call with one connection table pair per row: (64, 128) src / dst
    tab64 = route_forms(g, dict(c64, q_pen=c64["pen_shared"], conn_src=c64["src_rows"],
                                conn_dst=c64["dst_rows"]), False)[0]
    bt, bt_why = bound_ms(8 * c64["a_idx"].numel() + 24 * valid64, 40 * valid64)
    log(f"kernel next_queue at B=64 rows with per-row connection tables (64x128 src and dst, "
        f"K=64x{K}, {valid64} arrivals, engine form, ECMP): device "
        f"{time_ms(lambda: nq_mod.next_queue_cuda(*tab64)):.5f} ms, eager "
        f"{eager_ms(lambda: nq_mod.next_queue_cuda(*tab64)):.5f} ms, plain "
        f"{time_ms(lambda: ref.next_queue_ref(*tab64)):.5f} ms, bound {bt:.3e} ms ({bt_why}); "
        f"shared tables: device {time_ms(lambda: nq_mod.next_queue_cuda(*args64)):.5f} ms")
    rows.append(dict(
        name="next_queue", route="cuda", source="src/repro_torch/csrc/next_queue.cu",
        replaces="src/repro/kernels/ecmp_hash.py:40",
        ms=ms, eager_ms=eager_ms(lambda: nq_mod.next_queue_cuda(*args)),
        eager_old_ms=eager_ms(former), ms_old=time_ms(former),
        old_form="the engine's gathers and masks, Topology.next_queue's body and the flat "
                 "ecmp_hash kernel",
        plain_ms=time_ms(lambda: ref.next_queue_ref(*args)),
        bound_ms=b, bound_by=why, library_ms=None, max_abs_err=err,
        shape=f"K={K} ({valid} arrivals) NQ={NQ} engine form, ECMP; redesign of ecmp_hash",
    ))
    rows.append(table_kernel_cases(dev, rs))
    scale_kernel_shapes(dev, rs)
    traced_reps_cases(dev, rs, R)
    bins_kernel_shapes(dev, rs)
    return rows


# ---------------------------------------------------------------------------
TABLE_FABRICS = ("clos3:pods=4,tors=2,hosts=16,aggs=4,up=4",  # the table form of FATTREE_128_3T
                 "rail:tors=8,hosts=16,rails=16", "mesh:tors=8,hosts=16,planes=2",
                 "mesh:tors=1,hosts=16,planes=1")  # a corner: no mesh links, up_deg at 0


def table_topology(fabric: str):
    """The port's ``TableTopology`` of a spec string (its cfg: FATTREE_128's
    with the fabric; the router reads only the spec's tables)."""
    from repro_torch.netsim import SimConfig, Topology
    from repro_torch.netsim.topogen import build_spec

    spec = build_spec(fabric)
    return Topology.build(SimConfig(n_hosts=spec.n_hosts, hosts_per_tor=16, fabric=fabric))


def table_route_case(dev, rs, spec, K, NP, NC, penalty):
    """Arrivals on a generated fabric in both forms: the engine's (empty
    slots, fresh injections, every region's first and last queue as a
    current queue, tied lengths, 4 x capacity of penalty on 15 % of
    queues) and the reference's per-arrival hosts and flags, with garbage
    lanes (hosts and queues outside the tables, which the router clips)."""
    import numpy as np
    import torch

    from repro_torch.netsim.engine import PCONN, PCURQ, PEV, PF, PHOP

    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    NQ, NH = spec.n_queues, spec.n_hosts
    H = max(NH // spec.n_tors, 1)
    conn_src = rs.randint(0, NH, size=NC)
    conn_dst = np.where(rs.rand(NC) < 0.3, conn_src // H * H + rs.randint(0, H, size=NC),
                        rs.randint(0, NH, size=NC))
    pkt = np.zeros((PF, NP + 1), np.int64)
    pkt[PCONN] = rs.randint(0, NC, size=NP + 1)
    pkt[PEV] = rs.randint(0, 65536, size=NP + 1)
    pkt[PHOP] = rs.randint(1, 5, size=NP + 1)
    pkt[PCURQ] = rs.randint(0, NQ, size=NP + 1)
    edges = [q for r in spec.regions for q in (r.base, r.base + r.size - 1)]
    pkt[PCURQ, : len(edges)] = edges
    inj = rs.rand(NP + 1) < 0.3
    inj[: len(edges)] = False
    pkt[PHOP, inj] = 0
    pkt[PCURQ, inj] = -1
    a_idx = rs.randint(0, NP, size=K)
    a_idx[rs.rand(K) < 0.25] = NP
    a_idx[: min(K, len(edges))] = np.arange(min(K, len(edges)))
    if K > 5:
        a_idx[-5:] = NP
    rows = pkt[:, a_idx.clip(max=NP - 1)]
    cc = rows[PCONN].clip(0, NC - 1)
    src, dst, cur = conn_src[cc], conn_dst[cc], rows[PCURQ].copy()
    junk = rs.rand(K) < 0.1
    src[junk] = rs.choice([-3, NH, NH + 9], size=int(junk.sum()))
    dst[rs.rand(K) < 0.1] = -2
    dst[rs.rand(K) < 0.05] = NH + 4
    cur[(rs.rand(K) < 0.1) & (rows[PHOP] > 0)] = NQ + 7
    q_pen = np.where(rs.rand(NQ) < 0.15, 340, 0)
    return dict(engine=(i32(rows[PHOP]), i32(rows[PCURQ]), i32(rows[PCONN]), i32(rows[PEV])),
                reference=(torch.as_tensor(rows[PHOP] == 0, device=dev), i32(cur),
                           i32(rows[PCONN]), i32(rows[PEV]), i32(src), i32(dst)),
                a_idx=i32(a_idx), NP=NP, conn_src=i32(conn_src), conn_dst=i32(conn_dst),
                q_len=i32(rs.randint(0, 3, size=NQ)), q_pen=i32(q_pen) if penalty else None)


def table_kernel_cases(dev, rs) -> dict:
    """The table form of the routing kernel against its plain version on
    every fabric of TABLE_FABRICS: both forms, adaptive on and off, penalty
    or none, B = 1, 4 and 64 rows in one launch with the penalty and the
    connection tables shared (stride 0) or one per row; then timed at the
    engine's call on the 128-host rail fabric.  Returns the kernel's row of
    the JSON table."""
    import torch

    from repro_torch.kernels import next_queue_table as nqt_mod
    from repro_torch.kernels import ref

    err, n_cases = 0.0, 0
    for fabric in TABLE_FABRICS:
        topo = table_topology(fabric)
        t, spec = topo.tables(dev), topo.spec
        K = spec.n_queues + spec.n_hosts  # the engine's MAX_ARR
        for B in (1, 4, 64):
            cs = [table_route_case(dev, rs, spec, K, 4096, 128, True) for _ in range(B)]
            stack = lambda f: torch.stack([f(c) for c in cs])
            eng = tuple(stack(lambda c, j=j: c["engine"][j]) for j in range(4))
            refm = tuple(stack(lambda c, j=j: c["reference"][j]) for j in range(6))
            a_idx, q_len = stack(lambda c: c["a_idx"]), stack(lambda c: c["q_len"])
            for pen_kind in ("shared", "rows", None):
                pen = {"shared": cs[0]["q_pen"], "rows": stack(lambda c: c["q_pen"]),
                       None: None}[pen_kind]
                for tables in ("shared", "rows", "expanded"):
                    src, dst = {"shared": (cs[0]["conn_src"], cs[0]["conn_dst"]),
                                "rows": (stack(lambda c: c["conn_src"]),
                                         stack(lambda c: c["conn_dst"])),
                                "expanded": (cs[0]["conn_src"].expand(B, -1),
                                             cs[0]["conn_dst"].expand(B, -1))}[tables]
                    for adaptive in (False, True):
                        forms = [("engine", (t, *eng, src, dst, q_len, adaptive, pen, a_idx,
                                             cs[0]["NP"]))]
                        if tables == "shared":
                            forms.append(("reference", (t, *refm, q_len, adaptive, pen)))
                        for form, args in forms:
                            if B == 1:  # one run's call: no row axis
                                args = tuple(a[0] if isinstance(a, torch.Tensor) and a.dim() == 2
                                             and a.shape[0] == 1 else a for a in args)
                            got = nqt_mod.next_queue_table_cuda(*args)
                            want = ref.next_queue_table_ref(*args)
                            torch.cuda.synchronize()
                            err = max(err, equal_all([got], [want], (
                                f"next_queue_table {fabric} B={B} {form} form adaptive={adaptive} "
                                f"penalty={pen_kind} connection tables {tables}")))
                            n_cases += 1
    log(f"kernel next_queue_table: {n_cases} cases bit-exact against the plain version "
        f"({len(TABLE_FABRICS)} fabrics: {', '.join(TABLE_FABRICS)}; B in (1, 4, 64) x penalty "
        f"shared / per row / none x connection tables shared / per row / expanded x adaptive x "
        f"both forms)")
    # the engine's call on the 128-host rail fabric: K = MAX_ARR slots of a
    # 32768-slot table, 128 connections, ECMP, penalty shared
    topo = table_topology(TABLE_FABRICS[1])
    t, spec = topo.tables(dev), topo.spec
    K = spec.n_queues + spec.n_hosts
    c = table_route_case(dev, rs, spec, K, 32768, 128, True)
    args = (t, *c["engine"], c["conn_src"], c["conn_dst"], c["q_len"], False, c["q_pen"],
            c["a_idx"], c["NP"])
    valid = int((c["a_idx"] < c["NP"]).sum())
    out = nqt_mod.next_queue_table_cuda(*args)
    # a_idx read and the target written for every slot; per arrival four
    # packet-row words, two connection-table words and four table words
    # (q_sw or host_sw, down_next; up_base, up_deg, salt on the way up);
    # ~45 integer operations per arrival (the hash's ~15, clamps and indexing)
    b, why = bound_ms(nbytes(c["a_idx"], out) + 40 * valid, 45 * valid)
    ms = time_ms(lambda: nqt_mod.next_queue_table_cuda(*args))
    adaptive_args = args[:8] + (True,) + args[9:]
    log(f"kernel next_queue_table at {TABLE_FABRICS[1]} (K={K}, {valid} arrivals, engine form): "
        f"ECMP device {ms:.5f} ms, adaptive device "
        f"{time_ms(lambda: nqt_mod.next_queue_table_cuda(*adaptive_args)):.5f} ms")
    return dict(
        name="next_queue_table", route="cuda", source="src/repro_torch/csrc/next_queue_table.cu",
        replaces="src/repro/kernels/ecmp_hash.py:40", ms=ms,
        eager_ms=eager_ms(lambda: nqt_mod.next_queue_table_cuda(*args)),
        plain_ms=time_ms(lambda: ref.next_queue_table_ref(*args)),
        bound_ms=b, bound_by=why, library_ms=None, max_abs_err=err,
        shape=f"K={K} ({valid} arrivals) NQ={spec.n_queues} {TABLE_FABRICS[1]} engine form, "
              f"ECMP; the table form of the ecmp_hash redesign")


def traced_reps_cases(dev, rs, R: int) -> None:
    """The traced form of ``reps_tick`` (the flight recorder's decision
    counts in the same launch): at the engine's call (N = 128, R rounds,
    every class; one row and a fleet's 64 rows of 128) and at N = 10**6,
    its state outputs bit-identical to the untraced launch's and to the
    plain version's, its counts equal to the plain version's; device time
    traced against untraced."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import reps_update as ru_mod

    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    for N, rows, reps, inner in ((128, 1, 5, 50), (128 * 64, 64, 5, 50), (10**6, 1, 3, 10)):
        r = lambda lo, hi: i32(rs.randint(lo, hi, size=N))
        bb = lambda p: torch.as_tensor(rs.rand(N) < p, device=dev)
        state = [i32(rs.randint(0, 65536, size=(N, 8))),
                 torch.as_tensor(rs.rand(N, 8) < 0.5, device=dev),
                 r(0, 8), r(0, 9), r(0, 3), bb(0.3), r(0, 3000), r(0, 3)]
        acks = [(bb(0.5), r(0, 65536), bb(0.3)) for _ in range(R)]
        ev = [tuple(a[c] for a in acks) for c in range(3)] + [bb(0.2), bb(0.6), r(0, 65536)]
        untraced = ru_mod.reps_tick_cuda(*state, *ev, 1234, 32, 800)
        traced = ru_mod.reps_tick_cuda(*state, *ev, 1234, 32, 800, trace_rows=rows)
        plain = ref.reps_tick_ref(*state, *ev, 1234, 32, 800, trace_rows=rows)
        equal_all(traced[:-1], untraced, f"traced reps_tick N={N}: state vs untraced")
        equal_all(traced, plain, f"traced reps_tick N={N} rows={rows} vs plain")
        counts = traced[-1].sum(dim=0).tolist()
        if sum(counts[:3]) != int(ev[4].sum()):
            raise AssertionError(f"traced reps_tick N={N}: hit+miss+recycle {counts[:3]} != sends")
        t_ms = time_ms(lambda: ru_mod.reps_tick_cuda(*state, *ev, 1234, 32, 800, trace_rows=rows),
                       reps=reps, inner=inner)
        u_ms = time_ms(lambda: ru_mod.reps_tick_cuda(*state, *ev, 1234, 32, 800),
                       reps=reps, inner=inner)
        log(f"kernel reps_tick traced (N={N}, R={R}, every class, {rows} row(s)): bit-exact; "
            f"state == untraced, counts == plain {counts[:4]} (hit, miss, recycle, freeze); "
            f"device traced {t_ms:.5f} ms against untraced {u_ms:.5f} ms")


def bins_kernel_shapes(dev, rs) -> None:
    """``seg_rank`` and ``seg_sum`` at the balls-into-bins models' shapes:
    a recycled step (K = S = n for n = 8, 32, 128: the arrivals' rank and
    per-bin count), an OPS run's arrivals (steps x n rows, one launch) and
    fig16's largest case (K = 2**21 EV draws onto S = 32 ports, 8 and 64
    trials as rows), bit-exact against the plain versions, with bytes and
    bound."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import seg_rank as sr_mod
    from repro_torch.kernels import seg_sum as ss_mod

    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    for n in (8, 32, 128):
        t = i32(rs.randint(0, n, size=n))
        t[: n // 4] = 0  # remembered bins pile up
        ones = torch.ones(n, dtype=torch.bool, device=dev)
        rk = sr_mod.seg_rank_cuda(t, n)
        cnt = ss_mod.seg_sum_cuda(t, [ones], n)
        equal_all([rk, cnt], [ref.seg_rank_ref(t, n), ref.seg_sum_ref(t, [ones], n)],
                  f"balls-bins step n={n}")
        sr_b, ss_b = bound_ms(nbytes(t, rk), n), bound_ms(nbytes(t, ones, cnt), n)
        log(f"kernel balls-bins step n={n}: seg_rank (K=S={n}) bit-exact, {nbytes(t, rk)} B, device "
            f"{time_ms(lambda: sr_mod.seg_rank_cuda(t, n)):.5f} ms, bound {sr_b[0]:.3e} ms "
            f"({sr_b[1]}); seg_sum (K=S={n}, one bool field) {nbytes(t, ones, cnt)} B, device "
            f"{time_ms(lambda: ss_mod.seg_sum_cuda(t, [ones], n)):.5f} ms, bound {ss_b[0]:.3e} ms")
    for B, K, S, what in ((10000, 128, 128, "OPS run, steps x n"), (8, 2**21, 32, "fig16 chunk"),
                          (64, 2**21, 32, "fig16, all 64 trials")):
        seg = i32(rs.randint(0, S, size=(B, K)))
        vals = torch.as_tensor(rs.rand(B, K) < 0.99, device=dev)
        got = ss_mod.seg_sum_cuda(seg, [vals], S)
        equal_all([got], [ref.seg_sum_ref(seg, [vals], S)], f"seg_sum {what}")
        b = bound_ms(nbytes(seg, vals, got), B * K)
        ms = time_ms(lambda: ss_mod.seg_sum_cuda(seg, [vals], S), reps=3, inner=5)
        log(f"kernel seg_sum ({what}: B={B}, K={K}, S={S}, one bool field): bit-exact; "
            f"{nbytes(seg, vals, got)} B, device {ms:.5f} ms, bound {b[0]:.3e} ms ({b[1]})")
        del seg, vals, got


def scale_kernel_shapes(dev, rs) -> None:
    """seg_sum (the feedback call's five fields at S = 3 (NC + 1)), seg_rank
    (S = NC + 1) and reps_tick (N = NC, R = 2) at the scale rows' shapes, NC
    = 10**5 and 10**6, B = 1 and 2: bit-exact against the plain versions,
    then timed (CUDA-graph replay) beside the bound."""
    import numpy as np
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import reps_update as ru_mod
    from repro_torch.kernels import seg_rank as sr_mod
    from repro_torch.kernels import seg_sum as ss_mod

    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    K = 128  # MAX_EV = NH at FATTREE_128's shape
    for NC in (10**5, 10**6):
        for B in (1, 2):
            sq = (lambda x: x[0]) if B == 1 else (lambda x: x)
            S = 3 * (NC + 1)
            seg = rs.randint(0, S, size=(B, K))
            seg[rs.rand(B, K) < 0.3] = S  # the engine's sentinel
            seg = sq(i32(seg))
            fields = [sq(i32(rs.randint(0, 9, size=(B, K)))),
                      sq(torch.as_tensor(rs.rand(B, K) < 0.5, device=dev)),
                      sq(i32(rs.randint(0, 65536, size=(B, K)))),
                      sq(torch.as_tensor(rs.rand(B, K) < 0.3, device=dev)),
                      sq(i32(rs.randint(0, 900, size=(B, K))))]
            got = ss_mod.seg_sum_cuda(seg, fields, S)
            equal_all([got], [ref.seg_sum_ref(seg, fields, S)], f"seg_sum NC={NC} B={B} S={S}")
            ss_b = bound_ms(nbytes(seg, *fields, got), int((seg < S).sum()) * 5)
            ss_ms = time_ms(lambda: ss_mod.seg_sum_cuda(seg, fields, S), reps=3, inner=10)
            rk = rs.randint(0, NC + 1, size=(B, K))
            rk[:, ::3] = NC  # the sentinel segment, many repeats
            rk = sq(i32(rk))
            got = sr_mod.seg_rank_cuda(rk, NC + 1)
            equal_all([got], [ref.seg_rank_ref(rk, NC + 1)], f"seg_rank NC={NC} B={B}")
            sr_b = bound_ms(nbytes(rk, got), rk.numel())
            sr_ms = time_ms(lambda: sr_mod.seg_rank_cuda(rk, NC + 1), reps=3, inner=10)
            shape, n = ((NC,) if B == 1 else (B, NC)), B * NC
            r = lambda lo, hi: i32(rs.randint(lo, hi, size=n)).reshape(shape)
            bb = lambda p: torch.as_tensor(rs.rand(n) < p, device=dev).reshape(shape)
            state = [i32(rs.randint(0, 65536, size=(n, 8))).reshape(*shape, 8),
                     torch.as_tensor(rs.rand(n, 8) < 0.5, device=dev).reshape(*shape, 8),
                     r(0, 8), r(0, 9), r(0, 3), bb(0.3), r(0, 3000), r(0, 3)]
            acks = [(bb(0.5), r(0, 65536), bb(0.3)) for _ in range(2)]
            ev = [tuple(a[c] for a in acks) for c in range(3)] + [bb(0.2), bb(0.6), r(0, 65536)]
            outs = ru_mod.reps_tick_cuda(*state, *ev, 1234, 32, 800)
            equal_all(outs, ref.reps_tick_ref(*state, *ev, 1234, 32, 800),
                      f"reps_tick N={NC} B={B}")
            flat_ev = [x for e in ev for x in (e if isinstance(e, tuple) else (e,))]
            ru_b = bound_ms(nbytes(*state, *flat_ev, *outs), n * 8 * 4)
            ru_ms = time_ms(lambda: ru_mod.reps_tick_cuda(*state, *ev, 1234, 32, 800),
                            reps=3, inner=10)
            log(f"kernel at scale NC={NC} B={B}: bit-exact; seg_sum (S={S}, K={K}, five fields) "
                f"device {ss_ms:.5f} ms, bound {ss_b[0]:.3e} ms ({ss_b[1]}); seg_rank (S={NC + 1}, "
                f"K={K}) device {sr_ms:.5f} ms, bound {sr_b[0]:.3e} ms ({sr_b[1]}); reps_tick "
                f"(N={NC}, R=2) device {ru_ms:.5f} ms, bound {ru_b[0]:.3e} ms ({ru_b[1]})")
            del state, acks, ev, outs


def fabric_per_tick(reps: bool) -> dict:
    """A generated fabric's kernel launches per tick: the table form routes,
    the arithmetic routing and the flat hash never run."""
    return {"next_queue_table": 1, "next_queue": 0, "ecmp_hash": 0, "seg_sum": 4,
            "seg_rank": 1, "queue_tick": 1, "reps_tick": int(reps)}


def counted_run(what: str, sim, ticks: int, want: dict):
    """``sim.run(ticks)`` on the card with exact launch counts per tick;
    returns the final state, the launches and the seconds."""
    import torch

    from repro_torch.kernels import ops

    state = sim.init_state()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, _ = sim.run(ticks, state)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    for k, n in want.items():
        if counts[k] != n * ticks:
            raise AssertionError(f"{what}: {k} launched {counts[k]} times, expected {n} x {ticks}")
    return state, counts, secs


def fabric_phase(dev, fig18_card: dict, fig18_ticks: int, check_ticks: int) -> dict:
    """Generated fabrics at full width: (a) the clos3 table form of
    FATTREE_128_3T (``clos3:pods=4,tors=2,hosts=16,aggs=4,up=4``), fig18's
    REPS cell, equals the fig18 phase's arithmetic card run of
    ``fig18_ticks`` (its card-vs-CPU horizon) on every leaf; (b) ``rail`` and ``mesh`` at 128 hosts (8 ToRs x 16 hosts; 16
    rails, 2 planes), REPS and adaptive RoCE, a permutation of 1024-packet
    messages with ToR-0's first two up queues down from tick 100, card ==
    CPU on every leaf after ``check_ticks``.  The table form launches once
    per tick, the arithmetic routing and the flat hash never.  Returns the
    launches per kernel."""
    from repro_torch.configs import FATTREE_128, FATTREE_128_3T
    from repro_torch.core import make_lb
    from repro_torch.kernels import ops
    from repro_torch.netsim import (
        Simulator, Topology, failures, sim_state_to_numpy, summarize, workloads,
    )

    totals = {k: 0 for k in ops.KERNEL_MODULES}
    cfg = FATTREE_128_3T.replace(fabric=TABLE_FABRICS[0])
    sim = Simulator(cfg, workloads.permutation(cfg.n_hosts, 2048, seed=3),
                    make_lb("reps", evs_size=cfg.evs_size), device=dev)
    state, counts, secs = counted_run("clos3/reps", sim, fig18_ticks, fabric_per_tick(True))
    for k, n in counts.items():
        totals[k] += n
    same_leaves(sim_state_to_numpy(state), fig18_card, "clos3 vs arithmetic FATTREE_128_3T")
    s = summarize(sim, state)
    log(f"fabric clos3 ({TABLE_FABRICS[0]}) REPS: {fig18_ticks} ticks in {secs:.3f} s = "
        f"{fig18_ticks / secs:.1f} ticks/s; completed={s.completed}/{s.n_conns}; all "
        f"{len(fig18_card)} SimState leaves bit-equal to the arithmetic FATTREE_128_3T run "
        f"(fig18) at tick {fig18_ticks}; launches={counts}")
    for fabric in TABLE_FABRICS[1:3]:
        cfg = FATTREE_128.replace(fabric=fabric)
        ups = [int(q) for q in Topology.build(cfg).t0_up_queues(0)[:2]]
        for lbn in ("reps", "adaptive_roce"):
            finals = []
            for d in (dev, "cpu"):
                sim = Simulator(cfg, workloads.permutation(cfg.n_hosts, 1024, seed=3),
                                make_lb(lbn, evs_size=cfg.evs_size),
                                failures=failures.link_down(ups, 100, failures.FOREVER),
                                device=d)
                t0 = time.perf_counter()
                if d == dev:
                    state, counts, secs = counted_run(f"{fabric}/{lbn}", sim, check_ticks,
                                                      fabric_per_tick(lbn == "reps"))
                    for k, n in counts.items():
                        totals[k] += n
                else:
                    state, _ = sim.run(check_ticks)
                finals.append(sim_state_to_numpy(state))
                log(f"fabric {fabric} {lbn}: {check_ticks} ticks on {d} in "
                    f"{time.perf_counter() - t0:.3f} s")
            same_leaves(*finals, f"{fabric}/{lbn}")
            st = finals[0]["s_stats"]
            log(f"card vs CPU: fabric {fabric} {lbn}: all {len(finals[0])} SimState leaves "
                f"bit-equal after {check_ticks} ticks (delivered={int(st[3])}, "
                f"drops_fail={int(st[1])}); launches={counts}")
    return totals


def active_set_invariant(what: str, NP: int, state) -> None:
    """``as_idx`` ascending, exactly the non-FREE slots; ``as_count +
    fl_count == NP``."""
    import numpy as np

    from repro_torch.netsim.engine import FREE, PS

    idx = state.as_idx.cpu().numpy()
    live = idx[idx < NP]
    nonfree = np.nonzero(state.pkt[PS, :NP].cpu().numpy() != FREE)[0]
    if not (np.all(np.diff(live) > 0) and np.array_equal(live, nonfree)
            and int(state.as_count) == len(live)
            and int(state.as_count) + int(state.fl_count) == NP):
        raise AssertionError(f"{what}: the active set is not the ascending non-FREE slots "
                             f"({len(live)} entries, as_count={int(state.as_count)}, "
                             f"fl_count={int(state.fl_count)}, NP={NP})")


def scale_row_cpu(n: int, ticks: int) -> tuple:
    """``bench/scale_smoke.py``'s row of ``n`` connections for ``ticks`` on
    the CPU, for a helper process: ``(SimState leaves, run_row's info)``."""
    import torch

    from repro_torch.bench.scale_smoke import run_row
    from repro_torch.netsim import sim_state_to_numpy

    torch.set_num_threads(2)
    eng, res, info = run_row(n, ticks, device="cpu")
    return sim_state_to_numpy(res.state_for(eng.cases[0].name)), info


def scale_phase(dev, dense_reps, row5_ticks: int, row6_ticks: int, prof_ticks: int,
                cpu_row5) -> dict:
    """Scale mode on the card: (a) fig06/reps with ``conn_sharding=True``
    (A == NP) equals the dense card run ``dense_reps`` (the card-vs-CPU
    phase's run of the main path's cell: ``(simulator, state, ticks)``) on
    every leaf but as_idx / as_count, the active set holds exactly the
    non-FREE slots, and device launches per tick of the sparse tick against
    the dense one from there; (b) a
    small cell with ``active_slots`` binding, card == CPU; (c) the 10**5 row
    (``bench/scale_smoke.py``'s, 150 ticks by default) card == CPU, the
    CPU's run ``cpu_row5`` (the pending result of ``scale_row_cpu`` in a
    helper process); (d) the 10**6 row
    through ``SweepEngine(collect="none")`` with exact launch counts: done >
    0, NP = A by the lifetime bound, ticks/s, peak memory, and a profiled
    window (device busy share, launches per tick); its live REPS state packs
    to <= 25 B/conn and round-trips, and ``measure_scale(10**6)``.  Returns
    the launches per kernel."""
    import torch

    from repro_torch.bench.common import Rows
    from repro_torch.bench.scale_smoke import run_row
    from repro_torch.bench.table1_footprint import check_roundtrip, measure_scale
    from repro_torch.core import make_lb
    from repro_torch.kernels import ops
    from repro_torch.netsim import Simulator, SimConfig, sim_state_to_numpy, workloads
    from repro_torch.netsim.engine import ST_ALLOC_FAIL, tree_map

    totals = {k: 0 for k in ops.KERNEL_MODULES}
    t_start = time.perf_counter()

    def step_done(what):
        log(f"scale phase: {what} done at {time.perf_counter() - t_start:.1f} s")

    # (a) sparse == dense at fig06/reps
    dense_sim, dense_state, main_ticks = dense_reps
    (cfg, wl, lb), kw = fig06_scenario("reps")
    sim = Simulator(cfg.replace(conn_sharding=True), wl, lb, **kw, device=dev)
    if (sim.NP, sim.A) != (dense_sim.NP, dense_sim.NP):
        raise AssertionError(f"fig06 scale mode: NP={sim.NP} A={sim.A}, dense NP={dense_sim.NP}")
    state, counts, secs = counted_run("fig06/reps sparse", sim, main_ticks, FLEET_PER_TICK)
    for k, n in counts.items():
        totals[k] += n
    active_set_invariant("fig06/reps sparse", sim.NP, state)
    a, b = sim_state_to_numpy(state), sim_state_to_numpy(dense_state)
    for k in ("as_idx", "as_count"):
        a.pop(k), b.pop(k)
    same_leaves(a, b, "fig06/reps sparse vs dense")
    log(f"scale mode fig06/reps (NP = A = {sim.NP}): {main_ticks} ticks in {secs:.3f} s = "
        f"{main_ticks / secs:.1f} ticks/s; all {len(a)} SimState leaves but as_idx / as_count "
        f"bit-equal to the cell's dense card run; active set: {int(state.as_count)} "
        f"ascending non-FREE slots, as_count + fl_count == NP")
    win = 20  # profiled ticks of each tick body
    for label, s, st, t in (("dense", dense_sim, dense_state, main_ticks),
                            ("sparse", sim, state, main_ticks)):
        draws = s.tick_draws(s.base_key, t, win)
        cur = {"state": st}

        def step(i, s=s, t=t, draws=draws, cur=cur):
            cur["state"], _ = s.tick_fn(cur["state"], t + i, draws.row(i))

        profile_ticks(f"fig06/reps {label}, ticks {t}-{t + win}", step, win)
    step_done("(a) fig06 sparse vs dense")

    # (b) a binding active set, card == CPU
    small = SimConfig(n_hosts=16, hosts_per_tor=4, uplinks_per_tor=4, rto_ticks=120,
                      conn_sharding=True, active_slots=48)
    finals = []
    for d in (dev, "cpu"):
        s = Simulator(small, workloads.permutation(16, 24, seed=3),
                      make_lb("reps", evs_size=small.evs_size), seed=7, device=d)
        st, _ = s.run(300)
        finals.append(sim_state_to_numpy(st))
    same_leaves(*finals, "active_slots=48")
    fails = int(finals[0]["s_stats"][ST_ALLOC_FAIL])
    if fails == 0:
        raise AssertionError("active_slots=48 did not bind: no alloc failure")
    log(f"card vs CPU: scale mode with active_slots=48 (16 hosts, 300 ticks): all "
        f"{len(finals[0])} SimState leaves bit-equal; alloc failures {fails}")
    step_done("(b) binding active set")

    # (c) the 10**5 row, card == CPU (the CPU's run in a helper process,
    # started with the phase)
    finals = []
    for d in (dev, "cpu"):
        if d == dev:
            eng, res, info = run_row(10**5, row5_ticks, device=d)
            finals.append(sim_state_to_numpy(res.state_for(eng.cases[0].name)))
        else:
            leaves, info = cpu_row5.get(timeout=900)
            finals.append(leaves)
        log(f"scale row 10**5 on {d}: {row5_ticks} ticks, exec {info['exec_wall_s']:.3f} s = "
            f"{info['ticks_per_sec']:.1f} ticks/s; done={info['done']} NP={info['NP']} "
            f"A={info['A']} NC padded {info['NC_padded']}")
        if d == dev:
            for k, n in FLEET_PER_TICK.items():
                if info["launches_per_tick"][k] != n:
                    raise AssertionError(f"scale row 10**5: {k} {info['launches_per_tick'][k]} "
                                         f"launches per tick, expected {n}")
                totals[k] += n * row5_ticks
    same_leaves(*finals, "scale row 10**5")
    log(f"card vs CPU: scale row 10**5: all {len(finals[0])} SimState leaves bit-equal after "
        f"{row5_ticks} ticks")
    del finals
    step_done("(c) 10**5 row")

    # (d) the 10**6 row on the card
    eng, res, info = run_row(10**6, row6_ticks, device=dev)
    bucket = eng.buckets[0]
    sim6 = bucket.sim
    if (info["NP"], info["A"]) != (sim6._active_bound(), sim6._active_bound()):
        raise AssertionError(f"scale row 10**6: NP={info['NP']} A={info['A']}, lifetime bound "
                             f"{sim6._active_bound()}")
    for k, n in FLEET_PER_TICK.items():
        if info["launches_per_tick"][k] != n:
            raise AssertionError(f"scale row 10**6: {k} {info['launches_per_tick'][k]} "
                                 f"launches per tick, expected {n}")
        totals[k] += n * row6_ticks
    log(f"scale row 10**6: {row6_ticks} ticks, exec {info['exec_wall_s']:.3f} s = "
        f"{info['ticks_per_sec']:.2f} ticks/s (wall with set-up {info['wall_s']:.3f} s); "
        f"done={info['done']} of {info['conns']} (NC padded {info['NC_padded']}); NP = A = {info['NP']} "
        f"(the lifetime bound); peak memory {info['peak_mem_bytes']} B = "
        f"{info['peak_mem_bytes'] / 2**30:.3f} GiB; kernel launches per tick "
        f"{ {k: v for k, v in info['launches_per_tick'].items() if v} }")
    final = bucket.final_state
    states = tree_map(lambda x: x.to(dev), final)
    n_prof = prof_ticks
    chunk = sim6.draw_chunk(states.q_len.shape[0])
    cur = {"states": states, "draws": None}

    def step(i):
        t = row6_ticks + i
        if i % chunk == 0:
            cur["draws"] = sim6.tick_draws(bucket.keys, t, min(chunk, n_prof - i), bucket.scn)
        cur["states"], _ = sim6.step_rows(cur["states"], t, cur["draws"].row(i % chunk),
                                          bucket.scn, trace=False)

    profile_ticks(f"scale row 10**6, ticks {row6_ticks}-{row6_ticks + n_prof} (draws every "
                  f"{chunk} ticks included)", step, n_prof)
    del states, cur
    reps_state = tree_map(lambda x: x[0], final.lb_state[1][0])  # the row's REPS slot
    lbv = bucket.lb.variants[0]
    bpc = check_roundtrip(lbv.cfg, reps_state)
    if bpc > 25:
        raise AssertionError(f"scale row 10**6: packed REPS state {bpc} B/conn > 25")
    live = int((reps_state.n_cached > 0).sum())
    log(f"scale row 10**6: the row's live REPS state ({reps_state.head.shape[0]} conns, "
        f"{live} with cached EVs) packs to {bpc:.3f} B/conn and round-trips exactly")
    del final, res, eng, bucket, reps_state
    rows = Rows(device="cuda")
    bpc = measure_scale(10**6, rows, device=dev)
    log(f"scale measure_scale(10**6) on the card: {bpc:.3f} B/conn, round trip exact")
    step_done("(d) 10**6 row")
    torch.cuda.empty_cache()
    return totals


# ---------------------------------------------------------------------------
def fig06_scenario(lb_name: str) -> tuple:
    """The FATTREE_128 fig06 cell: permutation of 4096-packet messages under
    two transient ToR-0 uplink failures; ``(cfg, workload, lb, failures=,
    watch_queues=)`` as ``Simulator`` and ``FleetRunner`` take them."""
    from repro_torch.configs import FATTREE_128
    from repro_torch.core import make_lb
    from repro_torch.netsim import FailureSchedule, Topology, failures, workloads

    cfg = FATTREE_128
    ups = Topology.build(cfg).t0_up_queues(0)
    fs = FailureSchedule.concat(
        failures.link_down([int(ups[0])], 150, 800),
        failures.link_down([int(ups[1])], 1200, 2400),
    )
    wl = workloads.permutation(cfg.n_hosts, 4096, seed=3)
    kw = dict(evs_size=cfg.evs_size)
    if lb_name == "reps":
        kw.update(freezing_timeout=800)
    return (cfg, wl, make_lb(lb_name, **kw)), dict(failures=fs, watch_queues=ups)


def fig06_cell(lb_name: str, device, seed: int = 0):
    from repro_torch.netsim import Simulator

    args, kw = fig06_scenario(lb_name)
    return Simulator(*args, **kw, seed=seed, device=device)


def fig06_fleet(seeds, device):
    """The fig06/reps cell under ``seeds``, one row each."""
    from repro_torch.netsim import FleetRunner

    args, kw = fig06_scenario("reps")
    return FleetRunner(*args, **kw, seeds=tuple(seeds), device=device)


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


def main_path(dev, ticks: int) -> tuple[dict, dict, dict]:
    """The fig06 OPS and REPS cells for ``ticks`` ticks with exact launch
    counts; returns the launches per kernel, the ticks/s per cell and each
    cell's ``(simulator, final state, ticks)`` (the sweep phase continues
    them as its serial references)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.netsim import summarize

    # the routing step is one next_queue launch; the flat hash runs no more
    per_tick = {"ops": {"seg_sum": 4, "seg_rank": 1, "queue_tick": 1, "reps_tick": 0,
                        "next_queue": 1, "ecmp_hash": 0},
                "reps": {"seg_sum": 4, "seg_rank": 1, "queue_tick": 1, "reps_tick": 1,
                         "next_queue": 1, "ecmp_hash": 0}}
    totals = {k: 0 for k in ops.KERNEL_MODULES}
    rates, finals = {}, {}
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
        rates[lb] = ticks / secs
        finals[lb] = (sim, state, ticks)
    return totals, rates, finals


def profile_window(dev, warm: int, ticks: int) -> None:
    """Where a main-path tick's time goes: ``torch.profiler`` over ``ticks``
    ticks of the REPS cell (after ``warm`` ticks): wall time per tick, the
    device's busy share (summed kernel time / wall; one stream, so kernels
    do not overlap), device launches per tick and the port's kernels'
    device time per launch inside the real tick."""
    sim = fig06_cell("reps", dev)
    state, _ = sim.run(warm)
    draws = sim.tick_draws(sim.base_key, warm, ticks)

    def step(i):
        nonlocal state
        state, _ = sim.tick_fn(state, warm + i, draws.row(i))

    profile_ticks(f"REPS, ticks {warm}-{warm + ticks}", step, ticks)


# (a substring of the device names of each port kernel's launches, the kernel)
KERNEL_KEYS = (("seg_sum", "seg_sum"), ("seg_rank_", "seg_rank"),
               ("reps_tick_kernel", "reps_tick"), ("queue_tick_kernel", "queue_tick"),
               ("ecmp_hash_kernel", "ecmp_hash"), ("next_queue_kernel", "next_queue"))


def profile_ticks(label: str, step, ticks: int) -> None:
    """``step(i)`` for ``i < ticks`` under ``torch.profiler``: wall time per
    tick, the device's busy share, device launches per tick, and the port's
    kernels' device time per launch inside the real tick."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # the device trace alone: the host's op events are not read here, and
    # processing them took most of a window's seconds
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(ticks):
            step(i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_events:
        log(f"profile ({label}): the profiler recorded no device time; busy share not measured")
        return
    busy_us = sum(e.time_range.elapsed_us() for e in dev_events)
    by_name = collections.defaultdict(list)
    for e in dev_events:
        by_name[e.name].append(e.time_range.elapsed_us())
    ours = {}
    for key, tag in KERNEL_KEYS:
        durs = [d for n, ds in by_name.items() if key in n for d in ds]
        if durs:
            ours[tag] = (len(durs) / ticks, statistics.median(durs), sum(durs) / ticks)
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:6]
    log(f"profile ({label}): {wall_us / ticks:.1f} us wall per tick "
        f"(profiler on), device busy {busy_us / ticks:.1f} us per tick = "
        f"{100 * busy_us / wall_us:.2f} % busy, {len(dev_events) / ticks:.1f} device "
        f"launches per tick")
    for tag, (per_tick, med, tot) in ours.items():
        log(f"profile ({label}): {tag}: {per_tick:.1f} launches per tick, median {med:.2f} us "
            f"device per launch, {tot:.2f} us per tick")
    for name, durs in top:
        log(f"profile top ({label}): {sum(durs) / ticks:8.2f} us/tick {len(durs) / ticks:5.1f}x  "
            f"{name[:90]}")


def fig18_cell(device):
    """fig18's 3-tier fabric at full width: FATTREE_128_3T (128 hosts, 8 ToRs
    in 4 pods of 2, 4 aggs per pod with 4 core uplinks each, 16 cores), a
    permutation of 2048-packet messages, REPS, no failures
    (``benchmarks/fig18_three_tier.py`` at full scale)."""
    from repro_torch.configs import FATTREE_128_3T
    from repro_torch.core import make_lb
    from repro_torch.netsim import Simulator, workloads

    cfg = FATTREE_128_3T
    return Simulator(cfg, workloads.permutation(cfg.n_hosts, 2048, seed=3),
                     make_lb("reps", evs_size=cfg.evs_size), device=device)


def three_tier_cell(dev, ticks: int, check_ticks: int) -> tuple[dict, dict]:
    """The fig18/3tier/reps cell on the card with exact launch counts, every
    queue region carrying traffic; then card == CPU on every SimState leaf
    after ``check_ticks``.  Returns the launches per kernel and the leaves
    of the card run of ``check_ticks`` (``sim_state_to_numpy``)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.netsim import sim_state_to_numpy, summarize

    sim = fig18_cell(dev)
    topo = sim.topo
    log(f"fig18/3tier/reps sizes: NQ={sim.NQ} MAX_ARR={sim.MAX_ARR} NP={sim.NP} "
        f"NC={sim.wl.n_conns} regions t0_up={topo.t0_up_base} agg_up={topo.agg_up_base} "
        f"core_down={topo.core_down_base} agg_down={topo.agg_down_base} "
        f"t0_down={topo.t0_down_base}")
    state = sim.init_state()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, _ = sim.run(ticks, state)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = ops.launch_counts()
    s = summarize(sim, state)
    check_invariants(sim, state)
    log(f"main path fig18/3tier/reps: {ticks} ticks in {secs:.3f} s = {ticks / secs:.1f} "
        f"ticks/s; runtime_ticks={s.runtime_ticks} completed={s.completed}/{s.n_conns} "
        f"drops_cong={s.drops_cong} timeouts={s.timeouts} launches={counts}")
    want = {"next_queue": 1, "ecmp_hash": 0, "reps_tick": 1, "seg_sum": 4, "queue_tick": 1,
            "seg_rank": 1}
    for k, n in want.items():
        if counts[k] != n * ticks:
            raise AssertionError(
                f"fig18/3tier/reps: {k} launched {counts[k]} times, expected {n} x {ticks}")
    served = state.q_served.cpu()
    bounds = [0, topo.agg_up_base, topo.core_down_base, topo.agg_down_base,
              topo.t0_down_base, topo.n_queues]
    per_region = [int(served[lo:hi].sum()) for lo, hi in zip(bounds[:-1], bounds[1:])]
    if min(per_region) == 0:
        raise AssertionError(f"fig18/3tier/reps: a queue region served nothing: {per_region}")
    log(f"fig18/3tier/reps: packets served per region (ToR up, agg up, core down, agg down, "
        f"host down): {per_region}")
    finals = []
    for d in (dev, "cpu"):
        t0 = time.perf_counter()
        st, _ = fig18_cell(d).run(check_ticks)
        finals.append(sim_state_to_numpy(st))
        log(f"card vs CPU: fig18/3tier/reps {check_ticks} ticks on {d} in "
            f"{time.perf_counter() - t0:.3f} s")
    same_leaves(*finals, "fig18/3tier/reps")
    log(f"card vs CPU: fig18/3tier/reps: all {len(finals[0])} SimState leaves bit-equal after "
        f"{check_ticks} ticks")
    return counts, finals[0]


def arena_cells(dev, ticks: int) -> dict:
    """The arena's failure block at FATTREE_128 for every zoo load balancer
    beyond ECMP/OPS/REPS, and mixed(REPS + ECMP) on fig05's cohort, each
    with exact launch counts, ``ticks`` each but the first (PLB), which runs
    100 ticks past 150 + the RTO so that its timeouts are asserted; returns
    the launches per kernel."""
    import numpy as np
    import torch

    from repro_torch.configs import FATTREE_128
    from repro_torch.core import REGISTRY, make_lb
    from repro_torch.kernels import ops
    from repro_torch.netsim import Simulator, failures, summarize, workloads

    cfg = FATTREE_128
    fs = failures.random_down_uplinks(cfg, 0.05, 150, failures.FOREVER, seed=7)
    wl = workloads.permutation(cfg.n_hosts, 1024, seed=3)
    wl05, bg = workloads.permutation_with_background(cfg.n_hosts, 2048, 0.1, seed=1)
    bg_conns = tuple(int(i) for i in np.nonzero(bg)[0])
    cells = [(n, wl, {}) for n in ZOO]
    cells.append(("mixed", wl05, dict(fg="reps", bg="ecmp", bg_conns=bg_conns)))
    assert set(ZOO) | {"ecmp", "ops", "reps", "mixed"} == set(REGISTRY), sorted(REGISTRY)
    totals = {k: 0 for k in ops.KERNEL_MODULES}
    for i, (lbn, w, kw) in enumerate(cells):
        sim = Simulator(cfg, w, make_lb(lbn, evs_size=cfg.evs_size, **kw), failures=fs,
                        device=dev)
        n_t = max(ticks, 150 + cfg.rto_ticks + 100) if i == 0 else ticks
        state = sim.init_state()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, _ = sim.run(n_t, state)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        s = summarize(sim, state)
        check_invariants(sim, state)
        log(f"arena failure/{sim.lb.name}: {n_t} ticks in {secs:.3f} s = "
            f"{n_t / secs:.1f} ticks/s; completed={s.completed}/{s.n_conns} "
            f"runtime_ticks={s.runtime_ticks} drops_cong={s.drops_cong} "
            f"drops_fail={s.drops_fail} timeouts={s.timeouts} launches={counts}")
        want = {"seg_sum": 4, "seg_rank": 1, "queue_tick": 1,
                # one routing launch for every LB, adaptive RoCE's
                # least-loaded pick included; the hash is inside it
                "next_queue": 1, "ecmp_hash": 0,
                "reps_tick": 1 if lbn == "mixed" else 0}
        for k, n in want.items():
            if counts[k] != n * n_t:
                raise AssertionError(
                    f"arena/{lbn}: {k} launched {counts[k]} times, expected {n} x {n_t}")
            totals[k] += counts[k]
        # uplinks go down at tick 150: past 150 + RTO a hashing LB must have timed out
        if n_t > 150 + cfg.rto_ticks and s.timeouts == 0 and not sim.lb.switch_adaptive:
            raise AssertionError(f"arena/{lbn}: no timeout fired in {n_t} ticks")
    return totals


FLEET_PER_TICK = {"seg_sum": 4, "seg_rank": 1, "queue_tick": 1, "next_queue": 1,
                  "reps_tick": 1, "ecmp_hash": 0}  # fig06/reps: whatever the fleet's B


def fleet_counts(counts: dict, ticks: int, what: str) -> None:
    for k, n in FLEET_PER_TICK.items():
        if counts[k] != n * ticks:
            raise AssertionError(f"{what}: {k} launched {counts[k]} times, expected {n} x {ticks}")


def fleet_phase(dev, rows_ticks: int, check_ticks: int, bench_ticks: int, rounds: int,
                warm: int, one_run_rate: float) -> dict:
    """The fig06/reps cell as a fleet of seeds (``FleetRunner``): (a) B = 4
    rows equal four serial card runs on every SimState leaf and trace field;
    (b) a small fleet (FATTREE_32_CI, B = 3) is the same on the card and on
    the CPU; (c) each kernel's launches per tick are exact and the same at
    every B; (d) row-ticks/s against B in (1, 4, 16, 64), ``rounds`` rounds
    with the B values interleaved, ``bench_ticks`` ticks each from a state
    warmed for ``warm`` ticks, each also set against ``one_run_rate`` (the
    main path's fig06/reps ticks/s over its whole run); (e) a profiled
    window of 100 ticks at B = 64.  Returns the launches of the fleet runs
    per kernel, and the warmed B = 64 fleet ``(fleet, states, warm)``."""
    import torch

    from repro_torch.configs import FATTREE_32_CI
    from repro_torch.core import make_lb
    from repro_torch.kernels import ops
    from repro_torch.netsim import FleetRunner, Topology, failures, sim_state_to_numpy, workloads
    from repro_torch.netsim.engine import tree_map

    totals = {k: 0 for k in ops.KERNEL_MODULES}
    t_start = time.perf_counter()

    def step_done(what):  # where the phase's seconds go
        log(f"fleet phase: {what} done at {time.perf_counter() - t_start:.1f} s")

    def counted(what, ticks, fn):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        fleet_counts(counts, ticks, what)
        for k, n in counts.items():
            totals[k] += n
        return out, secs, counts

    # (a) rows == serial runs, at full width
    seeds = (0, 1, 2, 3)
    fleet = fig06_fleet(seeds, dev)
    (states, traces), secs, counts = counted("fleet B=4", rows_ticks, lambda: fleet.run(rows_ticks))
    log(f"fleet fig06/reps B=4: {rows_ticks} ticks in {secs:.3f} s = "
        f"{4 * rows_ticks / secs:.1f} row-ticks/s; launches={counts}")
    for i, s in enumerate(seeds):
        st, tr = fig06_cell("reps", dev, seed=s).run(rows_ticks)
        same_leaves(sim_state_to_numpy(fleet.state_at(states, i)), sim_state_to_numpy(st),
                    f"fleet row {i} vs serial seed {s}")
        for f in tr._fields:
            if not torch.equal(getattr(traces, f)[:, i], getattr(tr, f)):
                raise AssertionError(f"fleet row {i}: trace {f} differs from serial seed {s}")
    sums = fleet.summaries(states)
    log(f"fleet rows == serial: all {len(sim_state_to_numpy(st))} SimState leaves and all "
        f"{len(tr._fields)} trace fields of each of the {len(seeds)} rows bit-equal to a serial "
        f"card run of its seed after {rows_ticks} ticks (completed per row "
        f"{[x.completed for x in sums]}, timeouts {[x.timeouts for x in sums]})")
    del fleet, states, traces
    step_done("(a) rows == serial")

    # (b) card == CPU, a small fleet
    cfg = FATTREE_32_CI
    ups = [int(q) for q in Topology.build(cfg).t0_up_queues(0)[:2]]
    finals = []
    for d in (dev, "cpu"):
        small = FleetRunner(cfg, workloads.permutation(32, 48, seed=3),
                            make_lb("reps", evs_size=cfg.evs_size, freezing_timeout=200),
                            failures=failures.link_down(ups, 30, 300), seeds=(0, 5, 9), device=d)
        st, _ = small.run(check_ticks)
        finals.append([sim_state_to_numpy(small.state_at(st, i)) for i in range(small.n_runs)])
    for i, (a, b) in enumerate(zip(*finals)):
        same_leaves(a, b, f"small fleet row {i}")
    log(f"card vs CPU: fleet FATTREE_32_CI/reps B=3: all {len(finals[0][0])} SimState leaves "
        f"of every row bit-equal after {check_ticks} ticks")
    step_done("(b) card == CPU")

    # (c) + (d) launches per tick and row-ticks/s against B, interleaved.
    # One B = 64 fleet of seeds 0..63 is warmed; the fleet of seeds 0..B-1
    # is its first B rows (rows equal serial runs, as (a) holds)
    Bs = (1, 4, 16, 64)
    big = fig06_fleet(range(max(Bs)), dev)
    sim, keys = big.sim, big.base_keys()
    (warmed, _), _, _ = counted(f"fleet B={max(Bs)} warm-up", warm, lambda: big.run(warm))
    starts = {B: tree_map(lambda t: t[:B], warmed) for B in Bs}
    rows_draws = {B: sim.tick_draws(keys[:B], warm, bench_ticks) for B in Bs}
    step_done(f"B = {max(Bs)} warm-up")

    def bench(B):
        st, d = starts[B], rows_draws[B]
        for i in range(bench_ticks):  # ticks warm .. warm + bench_ticks - 1
            st, _ = sim.step_rows(st, warm + i, d.row(i))
        return st

    rate = {B: [] for B in Bs}
    for r in range(rounds):
        for B in (Bs if r % 2 == 0 else Bs[::-1]):
            _, secs, counts = counted(f"fleet B={B}", bench_ticks, lambda: bench(B))
            rate[B].append(B * bench_ticks / secs)
            log(f"fleet bench round {r} B={B}: {bench_ticks} ticks (from tick {warm}) in "
                f"{secs:.3f} s = {bench_ticks / secs:.2f} ticks/s = {B * bench_ticks / secs:.1f} "
                f"row-ticks/s; launches per tick "
                f"{ {k: n / bench_ticks for k, n in counts.items()} }")
    base = statistics.median(rate[1])
    for B in Bs:
        med = statistics.median(rate[B])
        log(f"fleet row-ticks/s B={B}: median {med:.1f} (min {min(rate[B]):.1f}, max "
            f"{max(rate[B]):.1f}, {len(rate[B])} rounds), {1e3 * B / med:.3f} ms per tick, "
            f"{med / base:.2f}x B=1, {med / one_run_rate:.2f}x the main path's one run "
            f"({one_run_rate:.1f} ticks/s)")

    step_done("(c) + (d) rounds")

    # (e) where a B = 64 tick's time goes
    B, st = max(Bs), warmed
    draws = sim.tick_draws(keys, warm, 100)

    def step(i):
        nonlocal st
        st, _ = sim.step_rows(st, warm + i, draws.row(i))

    profile_ticks(f"fleet B={B}, ticks {warm}-{warm + 100}", step, 100)
    return totals, (big, warmed, warm)


TEL_PER_TICK = dict(FLEET_PER_TICK, seg_sum=6)  # + one seg_sum per histogram of the default spec


def fig08_fig06_rows():
    """Phase (a)'s four rows at FATTREE_128 with REPS (freezing timeout
    800): fig08's REPS column at 12.5, 25 and 50 % of the ToR uplinks down
    from tick 150 on (``random_down_uplinks(cfg, frac, 150, FOREVER,
    seed=11)`` on ``permutation(128, 2048, seed=5)``), then the fig06 cell
    (two transient ToR-0 uplink windows on ``permutation(128, 4096,
    seed=3)``), at one set of pinned shapes (``msg_slots`` 4096,
    ``failure_slots`` the largest schedule's); each row's ``(args, kw)`` as
    ``Simulator`` takes them."""
    from repro_torch.core import make_lb
    from repro_torch.netsim import failures, workloads

    (cfg, wl6, _), kw6 = fig06_scenario("reps")
    wl8 = workloads.permutation(cfg.n_hosts, 2048, seed=5)
    fs8 = [failures.random_down_uplinks(cfg, f, 150, failures.FOREVER, seed=11)
           for f in (0.125, 0.25, 0.5)]
    pinned = cfg.replace(msg_slots=4096,
                         failure_slots=max(len(f) for f in fs8 + [kw6["failures"]]))
    lb = lambda: make_lb("reps", evs_size=cfg.evs_size, freezing_timeout=800)
    rows = [((pinned, wl8, lb()), dict(failures=f, watch_queues=kw6["watch_queues"]))
            for f in fs8]
    rows.append(((pinned, wl6, lb()), kw6))
    return rows


def small_rows():
    """Phase (b)'s three FATTREE_32_CI rows, REPS: a shifted permutation
    with two uplinks down; a tornado with staggered starts under a degraded
    and a down window; a shifted permutation whose second half waits on the
    first under gray loss (p = 0.3) and a down window; each its own watch
    list."""
    import numpy as np

    from repro_torch.configs import FATTREE_32_CI
    from repro_torch.core import make_lb
    from repro_torch.netsim import FailureSchedule, Topology, Workload, failures

    cfg = FATTREE_32_CI.replace(msg_slots=64, conns_per_host=2, failure_slots=6)
    ups = [int(q) for q in Topology.build(cfg).t0_up_queues(0)]
    rs = np.random.RandomState(0)
    i32 = lambda a: np.asarray(a, np.int32)
    hosts = np.arange(32)
    none = np.full(32, -1)
    wls = [Workload(i32(hosts), i32((hosts + 3) % 32), i32(rs.randint(8, 49, 32)),
                    i32(0 * hosts), i32(none)),
           Workload(i32(hosts), i32((hosts + 16) % 32), i32(np.full(32, 64)),
                    i32(rs.randint(0, 60, 32)), i32(none)),
           Workload(i32(hosts), i32((hosts + 5) % 32), i32(rs.randint(4, 33, 32)),
                    i32(0 * hosts), i32(np.where(hosts >= 16, hosts - 16, -1)))]
    fss = [failures.link_down(ups[:2], 20, failures.FOREVER),
           FailureSchedule.concat(failures.link_degraded([ups[2]], 20, 300),
                                  failures.link_down([ups[5]], 100, 250)),
           FailureSchedule.concat(failures.gray_loss([ups[1]], 10, 350, 0.3),
                                  failures.link_down([ups[3]], 150, failures.FOREVER))]
    watch = [ups[:4], ups[4:8], [ups[0], ups[3], ups[6], 7]]
    lb = lambda: make_lb("reps", evs_size=cfg.evs_size, freezing_timeout=250)
    return [((cfg, w, lb()), dict(failures=f, watch_queues=np.asarray(q)))
            for w, f, q in zip(wls, fss, watch)]


def row_fleet(rows, seeds, dev):
    """A fleet over ``rows`` (each ``(args, kw)`` as ``Simulator`` takes
    them), one seed each, and the rows' stacked scenarios."""
    from repro_torch.netsim import FleetRunner, Simulator, stack_scenarios

    args, kw = rows[0]
    fleet = FleetRunner(*args, **kw, seeds=seeds, device=dev)
    scn = stack_scenarios([Simulator(*a, **k, device=dev).scn for a, k in rows])
    return fleet, scn


TICK_RANGE = "chip_smoke_tick"  # the profiler range around each tick of a window
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync")


def launches_per_tick(prof) -> list:
    """The device work each tick of a profiled window launched, by name: the
    host's launch calls inside each ``TICK_RANGE`` range, named by the
    device event of the same correlation id (the call's own name where the
    trace lost it).  Counted per tick, so that events the trace drops in
    one tick (it drops a few dozen in some windows) change that tick only."""
    import bisect
    import collections

    import torch

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.events()
    # the ranges on the host's timeline (the trace repeats each on the device's)
    ticks = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == TICK_RANGE and e.device_type == cpu)
    on_device = {e.id: e.name for e in events if e.device_type == cuda and e.name != TICK_RANGE}
    starts = [lo for lo, _ in ticks]
    rows = [collections.Counter() for _ in ticks]
    for e in events:
        if e.device_type == cpu and e.name.startswith(LAUNCH_CALLS):
            i = bisect.bisect_right(starts, e.time_range.start) - 1
            if i >= 0 and e.time_range.start <= ticks[i][1]:
                rows[i][on_device.get(e.id, e.name)] += 1
    return rows


def telemetry_phase(dev, ticks: int, check_ticks: int, bench_ticks: int, rounds: int,
                    warmed) -> dict:
    """The summary path (``FleetRunner.run_summary``, default telemetry) on
    the card: (a) four heterogeneous rows at full width (fig08's REPS
    column and fig06) equal their serial card runs on every SimState leaf
    and telemetry slot; (b) a FATTREE_32_CI fleet of three rows, each its
    own scenario, with cohort channels: card == CPU, carry and leaves; (c)
    launches per tick by name with the default spec against without it, at
    B = 1 and 64 on fig06/reps (the telemetry's the same at both), and no
    device-to-host copy or synchronize per tick; (d) row-ticks/s of
    ``run_summary`` against ``run_rows`` (``run``'s body) at B = 1 and 64,
    both resumed at the fleet phase's warmed rows, interleaved rounds.
    Returns the launches per kernel."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels import ops
    from repro_torch.netsim import FleetRunner, TelemetrySpec, sim_state_to_numpy
    from repro_torch.netsim.engine import tree_map

    totals = {k: 0 for k in ops.KERNEL_MODULES}
    t_start = time.perf_counter()

    def step_done(what):
        log(f"telemetry phase: {what} done at {time.perf_counter() - t_start:.1f} s")

    def counted(what, n, fn, per_tick=TEL_PER_TICK):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        for k, m in per_tick.items():
            if counts[k] != m * n:
                raise AssertionError(f"{what}: {k} launched {counts[k]} times, expected {m} x {n}")
        for k, m in counts.items():
            totals[k] += m
        return out, secs, counts

    # (a) four heterogeneous rows at full width == their serial card runs
    rows = fig08_fig06_rows()
    seeds = (0, 1, 2, 3)
    names = ("fig08/fail12pct", "fig08/fail25pct", "fig08/fail50pct", "fig06")
    fleet, scn = row_fleet(rows, seeds, dev)
    (states, tel), secs, counts = counted("telemetry rows B=4", ticks,
                                          lambda: fleet.run_summary(ticks, scn=scn))
    log(f"telemetry {', '.join(names)} rows, REPS, B=4: run_summary {ticks} ticks in {secs:.3f} s "
        f"= {4 * ticks / secs:.1f} row-ticks/s; launches={counts}")
    sums = tel.summaries()
    for i, ((args, kw), s) in enumerate(zip(rows, seeds)):
        one = FleetRunner(*args, **kw, seeds=(s,), device=dev)
        (st, tl), _, _ = counted(f"serial row {i}", ticks, lambda: one.run_summary(ticks))
        leaves = sim_state_to_numpy(one.state_at(st, 0))
        same_leaves(sim_state_to_numpy(fleet.state_at(states, i)), leaves,
                    f"telemetry row {i} vs serial")
        if tl.tel[0].tobytes() != tel.tel[i].tobytes():
            bad = (tl.tel[0] != tel.tel[i]).nonzero()[0][:5].tolist()
            raise AssertionError(f"telemetry row {i}: carry differs from its serial run at {bad}")
        rec, sm = tel.result(i)["recovery"], sums[i]
        log(f"telemetry row {i} ({names[i]}, seed {s}) == serial: all {len(leaves)} SimState "
            f"leaves and all {tel.prog.size} carry slots bit-equal after {ticks} ticks; "
            f"completed={sm.completed}/{sm.n_conns} drops_fail={sm.drops_fail} "
            f"timeouts={sm.timeouts} first_drop={rec['first_drop_tick']} "
            f"recovery_ticks={rec['recovery_ticks']}")
    del fleet, states, scn
    step_done("(a) rows == serial")

    # (b) card == CPU: three FATTREE_32_CI rows, their own scenarios, cohorts
    rows = small_rows()
    nc = rows[0][0][1].n_conns
    spec = TelemetrySpec.default().with_cohorts({"even": range(0, nc, 2),
                                                 "odd": range(1, nc, 2)})
    out = []
    for d in (dev, "cpu"):
        small, scn = row_fleet(rows, (0, 5, 9), d)
        t0 = time.perf_counter()
        out.append(small.run_summary(check_ticks, spec, scn=scn))
        log(f"card vs CPU: telemetry FATTREE_32_CI rows B=3 on {d}: {check_ticks} ticks in "
            f"{time.perf_counter() - t0:.3f} s")
    (st_g, tl_g), (st_c, tl_c) = out
    if tl_g.tel.tobytes() != tl_c.tel.tobytes():
        raise AssertionError("card vs CPU: the telemetry carries differ at "
                             f"{(tl_g.tel != tl_c.tel).nonzero()}")
    for i in range(3):
        same_leaves(sim_state_to_numpy(small.state_at(st_g, i)),
                    sim_state_to_numpy(small.state_at(st_c, i)), f"telemetry small row {i}")
    log(f"card vs CPU: telemetry FATTREE_32_CI B=3 (own scenarios, cohorts): all "
        f"{tl_g.prog.size} carry slots and all SimState leaves of every row bit-equal after "
        f"{check_ticks} ticks (drops_fail per row {[s.drops_fail for s in tl_g.summaries()]}, "
        f"completed {[s.completed for s in tl_g.summaries()]})")
    step_done("(b) card == CPU")

    # (c) + (d) on the fleet phase's warmed fig06/reps rows
    big, warmed_states, warm = warmed
    sim, keys = big.sim, big.base_keys()
    Bs = (1, 64)
    starts = {B: tree_map(lambda t, B=B: t[:B], warmed_states) for B in Bs}
    draws = {B: sim.tick_draws(keys[:B], warm, bench_ticks) for B in Bs}
    prog = big.program(TelemetrySpec.default(), warm + bench_ticks)

    def bench(B, summary, n, carry=None):
        """``n`` ticks from the warmed rows, the profiled window's tick
        bodies: ``run``'s tick, or with ``summary`` ``run_summary``'s
        (``step_probe_rows``, then the update folded into ``carry``, made
        outside the window: its upload synchronizes), without the draws
        (made beforehand) and the carry's one copy to the host."""
        st, d = starts[B], draws[B]
        for i in range(n):
            with record_function(TICK_RANGE):
                if summary:
                    st, probe = sim.step_probe_rows(st, warm + i, d.row(i))
                    prog.update(carry, probe)
                else:
                    st, _ = sim.step_rows(st, warm + i, d.row(i))
        return st

    prof_ticks = 20
    typical = {}  # (B, summary) -> (total, by name) of the typical tick
    for B in Bs:
        for summary in (False, True):
            bench(B, summary, 3, prog.init_rows(B))  # the path's first calls, outside
            carry = prog.init_rows(B)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                bench(B, summary, prof_ticks, carry)
                torch.cuda.synchronize()
            per = collections.Counter()
            d2h = syncs = ends = 0
            for e in prof.events():
                d2h += "DtoH" in e.name or "DeviceToHost" in e.name
                if "Synchronize" in e.name:
                    # the window's closing synchronize and the profiler's own
                    # are top-level device synchronizes; a tick's would be a
                    # stream synchronize inside an op (a blocking copy)
                    top = e.cpu_parent is None and e.name == "cudaDeviceSynchronize"
                    ends += top
                    syncs += not top
                if e.device_type == torch.autograd.DeviceType.CUDA and e.name != TICK_RANGE:
                    per[e.name] += 1
            if d2h or syncs:
                raise AssertionError(f"B={B} summary={summary}: {d2h} device-to-host copies and "
                                     f"{syncs} synchronizes inside ops in {prof_ticks} ticks")
            rows = launches_per_tick(prof)
            total, held = collections.Counter(r.total() for r in rows).most_common(1)[0]
            if len(rows) != prof_ticks or not total or 2 * held <= prof_ticks:
                raise AssertionError(f"B={B} summary={summary}: {len(rows)} tick ranges, the "
                                     f"most common launch count {total} in {held} of them")
            names = {k for r in rows for k in r}
            typical[B, summary] = total, collections.Counter(
                {k: statistics.median(r[k] for r in rows) for k in names})
            ours = sum(v for k, v in typical[B, summary][1].items()
                       for key, _ in KERNEL_KEYS if key in k)
            log(f"launches B={B} {'run_summary' if summary else 'run'}: "
                f"{total} launches in {held} of {prof_ticks} ticks (the device trace holds "
                f"{sum(per.values()) / prof_ticks:.2f} per tick; the typical tick's port "
                f"kernels {ours:g}); {d2h} device-to-host copies, {syncs} synchronizes inside "
                f"ops ({ends} top-level device synchronizes: the window's end, the profiler's)")
    extra = {}
    for B in Bs:
        (n_off, off), (n_on, on) = typical[B, False], typical[B, True]
        extra[B] = n_on - n_off
        log(f"telemetry launches per tick at B={B}: {extra[B]:+d} ({n_on} with "
            f"TelemetrySpec.default() against {n_off} without)")
        diff = on.copy()
        diff.subtract(off)  # the telemetry's launches in a typical tick, by name
        for k, v in sorted(diff.items(), key=lambda kv: -abs(kv[1])):
            if v:
                log(f"telemetry launches B={B}: {v:+g} per tick  {k[:100]}")
    n1, n64 = (extra[B] for B in Bs)
    if n1 != n64:
        raise AssertionError(f"telemetry adds {n1} launches per tick at B=1 but {n64} at B=64")
    if n1 > 60:
        raise AssertionError(f"telemetry adds {n1} launches per tick, more than 60")
    step_done("(c) launches")

    # (d) the entry points themselves, draws and the carry's copies included:
    # FleetRunner.run_summary resumed at the warmed rows, against run's body
    # (run_rows, which FleetRunner.run calls, numbering its ticks from warm)
    fleets = {B: big if B == big.n_runs else fig06_fleet(big.seeds[:B], dev) for B in Bs}
    spec, horizon = TelemetrySpec.default(), warm + bench_ticks
    for f in fleets.values():
        f.program(spec, horizon)  # laid out once per fleet, outside the rounds

    def entry(B, summary, carry):
        f = fleets[B]
        if summary:
            return f.run_summary(bench_ticks, spec, states=starts[B], tel=carry, t0=warm,
                                 horizon=horizon)
        return f.sim.run_rows(bench_ticks, starts[B], f.base_keys(), t0=warm)

    rate = {(B, m): [] for B in Bs for m in (False, True)}
    order = [(B, m) for B in Bs for m in (False, True)]
    for r in range(rounds):
        for B, m in (order if r % 2 == 0 else order[::-1]):
            carry = fleets[B].program(spec, horizon).init_rows(B)
            _, secs, _ = counted(f"telemetry bench B={B} summary={m}", bench_ticks,
                                 lambda: entry(B, m, carry),
                                 TEL_PER_TICK if m else FLEET_PER_TICK)
            rate[B, m].append(B * bench_ticks / secs)
            log(f"telemetry bench round {r} B={B} {'run_summary' if m else 'run_rows'}: "
                f"{bench_ticks} ticks (from tick {warm}) in {secs:.3f} s = "
                f"{B * bench_ticks / secs:.1f} row-ticks/s")
    for B in Bs:
        run, summ = (statistics.median(rate[B, m]) for m in (False, True))
        log(f"telemetry row-ticks/s B={B}: run_summary median {summ:.1f} (min "
            f"{min(rate[B, True]):.1f}, max {max(rate[B, True]):.1f}) against run_rows median "
            f"{run:.1f} (min {min(rate[B, False]):.1f}, max {max(rate[B, False]):.1f}), "
            f"{rounds} rounds: {summ / run:.3f}x")
    step_done("(d) rounds")
    return totals


SWEEP_PER_TICK = dict(TEL_PER_TICK)  # a summary sweep's tick: the default spec's 2 histograms


def same_scenario(a, b) -> bool:
    """Whether two simulators run the same scenario at the same shapes
    (config but its shape pins, sizes, workload, failures, watch list, load
    balancer and seed): then one's run is the other's."""
    import dataclasses

    import numpy as np

    pins = ("msg_slots", "conns_per_host", "failure_slots")
    ca, cb = (dataclasses.replace(s.cfg, **{p: 0 for p in pins}) for s in (a, b))
    arrays = lambda s: [np.asarray(x) for x in (
        s.wl.src, s.wl.dst, s.wl.msg_pkts, s.wl.start, s.wl.dep, s.failures.queue,
        s.failures.start, s.failures.end, s.failures.kind, s.failures.param, s.watch.cpu())]
    lb = lambda s: (type(s.lb), vars(s.lb))
    return (ca == cb and (a.NP, a.MSG, a.CPH, a.NQ) == (b.NP, b.MSG, b.CPH, b.NQ)
            and all(x.shape == y.shape and np.array_equal(x, y)
                    for x, y in zip(arrays(a), arrays(b)))
            and lb(a) == lb(b) and a.seed == b.seed)


class TickRanges:
    """Per-tick profiler ranges around a simulator's ``step_probe_rows``
    calls (``step_events_rows`` in a traced loop), from one call to the
    next (the tick's telemetry and tracer updates included), so that
    ``launches_per_tick`` can count a tick of a loop that is not ours
    (``SweepEngine.run_chunk``, ``FleetRunner.run_summary``); the chunk's
    draws, made before its first tick, stay outside."""

    def __init__(self, sim, method: str = "step_probe_rows"):
        self.sim, self.method, self.open = sim, method, None

    def __enter__(self):
        from torch.profiler import record_function

        step = getattr(self.sim, self.method)

        def ranged(*a, **kw):
            self.close()
            self.open = record_function(TICK_RANGE)
            self.open.__enter__()
            return step(*a, **kw)

        setattr(self.sim, self.method, ranged)
        return self

    def close(self):
        if self.open is not None:
            self.open.__exit__(None, None, None)
            self.open = None

    def __exit__(self, *exc):
        self.close()
        delattr(self.sim, self.method)  # the class's method again


def profiled_ticks(label: str, sim, fn, n: int, method: str = "step_probe_rows") -> list:
    """``fn()`` (``n`` ticks of ``sim`` in someone's loop) under the
    profiler with a range per tick: each tick's launches by name
    (``launches_per_tick``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with TickRanges(sim, method):
            fn()
        torch.cuda.synchronize()
    rows = launches_per_tick(prof)
    if len(rows) != n:
        raise AssertionError(f"{label}: {len(rows)} tick ranges in {n} ticks")
    return rows


def typical_tick(label: str, rows: list) -> tuple:
    """The launch count most ticks of a window show and the median tick by
    name ``(total, Counter)``; raises unless more than half show it."""
    import collections

    total, held = collections.Counter(r.total() for r in rows).most_common(1)[0]
    if not total or 2 * held <= len(rows):
        raise AssertionError(f"{label}: the most common launch count {total} in {held} of "
                             f"{len(rows)} ticks")
    names = {k for r in rows for k in r}
    log(f"launches ({label}): {total} launches in {held} of {len(rows)} ticks")
    return total, collections.Counter({k: statistics.median(r[k] for r in rows) for k in names})


def sweep_rows_vs_serial(eng, res, name: str, ref) -> None:
    """A sweep row against its serial card run ``ref`` (a simulator and its
    state at the bucket's ``ticks_run``): every SimState leaf, the row's
    active SwitchLB slot against the plain load balancer's state, every
    other slot against its initial value, and the row's sketch summary
    against ``summarize`` of the serial state (every field but the sketch
    p99)."""
    import dataclasses

    from repro_torch import rng
    from repro_torch.netsim import sim_state_to_numpy, summarize
    from repro_torch.netsim.interop import lb_state_to_numpy

    b, c = res._find(name)
    row = c.rows[0]
    sim, st = ref
    got, want = sim_state_to_numpy(res.state_for(name)), sim_state_to_numpy(st)
    plain = {k: v for k, v in want.items() if not k.startswith("lb_state")}
    same_leaves({k: v for k, v in got.items() if not k.startswith("lb_state")}, plain,
                f"sweep {name} vs serial")
    slot = lambda i: {"lb_state" + k[len(f"lb_state.1.{i}"):]: v for k, v in got.items()
                      if k == f"lb_state.1.{i}" or k.startswith(f"lb_state.1.{i}.")}
    same_leaves(slot(c.branch), {k: v for k, v in want.items() if k.startswith("lb_state")},
                f"sweep {name}: active SwitchLB slot vs the plain LB")
    init = b.lb.init_state(sim.wl.n_conns, rng.fold_in(b.keys[row], 777))[1]
    for i in range(len(b.lb.variants)):
        if i != c.branch:
            same_leaves(slot(i), lb_state_to_numpy(init[i]), f"sweep {name}: slot {i} vs init")
    if int(got["lb_state.0"]) != c.branch:
        raise AssertionError(f"sweep {name}: branch index {got['lb_state.0']} != {c.branch}")
    sketch = res.summaries("sketch")[name][0]
    state = summarize(sim, st, name=name, lb_name=b.lb.variants[c.branch].name,
                      n_conns=c.case.workload.n_conns, conn_start=c.padded_wl.start)
    a, z = dataclasses.asdict(sketch), dataclasses.asdict(state)
    bad = {k: (a[k], z[k]) for k in a if k != "p99_fct_ticks" and a[k] != z[k]
           and not (a[k] != a[k] and z[k] != z[k])}  # NaN == NaN
    if bad:
        raise AssertionError(f"sweep {name}: sketch summary differs from summarize: {bad}")
    log(f"sweep {name} == serial card run: all {len(plain)} SimState leaves, the active "
        f"SwitchLB slot (branch {c.branch}) against the plain LB, the other slots at their "
        f"init, after {b.ticks_run} ticks; sketch summary == summarize (p99 {sketch.p99_fct_ticks} "
        f"from the sketch, {state.p99_fct_ticks} exact)")


def sweep_small_grids() -> dict:
    """The sweep phase's FATTREE_32_CI grids, ``{label: (cases, run
    keywords)}``: the fig04 (with a 200-tick cell, so that its bucket merges
    horizons) and fig07 smoke grids shrunk 32x (floor 300 ticks), and the
    traced zoo grid (``ZOO_TRACED`` under two ToR-0 uplinks down from tick
    30, 460 ticks, past the RTO)."""
    import dataclasses

    from repro_torch.bench import fig04_asym_macro as fig04
    from repro_torch.bench import fig07_failures_macro as fig07
    from repro_torch.configs import FATTREE_32_CI as small
    from repro_torch.netsim import SweepCase, Topology, failures, workloads
    from repro_torch.netsim import tracer as tr

    shrink = lambda cs: [dataclasses.replace(c, ticks=max(300, c.ticks // 32), seeds=(0,))
                         for c in cs]
    g04 = shrink(fig04.cases(small, smoke=True, full=False))
    g04.append(dataclasses.replace(g04[1], name="fig04/permutation/ops@200", ticks=200))
    g07 = shrink(fig07.cases(small, smoke=True, full=False))
    ups = [int(q) for q in Topology.build(small).t0_up_queues(0)[:2]]
    fs = failures.link_down(ups, 30, failures.FOREVER)
    wl = workloads.permutation(32, 64, seed=3)
    zoo = [SweepCase(f"zoo/{lb}", wl, lb, 460, dict(evs_size=small.evs_size, **kw), fs)
           for lb, kw in ZOO_TRACED]
    summary = dict(collect="summary", early_exit=True)
    return {"fig04": (g04, summary), "fig07": (g07, summary),
            "zoo": (zoo, dict(collect="summary", trace=tr.TraceSpec(ring=4096)))}


def sweep_cpu_runs(label: str) -> dict:
    """The CPU side of the sweep phase's grid ``label``, for a helper
    process: each bucket's ``(ticks_run, telemetry carry, ring carry or
    None)``, every cell's SimState leaves, and the seconds."""
    import torch

    from repro_torch.configs import FATTREE_32_CI
    from repro_torch.netsim import SweepEngine, sim_state_to_numpy

    torch.set_num_threads(2)
    grid, kw = sweep_small_grids()[label]
    e = SweepEngine(FATTREE_32_CI, grid, device="cpu")
    t0 = time.perf_counter()
    r = e.run(**kw)
    secs = time.perf_counter() - t0
    return {"buckets": [(b.ticks_run, b.telemetry, b.trace_rows) for b in r.buckets],
            "leaves": {c.name: sim_state_to_numpy(r.state_for(c.name)) for c in grid},
            "secs": secs}


def sweep_phase(dev, fig06_ticks: int, main_refs: dict, warm: int, prof_ticks: int,
                cpu_grids: dict) -> dict:
    """The sweep engine on the card: (a) the fig06 grid through the port's
    ``figure_grid`` at the BENCH_FULL config (FATTREE_128's fabric), its
    two cells one SwitchLB(ops, reps) bucket, ``collect="summary"`` with
    early exit, each row against its serial card run (the main path's run
    when its scenario is the serial reference's, continued to
    ``ticks_run``); (b) the fig04 and fig07 smoke grids at FATTREE_32_CI,
    shrunk (fig04 with one shorter cell, so that its bucket merges
    horizons), and (b') the traced zoo grid, card == CPU on every leaf and
    carry slot, the CPU's runs ``cpu_grids`` (pending results of
    ``sweep_cpu_runs`` in helper processes, by label); (c) launches per
    tick by name of (a)'s bucket against a B = 2 ``run_summary`` fleet, and
    of (b)'s horizon-merged bucket against the same bucket unmasked.
    Returns the launches per kernel."""
    import collections
    import dataclasses

    import torch

    from repro_torch.bench import common as bc
    from repro_torch.bench import fig06_failures_micro as fig06
    from repro_torch.configs import FATTREE_32_CI
    from repro_torch.kernels import ops
    from repro_torch.netsim import SweepEngine, sim_state_to_numpy
    from repro_torch.netsim import tracer as tr
    from repro_torch.netsim.engine import add_rows, drop_rows

    totals = {k: 0 for k in ops.KERNEL_MODULES}
    t_start = time.perf_counter()
    # a ring that holds the whole 8000-tick run of the REPS row (a few
    # pushes per tick), so that the failure edges of ticks 150 and 1200 stay
    trace = tr.TraceSpec(ring=32768, marker_every=256)

    def step_done(what):
        log(f"sweep phase: {what} done at {time.perf_counter() - t_start:.1f} s")

    def counted(what, fn, ticks=None):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        if ticks is not None:
            n = ticks(out) if callable(ticks) else ticks
            for k, m in SWEEP_PER_TICK.items():
                if counts[k] != m * n:
                    raise AssertionError(f"{what}: {k} launched {counts[k]} times, "
                                         f"expected {m} x {n}")
        for k, m in counts.items():
            totals[k] += m
        return out, secs, counts

    # (a) the fig06 grid at full width and its full horizon
    cfg = bc.ci_cfg(full=True)
    cases = [dataclasses.replace(c, ticks=fig06_ticks, seeds=(0,))
             for c in fig06.cases(cfg, full=True)]
    rows = bc.Rows(device=str(dev))
    (eng, res), secs, counts = counted(
        "sweep fig06", lambda: bc.figure_grid(rows, "fig06", cfg, cases, fmt=fig06.fmt,
                                              collect="summary", device=dev, trace=trace),
        ticks=lambda out: out[1].buckets[0].ticks_run)
    bucket = res.buckets[0]
    log("sweep fig06 plan:\n" + eng.plan.describe())
    if len(res.buckets) != 1 or len(bucket.lb.variants) != 2:
        raise AssertionError("sweep fig06: expected one bucket of SwitchLB(ops, reps)")
    sums = res.summaries()
    log(f"sweep fig06, traced (TraceSpec ring {trace.ring}; BENCH_FULL config = FATTREE_128: "
        f"{cfg.n_hosts} hosts, "
        f"{cfg.uplinks_per_tor} uplinks per ToR, queue {cfg.queue_capacity}, RTO "
        f"{cfg.rto_ticks}, {cfg.evs_size} EVs), horizon {bucket.ticks}: ticks_run="
        f"{bucket.ticks_run} in {secs:.3f} s ({bucket.exec_wall_s:.3f} s in the bucket's loop, "
        f"{bucket.compile_wall_s:.3f} s set-up); launches={counts}")
    for c in cases:
        s = sums[c.name][0]
        log(f"sweep {c.name}: completed={s.completed}/{s.n_conns} runtime_ticks="
            f"{s.runtime_ticks} drops_fail={s.drops_fail} timeouts={s.timeouts} "
            f"drops_cong={s.drops_cong} mean_fct={s.mean_fct_ticks}")
    for r in rows.records:
        if "/bucket/" in r["name"]:
            log(f"sweep {r['name']}: bucket_ticks_per_sec={r['bucket_ticks_per_sec']:.3f} "
                f"measured_row_tick_us={r['measured_row_tick_us']:.3f} "
                f"est_row_tick_cost={r['est_row_tick_cost']:.1f} key={r['bucket_key']}")
    step_done("(a) fig06 sweep")
    fail_ticks = [int(t) for t in (150, 1200)]
    for c in cases:
        ev, rec = res.flight_for(c.name), res.telemetry_for(c.name)["recovery"]
        codes = [int(x) for x in ev["code"]]
        if ev["lost"] or ev["cursor"] != len(codes):
            raise AssertionError(f"sweep {c.name}: the ring lost {ev['lost']} events")
        opened = [(int(t), int(v)) for t, v, k in zip(ev["tick"], ev["value"], codes)
                  if k == tr.FAIL_ACTIVE]
        if opened != [(t, 1) for t in fail_ticks]:
            raise AssertionError(f"sweep {c.name}: fail_active events {opened}, expected one "
                                 f"queue at each of {fail_ticks}")
        rer = [(int(t), int(v)) for t, v, k in zip(ev["tick"], ev["value"], codes)
               if k == tr.FAIL_REROUTED]
        if (ev["first_drop_tick"], ev["first_redeliver_tick"]) != (
                rec["first_drop_tick"], rec["first_redeliver_tick"]) or (
                rec["recovery_ticks"] >= 0 and rer != [(rec["first_redeliver_tick"],
                                                        rec["recovery_ticks"])]):
            raise AssertionError(f"sweep {c.name}: ring edges {ev['first_drop_tick']}, "
                                 f"{ev['first_redeliver_tick']}, rerouted {rer} against the "
                                 f"RecoveryTracker {rec}")
        by = collections.Counter(tr.CODE_NAMES[k] for k in codes)
        log(f"sweep {c.name} flight ring: {ev['cursor']} events, 0 lost, {dict(by)}; "
            f"fail_active at {opened} (tick, queues); first drop {ev['first_drop_tick']}, "
            f"first re-routed delivery {ev['first_redeliver_tick']}: fail_rerouted value "
            f"{rer[0][1] if rer else None} == RecoveryTracker recovery_ticks "
            f"{rec['recovery_ticks']}")
    step_done("(a) flight rings")
    ticks_run = bucket.ticks_run
    for c in cases:
        lbn = c.lb
        ser = eng.serial_sim(c.name)
        sim, st, t0 = main_refs[lbn]
        if not (same_scenario(ser, sim) and t0 <= ticks_run):
            log(f"sweep {c.name}: the main path's run is not its serial reference; running it")
            sim, st, t0 = ser, ser.init_state(), 0
        t1 = time.perf_counter()
        if ticks_run > t0:
            states, _ = sim.run_rows(ticks_run - t0, add_rows(st), sim.base_key[None], t0=t0)
            st = drop_rows(states)
        log(f"sweep {c.name}: serial card reference ({'the main path run, ' if t0 else ''}"
            f"ticks {t0}-{ticks_run}) in {time.perf_counter() - t1:.3f} s")
        sweep_rows_vs_serial(eng, res, c.name, (sim, st))
        main_refs[lbn] = (sim, st, ticks_run)
    step_done("(a) rows == serial")

    # (b) heterogeneous horizons and three variants: card == CPU (the CPU
    # runs in helper processes, started while (a) ran)
    grids = sweep_small_grids()
    merged = None
    for label in ("fig04", "fig07"):
        grid, kw = grids[label]
        e = SweepEngine(FATTREE_32_CI, grid, device=dev)
        rg, secs, counts = counted(f"sweep {label} on {dev}", lambda: e.run(**kw),
                                   ticks=lambda r: sum(b.ticks_run for b in r.buckets))
        log(f"sweep {label} on {dev}: {secs:.3f} s, ticks_run "
            f"{[b.ticks_run for b in rg.buckets]}, masked "
            f"{[b.program.masked for b in rg.buckets]}, variants "
            f"{[b.lb.name for b in rg.buckets]}; launches={counts}")
        rc = cpu_grids[label].get(timeout=900)
        log(f"sweep {label} on cpu: {rc['secs']:.3f} s (a helper process), ticks_run "
            f"{[t for t, _, _ in rc['buckets']]}")
        log(f"sweep {label} plan:\n" + e.plan.describe())
        n_slots = 0
        for bg, (t_c, tel_c, _) in zip(rg.buckets, rc["buckets"], strict=True):
            if bg.ticks_run != t_c or bg.telemetry.tobytes() != tel_c.tobytes():
                raise AssertionError(f"sweep {label}: card and CPU differ in ticks_run or the "
                                     "telemetry carry")
            n_slots += bg.telemetry.size
            if bg.program.masked:
                merged = (e, bg)
        for c in grid:
            same_leaves(sim_state_to_numpy(rg.state_for(c.name)), rc["leaves"][c.name],
                        f"sweep {label} {c.name}")
        log(f"card vs CPU: sweep {label}: every SimState leaf of all {len(grid)} rows and all "
            f"{n_slots} telemetry carry slots bit-equal")
    if merged is None:
        raise AssertionError("sweep (b): no bucket merged horizons")
    step_done("(b) card == CPU")

    # (b') the load-balancer zoo as one traced grid (two ToR-0 uplinks down
    # from tick 30, past the RTO): card == CPU on every ring carry
    zoo, kw = grids["zoo"]
    e = SweepEngine(FATTREE_32_CI, zoo, device=dev)
    rg, secs, counts = counted(f"sweep zoo traced on {dev}", lambda: e.run(**kw))
    # the reps variant and mixed's, in the bucket that holds them
    n_run = sum(r.ticks_run for b, r in zip(e.buckets, rg.buckets) if "reps" in b.lb.name)
    if counts["reps_tick"] != 2 * n_run:
        raise AssertionError(f"sweep zoo traced: reps_tick launched {counts['reps_tick']} "
                             f"times in {n_run} ticks, expected 2 per tick")
    log(f"sweep zoo traced on {dev}: {len(e.buckets)} bucket(s) {[b.lb.name for b in e.buckets]},"
        f" {secs:.3f} s; launches={counts}")
    rc = cpu_grids["zoo"].get(timeout=900)
    log(f"sweep zoo traced on cpu: {rc['secs']:.3f} s (a helper process)")
    n_slots, events = 0, collections.Counter()
    for bg, (_, tel_c, trc_c) in zip(rg.buckets, rc["buckets"], strict=True):
        if (bg.trace_rows.tobytes() != trc_c.tobytes()
                or bg.telemetry.tobytes() != tel_c.tobytes()):
            raise AssertionError("sweep zoo traced: card and CPU rings or carries differ")
        n_slots += bg.trace_rows.size
    for c in zoo:
        same_leaves(sim_state_to_numpy(rg.state_for(c.name)), rc["leaves"][c.name],
                    f"sweep {c.name}")
        ev = rg.flight_for(c.name)
        events.update(tr.CODE_NAMES[int(k)] for k in ev["code"])
    log(f"card vs CPU: sweep zoo traced ({len(zoo)} LBs): all {n_slots} ring carry slots, the "
        f"telemetry carries and every SimState leaf bit-equal; events {dict(events)}")
    step_done("(b') zoo traced card == CPU")

    # (c) launches per tick by name: (a)'s bucket against a B = 2 fleet of
    # fig06/reps under run_summary; (b)'s merged bucket against unmasked
    carry = eng.bucket_carry(bucket, "summary")
    carry, _ = eng.run_chunk(bucket, carry, 0, warm, "summary")
    # the traced window starts from the same warmed rows with a fresh ring
    # (the untraced window below updates the telemetry carry in place)
    carry_t = (carry[0], carry[1].clone(),
               eng._trc_prog(bucket.program, trace).init_rows(bucket.plan.n_padded_rows))
    rows_sw, _, counts6 = counted("sweep fig06 window", lambda: profiled_ticks(
        "sweep fig06 bucket B=2", bucket.sim,
        lambda: eng.run_chunk(bucket, carry, warm, prof_ticks, "summary"), prof_ticks),
        ticks=prof_ticks)
    n_sw, by_sw = typical_tick("sweep fig06 bucket, B=2", rows_sw)
    rows_tr, _, _ = counted("sweep fig06 traced window", lambda: profiled_ticks(
        "sweep fig06 bucket B=2 traced", bucket.sim,
        lambda: eng.run_chunk(bucket, carry_t, warm, prof_ticks, "summary", None, trace),
        prof_ticks, method="step_events_rows"), ticks=prof_ticks)
    n_tr, by_tr = typical_tick("sweep fig06 bucket, B=2, traced", rows_tr)
    log(f"tracer launches per tick: the traced fig06 bucket {n_tr} against {n_sw} untraced "
        f"({n_tr - n_sw:+d}: the traced LB step's counts and the ring update)")
    diff_tr = by_tr.copy()
    diff_tr.subtract(by_sw)
    for k, v in sorted(diff_tr.items(), key=lambda kv: -abs(kv[1])):
        if v:
            log(f"tracer launches vs untraced: {v:+g} per tick  {k[:100]}")
    fleet = fig06_fleet((0, 1), dev)
    st, tel = fleet.run_summary(warm, horizon=warm + prof_ticks)
    rows_fl, _, _ = counted("fleet window", lambda: profiled_ticks(
        "fleet fig06/reps B=2 run_summary", fleet.sim,
        lambda: fleet.run_summary(prof_ticks, states=st, tel=tel.tel, t0=warm,
                                  horizon=warm + prof_ticks), prof_ticks), ticks=prof_ticks)
    n_fl, by_fl = typical_tick("fleet fig06/reps B=2 run_summary", rows_fl)
    log(f"sweep launches per tick: fig06 bucket (SwitchLB(ops, reps), B=2) {n_sw} against "
        f"{n_fl} for the B=2 fig06/reps run_summary fleet ({n_sw - n_fl:+d}); kernels per tick "
        f"by counter {({k: v / prof_ticks for k, v in counts6.items()})}")
    diff = by_sw.copy()
    diff.subtract(by_fl)
    for k, v in sorted(diff.items(), key=lambda kv: -abs(kv[1])):
        if v:
            log(f"sweep launches vs fleet: {v:+g} per tick  {k[:100]}")
    e_m, b_m = merged
    unmasked = SweepEngine(FATTREE_32_CI, [dataclasses.replace(c, ticks=b_m.ticks)
                                           for c in grids["fig04"][0]], device=dev)
    b_u = unmasked.buckets[0]
    if b_u.program.masked or b_u.plan.key != b_m.plan.key:
        raise AssertionError("sweep (c): the unmasked twin bucket has other shapes")
    lo = min(int(h) for h in b_m.horizons) // 2
    n_w = min(lo // 2, 20)
    per = {}
    for label, e, b in (("merged", e_m, b_m), ("unmasked", unmasked, b_u)):
        c = e.bucket_carry(b, "summary")
        c, _ = e.run_chunk(b, c, 0, lo - n_w, "summary")
        per[label] = profiled_ticks(f"sweep fig04 {label} bucket, ticks {lo - n_w}-{lo}", b.sim,
                                    lambda: e.run_chunk(b, c, lo - n_w, n_w, "summary"), n_w)
    # degraded links serve on even ticks only: the count alternates, tick by tick
    totals_m, totals_u = ([r.total() for r in per[k]] for k in ("merged", "unmasked"))
    by_m, by_u = (collections.Counter({k: statistics.median(r[k] for r in per[w])
                                       for k in {k for r in per[w] for k in r}})
                  for w in ("merged", "unmasked"))
    if totals_m != totals_u or by_m != by_u:
        raise AssertionError(f"sweep (c): the horizon-merged bucket's ticks launch {totals_m}, "
                             f"the unmasked bucket's {totals_u}")
    log(f"sweep launches per tick: the horizon-merged fig04 bucket == the unmasked bucket, tick "
        f"by tick ({sorted(collections.Counter(totals_m).items())} launches: ticks), and the "
        f"median tick by name, on ticks {lo - n_w}-{lo}, where no row's horizon falls")
    step_done("(c) launches")
    return totals


def _counting(totals: dict):
    """``counted(fn) -> (out, seconds, launches by kernel)``: ``fn()`` run
    with every launch count set to 0 just before and read just after,
    added into ``totals``."""
    import torch

    from repro_torch.kernels import ops

    def counted(fn):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        for k, m in counts.items():
            totals[k] += m
        return out, secs, counts

    return counted


def exact_launches(what: str, counts: dict, want: dict) -> None:
    got = {k: v for k, v in counts.items() if v}
    if got != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def fig16_cpu_trials(m: int) -> int:
    """Trials of a fig16 cell held on the CPU: all 64, or the first 4 where
    m = flows x EVS > 2**17 (a CPU run of 64 would take minutes; the trials'
    keys are a prefix of the 64's, so their draws are too)."""
    return 64 if m <= 2**17 else 4


def bins_runs(dev, steps: int, parts=None) -> dict:
    """The outputs of ``bench/bins.py``'s cells (the figures in ``parts``,
    all by default) on ``dev``, as numpy arrays keyed by cell (the card's in
    ``bins_phase``, the CPU's in helper processes beside it, one per figure,
    fig16 on ``fig16_cpu_trials``), with each cell's seconds under
    ``("secs", key)``."""
    import torch

    from repro_torch.bench import bins

    torch.set_num_threads(2)
    on_card = torch.device(dev).type == "cuda"
    out = {}
    trials = (lambda m: bins.FIG16_TRIALS) if on_card else fig16_cpu_trials
    for k, fn in bins.cells(dev, steps, parts or bins.PARTS, trials):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        if on_card:
            torch.cuda.synchronize()
        out[("secs", k)] = time.perf_counter() - t0
        out[k] = [x.cpu().numpy() for x in (r if isinstance(r, tuple) else (r,))]
    return out


def bins_phase(dev, steps: int) -> dict:
    """The balls-into-bins models (``repro_torch.core.balls_bins``, the
    reference's fig13/14, fig16 and fig17 cells) on the card against the
    port's plain path on the CPU (in a helper process per figure while the
    card runs): fig13/14 at n = 8, 32, 128 for ``steps`` steps, fig17's
    coalescing ratios (n = 32, 4000 steps), every output equal; fig16's
    full grid (flows 1, 32 x EVS 2^4 ... 2^16 x 64 trials) on the card,
    equal to the CPU on every trial or on the first 4 (``fig16_cpu_trials``);
    Theorem 5.1's assertions (tests/test_property_reps.py) at n = 128 on the
    card's 4000-step prefix; exact ``seg_rank`` / ``seg_sum`` launches per
    run and steps/s.  Returns the launches per kernel."""
    import numpy as np

    from repro_torch.bench import bins
    from repro_torch.bench.bins import params
    from repro_torch.core import balls_bins as bb
    from repro_torch.kernels import ops

    totals = {k: 0 for k in ops.KERNEL_MODULES}
    counted = _counting(totals)
    with multiprocessing.get_context("spawn").Pool(len(bins.PARTS)) as pool:
        pending = [pool.apply_async(bins_runs, ("cpu", steps, (p,))) for p in bins.PARTS]
        card, secs, counts = counted(lambda: bins_runs(dev, steps))
        cpu = {k: v for p in pending for k, v in p.get(timeout=900).items()}
    n17, s17, ratios = bins.FIG17_N, bins.FIG17_STEPS, bins.FIG17_RATIOS
    tr16 = bins.FIG16_TRIALS
    want = {"seg_rank": len(bins.NS) * steps + len(ratios) * s17,
            "seg_sum": len(bins.NS) * (1 + steps) + len(ratios) * s17 + 1 + sum(
                -(-tr16 // max(1, bb.TRIAL_DRAWS // (f * 2**b))) for f, b in bins.FIG16)}
    exact_launches("balls into bins", counts, want)
    for k, outs in cpu.items():
        if k[0] == "secs":
            continue
        got = card[k]
        for i, (x, y) in enumerate(zip(got, outs)):
            x = x[: len(y)] if k[0] == "evs" else x
            if x.dtype != y.dtype or x.shape != y.shape or x.tobytes() != y.tobytes():
                raise AssertionError(f"balls into bins {k}: card output {i} differs from the CPU")
    log(f"bins: card == CPU on every output of {len(cpu) // 2} cells in {secs:.1f} s; launches "
        f"{ {k: v for k, v in counts.items() if v} } == expected (seg_rank 1 and seg_sum 1 per "
        f"recycled step, seg_sum 1 per OPS run, 1 per fig16 chunk of trials)")
    for n in bins.NS:
        b, tau = params(n)
        ml, = card[("ops", n)]
        mx, frac, _ = card[("rec", n)]
        log(f"bins fig13/ops/n{n}: max_load_end={ml[-1]} peak={ml.max()}, "
            f"{steps / card[('secs', ('ops', n))]:.1f} steps/s; fig14/recycled/n{n} (b={b}, "
            f"tau={tau}): max_load_end={mx[-1]} frac_remember={frac[-1]:.3f}, "
            f"{steps / card[('secs', ('rec', n))]:.1f} steps/s (CPU "
            f"{steps / cpu[('secs', ('rec', n))]:.1f}); {steps} steps, card == CPU")
    for ratio in ratios:
        mx = card[("c", ratio)][0]
        log(f"bins fig17/recycled_c{ratio}: max_load_end={mx[-1]} tau={params(n17)[1]}, "
            f"{s17 / card[('secs', ('c', ratio))]:.1f} steps/s; card == CPU")
    for flows, bits in bins.FIG16:
        lam = card[("evs", flows, bits)][0]
        n_cpu = fig16_cpu_trials(flows * 2**bits)
        log(f"bins fig16/flows{flows}/evs2^{bits}: 64 trials of m={flows * 2**bits} draws in "
            f"{card[('secs', ('evs', flows, bits))]:.3f} s; card == CPU on "
            f"{'all 64 trials' if n_cpu == 64 else 'the first 4 trials (a CPU run of 64 is too long)'}"
            f"; mean_imbalance={lam.mean():.4f} p95={np.percentile(lam, 95):.4f}")
    # Theorem 5.1 at n = 128 (the test's 4000 steps: the draws and the
    # process are causal, so they are the prefix of the longer runs)
    n, T5 = 128, 4000
    tau = params(n)[1]
    mx, frac, _ = card[("rec", n)]
    ml, ops_ml = mx[:T5], card[("ops", n)][0][:T5]
    if not (int(ml[-1]) <= 3 * tau and int(ml[2000:].max()) <= 3 * tau
            and int(ops_ml[-1]) > 3 * tau and float(frac[T5 - 1]) > 0.3):
        raise AssertionError(f"Theorem 5.1 at n={n}: recycled end {ml[-1]}, max after 2000 "
                             f"{ml[2000:].max()}, OPS end {ops_ml[-1]}, 3 tau {3 * tau}, "
                             f"frac_remember {frac[T5 - 1]}")
    log(f"bins Theorem 5.1 at n={n} (tau={tau}): recycled max load {int(ml[-1])} at step {T5} "
        f"and <= {int(ml[2000:].max())} after 2000 (bound 3 tau = {3 * tau}); OPS "
        f"{int(ops_ml[-1])} > 3 tau; frac_remember {float(frac[T5 - 1]):.3f} > 0.3")
    return totals


# the soak phase: the grid's permutation horizon (AllReduce 2x), its chunk
# (the checkpoint cadence), the preemption tick (a chunk boundary), the
# flight ring, and the spine injected at a tick inside the first chunk
SOAK_TICKS, SOAK_CHUNK, SOAK_KILL_AT, SOAK_RING = 480, 120, 240, 2048
SOAK_SPINE, SOAK_INJECT_AT = 0, 40


def soak_phase(dev) -> dict:
    """The soak runtime at full width: ``bench/soak_fig07``'s grid
    (permutation and ring-AllReduce blocks x OPS / REPS under 5 % of the
    uplinks down) on FATTREE_128's fabric, ``SOAK_TICKS`` (AllReduce 2x),
    chunk ``SOAK_CHUNK``, traced, checkpointing to a temporary directory:
    straight through; killed at ``SOAK_KILL_AT`` (the runner abandoned, a
    fresh engine and runner resumed); a spine injected through ``inject`` at
    ``SOAK_INJECT_AT`` (the run advanced to it, injected, and advanced back
    onto the chunk grid) against the same spine declared statically.  The
    records of straight and resumed runs are equal, their flight parts array
    by array, and the injected and static records are equal.  Snapshot
    bytes and save seconds, synchronous and asynchronous.  Returns the
    launches per kernel."""
    import dataclasses
    import json as _json
    import os
    import shutil
    import tempfile

    import numpy as np

    from repro_torch import checkpoint as ckpt
    from repro_torch.bench import soak_fig07 as sf
    from repro_torch.configs import FATTREE_128
    from repro_torch.kernels import ops
    from repro_torch.netsim import FailureSchedule, SoakRunner, SweepEngine, failures

    totals = {k: 0 for k in ops.KERNEL_MODULES}
    counted = _counting(totals)
    cfg = FATTREE_128
    ticks, chunk, kill_at, ring = SOAK_TICKS, SOAK_CHUNK, SOAK_KILL_AT, SOAK_RING
    base = tempfile.mkdtemp(prefix="chip_smoke_soak_")
    t_start = time.perf_counter()

    def parts(d):
        fd = os.path.join(d, "flight")
        out = {}
        for f in sorted(os.listdir(fd)):
            if f.endswith(".npz"):
                with np.load(os.path.join(fd, f)) as z:
                    out[f] = {k: z[k] for k in z.files}
        return out

    try:
        d_a = os.path.join(base, "straight")
        soak = sf.build(cfg, ticks, chunk, d_a, ring, dev)
        log("soak fig07 grid on FATTREE_128:\n" + soak.engine.plan.describe())
        _, secs, counts = counted(lambda: sf.drive(soak, chunk))
        # snapshot size and save times at the finished cursor, before result()
        snap = ckpt.latest(d_a)
        n_bytes = sum(os.path.getsize(os.path.join(snap, f)) for f in os.listdir(snap))
        t0 = time.perf_counter()
        ckpt.save(os.path.join(base, "timed", "step_sync"), soak.cursor, soak._trees(),
                  extra=soak._extra())
        sync_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        h = ckpt.save_async(os.path.join(base, "timed", "step_async"), soak.cursor, soak._trees(),
                            extra=soak._extra())
        snap_s = time.perf_counter() - t0
        h.join()
        async_s = time.perf_counter() - t0
        straight = sf.record(soak)
        log(f"soak straight: {soak.cursor} ticks (permutation {ticks}, AllReduce {2 * ticks}) in "
            f"{secs:.3f} s with {soak.cursor // chunk} checkpoints; launches={counts}; snapshot "
            f"{n_bytes} B; save {sync_s:.4f} s synchronous, {snap_s:.4f} s to the host copy and "
            f"{async_s:.4f} s to the commit asynchronous")
        for name, ss in straight["summaries"].items():
            s = ss[0]
            log(f"soak {name}: completed={s['completed']}/{s['n_conns']} drops_fail="
                f"{s['drops_fail']} timeouts={s['timeouts']}")

        d_b = os.path.join(base, "killed")
        first = sf.build(cfg, ticks, chunk, d_b, ring, dev)
        _, s1, _ = counted(lambda: sf.drive(first, chunk, kill_at=kill_at))
        if first.cursor != kill_at:
            raise AssertionError(f"soak: killed at {first.cursor}, not {kill_at}")
        del first  # the preemption: only the snapshots survive
        resumed = sf.build(cfg, ticks, chunk, d_b, ring, dev)
        _, s2, _ = counted(lambda: (resumed.resume(), sf.drive(resumed, chunk)))
        got = sf.record(resumed)
        if _json.dumps(got, sort_keys=True) != _json.dumps(straight, sort_keys=True):
            raise AssertionError("soak: the killed-and-resumed record differs from the straight")
        pa, pb = parts(d_a), parts(d_b)
        if sorted(pa) != sorted(pb) or any(
                sorted(pa[f]) != sorted(pb[f]) or any(not np.array_equal(pa[f][k], pb[f][k])
                                                      for k in pa[f]) for f in pa):
            raise AssertionError("soak: the resumed run's flight parts differ from the straight")
        n_ev = sum(int(p["seq"].size) for p in pa.values())
        log(f"soak killed at {kill_at} and resumed by a fresh engine and runner ({s1:.3f} s + "
            f"{s2:.3f} s): record == straight; all {len(pa)} flight parts ({n_ev} events) equal "
            f"array by array")

        # injected at tick 40, while the permutation's messages are in
        # flight (its random uplink failures start at 60; by the first
        # boundary, 120, its traffic has drained but for stalled packets)
        spine, at = SOAK_SPINE, SOAK_INJECT_AT
        delta = failures.spine_down(cfg, spine, start=at)
        inj = sf.build(cfg, ticks, chunk, os.path.join(base, "injected"), ring, dev)

        def inject_and_drive():
            inj.advance(at)
            inj.inject(delta)
            inj.advance(chunk - at)  # back onto the chunk grid
            sf.drive(inj, chunk)

        _, s3, _ = counted(inject_and_drive)
        injected = sf.record(inj)
        cases = [dataclasses.replace(c, failures=FailureSchedule.concat(c.failures, delta))
                 for c in sf.cases(cfg, ticks)]
        eng = SweepEngine(cfg, cases, min_failure_slots=sf.MIN_FAILURE_SLOTS, device=dev)
        static = SoakRunner(eng, dataclasses.replace(inj.config,
                                                     ckpt_dir=os.path.join(base, "static")))
        _, s4, _ = counted(lambda: sf.drive(static, chunk))
        declared = sf.record(static)
        if len(injected["injections"]) != 1:
            raise AssertionError(f"soak: injections {injected['injections']}")
        strip = lambda r: _json.dumps({k: v for k, v in r.items() if k != "injections"},
                                      sort_keys=True)
        if strip(injected) != strip(declared):
            raise AssertionError("soak: the injected spine's record differs from the static one")
        if strip(injected) == strip(straight):
            raise AssertionError("soak: the spine changed nothing")
        log(f"soak spine {spine} injected at {at} ({s3:.3f} s) == declared statically "
            f"({s4:.3f} s): records equal")
    finally:
        shutil.rmtree(base, ignore_errors=True)
    log(f"soak phase: {time.perf_counter() - t_start:.1f} s")
    return totals


def same_leaves(gpu: dict, cpu: dict, what: str) -> None:
    import numpy as np

    assert gpu.keys() == cpu.keys(), what
    for k in gpu:
        a, b = gpu[k], cpu[k]
        if a.dtype != b.dtype or a.shape != b.shape or a.tobytes() != b.tobytes():
            bad = np.argwhere(a != b)[:5].tolist() if a.shape == b.shape else "shape"
            raise AssertionError(f"{what}: card and CPU differ in SimState leaf {k} at {bad}")


def card_vs_cpu_leaves(what: str, dev, ticks: int):
    """``(SimState leaves as numpy, seconds)`` after ``ticks`` on ``dev``:
    of the fig06/reps cell (``what == "reps"``, the card run's
    ``(simulator, state)`` too on the card), or ``{name: (LB name, leaves,
    seconds)}`` of every zoo load balancer (and mixed) on FATTREE_32_CI with
    16-packet queues (so ECN reaches every LB's ACK path) and two ToR-0
    uplinks down over ticks 30-300 (``"zoo"``).  On the CPU it runs in a
    helper process beside the card's run."""
    import numpy as np
    import torch

    from repro_torch.configs import FATTREE_32_CI
    from repro_torch.core import make_lb
    from repro_torch.netsim import Simulator, Topology, failures, sim_state_to_numpy, workloads

    on_card = torch.device(dev).type == "cuda"
    if not on_card:
        torch.set_num_threads(2)
    if what == "reps":
        sim = fig06_cell("reps", dev)
        t0 = time.perf_counter()
        state, _ = sim.run(ticks)
        out = sim_state_to_numpy(state)
        secs = time.perf_counter() - t0
        return (out, secs, (sim, state)) if on_card else (out, secs)
    cfg = FATTREE_32_CI.replace(queue_capacity=16)
    ups = [int(q) for q in Topology.build(cfg).t0_up_queues(0)[:2]]
    wl, bg = workloads.permutation_with_background(32, 48, 0.25, seed=3)
    bg_conns = tuple(int(i) for i in np.nonzero(bg)[0])
    out = {}
    for lbn in (*ZOO, "mixed"):
        kw = dict(fg="reps", bg="ecmp", bg_conns=bg_conns) if lbn == "mixed" else {}
        sim = Simulator(cfg, wl, make_lb(lbn, evs_size=cfg.evs_size, **kw),
                        failures=failures.link_down(ups, 30, 300), device=dev)
        t0 = time.perf_counter()
        state, _ = sim.run(ticks)
        out[lbn] = (sim.lb.name, sim_state_to_numpy(state), time.perf_counter() - t0)
    return out


def card_vs_cpu(dev, ticks: int, zoo_ticks: int) -> tuple:
    """The fig06/reps cell for ``ticks``, then every zoo load balancer for
    ``zoo_ticks`` (past the 400-tick RTO they are held by the sweep phase's
    traced zoo grid), on the card and on the CPU, the CPU runs in two helper
    processes while the card runs: every leaf equal.  Returns the card run
    ``(simulator, state, ticks)``."""
    from repro_torch.netsim.engine import ST_ECN, ST_TIMEOUTS

    with multiprocessing.get_context("spawn").Pool(2) as pool:
        pending = [pool.apply_async(card_vs_cpu_leaves, ("reps", "cpu", ticks)),
                   pool.apply_async(card_vs_cpu_leaves, ("zoo", "cpu", zoo_ticks))]
        gpu, g_secs, (sim, state) = card_vs_cpu_leaves("reps", dev, ticks)
        log(f"card vs CPU: REPS {ticks} ticks on {dev} in {g_secs:.3f} s")
        zoo_gpu = card_vs_cpu_leaves("zoo", dev, zoo_ticks)
        (cpu, c_secs), zoo_cpu = (p.get(timeout=900) for p in pending)
    log(f"card vs CPU: REPS {ticks} ticks on cpu in {c_secs:.3f} s (a helper process)")
    same_leaves(gpu, cpu, "fig06/reps")
    froze = int((gpu["lb_state.exit_freezing"] > 0).sum())  # set only on entering freezing
    log(f"card vs CPU: all {len(gpu)} SimState leaves bit-equal after {ticks} ticks "
        f"(timeouts={int(gpu['s_stats'][ST_TIMEOUTS])}, REPS conns that entered freezing={froze})")
    for lbn, (name, leaves, secs) in zoo_gpu.items():
        same_leaves(leaves, zoo_cpu[lbn][1], f"zoo/{lbn}")
        st = leaves["s_stats"]
        log(f"card vs CPU: {name}: all {len(leaves)} SimState leaves bit-equal after "
            f"{zoo_ticks} ticks (timeouts={int(st[ST_TIMEOUTS])}, ecn_marks={int(st[ST_ECN])}; "
            f"card {secs:.3f} s, CPU {zoo_cpu[lbn][2]:.3f} s)")
    return sim, state, ticks


# ---------------------------------------------------------------------------
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ticks", type=int, default=3000, help="main-path ticks per cell")
    ap.add_argument("--arena-ticks", type=int, default=300,
                    help="arena ticks per cell (past the failures at 150)")
    ap.add_argument("--check-ticks", type=int, default=1200, help="REPS card-vs-CPU horizon")
    ap.add_argument("--zoo-check-ticks", type=int, default=300,
                    help="card-vs-CPU horizon of each zoo load balancer")
    ap.add_argument("--fig18-ticks", type=int, default=800, help="fig18/3tier/reps ticks")
    ap.add_argument("--fig18-check-ticks", type=int, default=400,
                    help="fig18/3tier/reps card-vs-CPU horizon")
    ap.add_argument("--fleet-ticks", type=int, default=300,
                    help="ticks of the B=4 fleet held against serial runs")
    ap.add_argument("--fleet-check-ticks", type=int, default=460,
                    help="card-vs-CPU horizon of the small fleet")
    ap.add_argument("--fleet-bench-ticks", type=int, default=100,
                    help="timed ticks per fleet per round")
    ap.add_argument("--fleet-rounds", type=int, default=2, help="interleaved rounds over B")
    ap.add_argument("--tel-ticks", type=int, default=600,
                    help="ticks of the four full-width telemetry rows held against serial runs")
    ap.add_argument("--tel-check-ticks", type=int, default=600,
                    help="card-vs-CPU horizon of the small telemetry fleet")
    ap.add_argument("--tel-bench-ticks", type=int, default=60,
                    help="timed ticks per (B, path) per telemetry round")
    ap.add_argument("--tel-rounds", type=int, default=2, help="interleaved telemetry rounds")
    ap.add_argument("--sweep-fig06-ticks", type=int, default=8000,
                    help="the sweep's fig06 horizon (8000: the figure's own)")
    ap.add_argument("--fabric-check-ticks", type=int, default=200,
                    help="card-vs-CPU horizon of the rail and mesh cells")
    ap.add_argument("--scale-row5-ticks", type=int, default=150,
                    help="ticks of the 10**5-connection row (card vs CPU)")
    ap.add_argument("--scale-row6-ticks", type=int, default=400,
                    help="ticks of the 10**6-connection row")
    ap.add_argument("--scale-prof-ticks", type=int, default=100,
                    help="profiled ticks of the 10**6-connection row")
    ap.add_argument("--bins-steps", type=int, default=10000,
                    help="fig13/14 steps (10000: the paper scale; the Theorem 5.1 checks need "
                         ">= 4000)")
    args = ap.parse_args()
    t_start = time.perf_counter()

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
                  NHD=sim.NQ - sim.topo.t0_down_base,
                  MAX_EV=sim.MAX_EV, MAX_ARR=sim.MAX_ARR, QCAP=cfg.queue_capacity,
                  KMIN=cfg.kmin, KMAX=cfg.kmax, PMAX=cfg.pmax, U=cfg.uplinks_per_tor,
                  TEL_TICKS=args.tel_ticks)
    log(f"main-path shapes: {shapes} NP={sim.NP}")
    t_phase = time.perf_counter()

    def phase_done(name: str) -> None:  # the script must stay well inside its time limit
        nonlocal t_phase
        now = time.perf_counter()
        log(f"phase {name}: {now - t_phase:.1f} s (script so far {now - t_start:.1f} s)")
        t_phase = now

    rows = kernel_phase(dev, shapes)
    phase_done("kernels")
    for r in rows:
        lib_ms = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.5f} ms"
        log(f"kernel {r['name']} ({r['shape']}): bit-exact; device {r['ms']:.5f} ms per call "
            f"(eager from Python {r['eager_ms']:.5f} ms), plain {r['plain_ms']:.5f} ms, "
            f"library {lib_ms}, bound {r['bound_ms']:.3e} ms")
        if "eager_old_ms" in r:
            log(f"kernel {r['name']}: the engine's former call form ({r['old_form']}): "
                f"device {r['ms_old']:.5f} ms, eager from Python {r['eager_old_ms']:.5f} ms")

    totals, rates, main_refs = main_path(dev, args.ticks)
    profile_window(dev, warm=300, ticks=50)
    phase_done("main path and profile")
    fig18_counts, fig18_card = three_tier_cell(dev, args.fig18_ticks, args.fig18_check_ticks)
    for k, n in fig18_counts.items():
        totals[k] += n
    phase_done("fig18/3tier")
    for k, n in arena_cells(dev, args.arena_ticks).items():
        totals[k] += n
    phase_done("arena")
    dense_reps = card_vs_cpu(dev, args.check_ticks, args.zoo_check_ticks)
    phase_done("card vs CPU")
    for k, n in fabric_phase(dev, fig18_card, args.fig18_check_ticks,
                             args.fabric_check_ticks).items():
        totals[k] += n
    del fig18_card
    phase_done("generated fabrics")
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        cpu_row5 = pool.apply_async(scale_row_cpu, (10**5, args.scale_row5_ticks))
        for k, n in scale_phase(dev, dense_reps, args.scale_row5_ticks, args.scale_row6_ticks,
                                args.scale_prof_ticks, cpu_row5).items():
            totals[k] += n
    del dense_reps
    phase_done("scale mode")
    fleet_totals, warmed = fleet_phase(dev, args.fleet_ticks, args.fleet_check_ticks,
                                       args.fleet_bench_ticks, args.fleet_rounds, warm=300,
                                       one_run_rate=rates["reps"])
    for k, n in fleet_totals.items():
        totals[k] += n
    phase_done("fleet")
    for k, n in telemetry_phase(dev, args.tel_ticks, args.tel_check_ticks, args.tel_bench_ticks,
                                args.tel_rounds, warmed).items():
        totals[k] += n
    del warmed
    phase_done("telemetry")
    with multiprocessing.get_context("spawn").Pool(3) as pool:
        cpu_grids = {g: pool.apply_async(sweep_cpu_runs, (g,)) for g in ("fig04", "fig07", "zoo")}
        for k, n in sweep_phase(dev, args.sweep_fig06_ticks, main_refs, warm=100,
                                prof_ticks=20, cpu_grids=cpu_grids).items():
            totals[k] += n
    del main_refs
    phase_done("sweep")
    for k, n in bins_phase(dev, args.bins_steps).items():
        totals[k] += n
    phase_done("balls into bins")
    for k, n in soak_phase(dev).items():
        totals[k] += n
    phase_done("soak")

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
