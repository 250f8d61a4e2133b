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
     for n = 8, 32, 128; an OPS run's 4000 x 128 rows; fig16's K = 2**21
     onto S = 32 as 8 and 64 rows), with bytes and bound, ``seg_sum`` at
     those and the scale shapes beside one ``index_add_`` over the rows'
     bins flattened row-major (its result == the kernel's); then
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
     A profiled window of 25 REPS ticks then shows where a tick's time
     goes (device busy share, launches per tick, kernel device times);
  5. fig18/3tier/reps — the 3-tier fabric at full width (FATTREE_128_3T), a
     permutation of 2048-packet messages, REPS, with exact launch counts and
     every queue region carrying traffic; card == CPU on every leaf after
     a shorter horizon;
  6. arena — the LB arena's failure block at full width: FATTREE_128, a
     permutation of 1024-packet messages and 5 % of the ToR uplinks down
     from tick 150 on (``benchmarks/arena.py``), 200 ticks (past the first
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
     main path's one run; a profiled window of 32 ticks at B = 64;
  9. telemetry — the summary path (``FleetRunner.run_summary``, the default
     ``TelemetrySpec``): four FATTREE_128 REPS rows with their own
     scenarios (fig08's 12.5, 25 and 50 % uplinks down, and fig06) equal
     their serial card runs on every leaf and carry slot after 200 ticks;
     three FATTREE_32_CI rows with their own scenarios and cohort channels,
     card == CPU; the telemetry's device launches per tick by name at B = 1
     and 64 (the same; no device-to-host copy or synchronize inside a
     tick); row-ticks/s of ``FleetRunner.run_summary`` against ``run``'s
     body (``Simulator.run_rows``) at B = 1 and 64, each resumed at the
     fleet phase's warmed rows, from interleaved rounds;
 10. sweep — the sweep engine (``SweepEngine`` through the port's
     ``figure_grid``, ``collect="summary"`` with quiescence early exit):
     (a) the fig06 grid at the BENCH_FULL config (FATTREE_128's fabric,
     4096-packet messages) at 4200 of its 8000 ticks (past the REPS row's
     completion at 4167; the OPS row has completions), its two cells one
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
     the 10**6 row through ``SweepEngine(collect="none")`` for 200 ticks
     (done > 0, NP = A by the lifetime bound, ticks/s, peak memory, exact
     kernel launches) and a profiled window of 32 ticks after it; its live
     REPS state packs to <= 25 B/conn and round-trips, and
     ``measure_scale(10**6)``.  Phases 11 and 12 run after phase 7.
 13. balls into bins — ``repro_torch.core.balls_bins``: fig13/14 at n = 8,
     32, 128 for 4000 steps (the paper's 10000 cut to Theorem 5.1's
     horizon) and fig17's coalescing ratios, card == CPU on
     every output; fig16's full grid on the card, == CPU on every trial or
     on the first 4 where the CPU run of 64 is too long; Theorem 5.1's
     assertions at n = 128; exact seg_rank / seg_sum launches per step and
     steps/s;
 14. soak — ``bench/soak_fig07``'s grid on FATTREE_128's fabric, 120 ticks
     (AllReduce 240), chunk 120, traced, checkpointing to a temporary
     directory: straight; killed at 120 and resumed by a fresh engine and
     runner (records equal, flight parts equal array by array); a spine
     injected at 40 through ``inject`` against the same spine declared
     statically (records equal); snapshot bytes and save seconds,
     synchronous and asynchronous;
 15. chaos — ``repro_torch.netsim.chaos`` through ``ChaosCampaign(seed=11,
     device=cuda)`` on FATTREE_32_CI: the known-bad fixture (ECMP, half
     the spines down for good) at 640 ticks, link flapping with a degraded
     link (``generate(2)``) and gray loss at 0.2424 (``generate(3)``) at
     1280 ticks, a ``SoakRunner`` each with the invariants checked at every
     160-tick boundary; card == CPU (helper processes) on the violation
     lists and record digests, known-bad ``{"completion"}`` exactly, exact
     launches per scenario;
 16. fig15 hook — ``ForcedFreezeReps(force_at=200)`` (``RepsLB``'s
     ``after_acks`` hook) on FATTREE_32_CI tornado traffic for 300 ticks:
     card == CPU on every leaf before F, after F and at the horizon; every
     connection that could enter freezing at F froze; ``reps_tick`` 300 + 1
     launches (the ACK-only launch at F);
 17. channels — ``repro_torch.ft``'s REPS channel scheduler (its state and
     key on the card) through ``bench/reps_channels_bench``'s three
     scenarios (healthy, 6 of 16 channels failed, 4 degraded; 256 chunks in
     rounds of 32), card == CPU (a helper process) on every ``ReduceReport``
     field, state leaf and the key; no kernel launched;
 18. serve — the transformer serving path (``repro_torch.launch.serve``,
     ``make_serve_steps`` over ``repro_torch.models``): gemma3-4b at full
     width and depth (34 layers, d_model 2560, vocab 262144, bf16) through
     the serve CLI's defaults (init, 4 x 32 prefill, 16 greedy steps), then
     warm prefill at 4 x 32 and 1 x 2304 (past the 1024 window and chunk)
     and decode tokens/s, decode against the full forward at both (rel <
     0.03 in float32 over a float32 cache; logged over the bf16 cache),
     every logit finite, profiled prefill and decode windows, the prompts
     and the embedding's chunked draw against the CPU's, peak memory; then
     the six reduced transformer archs card vs CPU (init, forward, float32
     and bfloat16 prefill and decode steps, within the tests' tolerances);
     no kernel launched.
 19. serve families — the MoE, RWKV6 and Zamba2 serving paths:
     rwkv6-1.6b (24 layers, d_model 2048) and zamba2-7b (81 layers, d_model
     3584) at full size through the serve CLI's defaults, phi3.5-moe at
     full width and 8 of its 32 layers (``dataclasses.replace``; 32 layers
     are 78 GiB in bf16) through ``serve.generate``: init seconds, prefill
     4 x 32 and 1 x 512 ms (warm, CUDA events), decode tokens/s, peak
     memory, a profiled decode window each; RWKV decode token by token
     against its forward over 64 tokens in float32 (rel < 0.01 over the
     first 4 layers, tests/test_models.py's depth; logged at 2, 6, 12 and
     24), Zamba's logits finite and its decode against a prefill one token
     longer (logged), the MoE prefill's drops at capacity and its decode
     against the full forward in float32 at 2 x 16 (rel < 0.03); then the
     reduced MoE, RWKV6 and Zamba2 archs (one Zamba case whose ring wraps)
     card vs CPU, every state leaf by its dtype, float32 routing equal,
     bf16 routing flips and the CPU's own bf16 excursions found
     (``tests/serve_parity.py``); no kernel launched.
 20. train — the training path: rwkv6-1.6b uncut (24 layers, d_model
     2048, 1,583,941,632 parameters) through the train CLI, 12 steps of 8 x
     128 (init seconds, step ms, tokens/s, peak memory, every step's loss
     and grad norm finite, every leaf moved, one step profiled: device
     launches of the forward, backward and optimizer, busy share);
     mistral-nemo-12b at full width and 4 of 40 layers with remat on, off
     and ``"dots"`` (peak memory, step ms), one step profiled, and 4
     float32 microbatches against one batch (max|d params| < 5e-3); the
     ten reduced archs, one float32 step card vs CPU under the training
     tests' rule; resume on the card (a run checkpointed at step 5 and
     resumed == an uninterrupted 10-step run, bit for bit, deterministic
     algorithms); no kernel launched.
 21. dry-run and roofline — first the roofline against steps the card
     takes, one card, no mesh, with no helper process running: phase 20's
     rwkv6-1.6b 8 x 128 train step and phase 18's gemma3-4b decode step at
     batch 4, each counted on the card by ``launch.op_cost`` and timed
     (CUDA events); then, the card idle, in two helper processes (host
     work on fake tensors), ``repro_torch.launch.dryrun`` at full width on
     the 256-rank fake mesh (a DTensor mesh over a fake process group):
     mistral-nemo-12b x train_4k (fsdp, 2 microbatches: the default 8
     traces four times as long) and gemma3-4b x decode_32k (fsdp), every
     reference key finite, per-device peak against the card's 80 GB, the
     three roofline terms, bottleneck, roofline fraction; and the two card
     steps counted on fake tensors: the card's count == the fake count
     (FLOPs), the measured step >= max(t_compute, t_memory) of the count
     (its roofline share <= 100 %), its MFU (model FLOPs / peak / step),
     and the fake step's peak memory against phase 20's
     ``max_memory_allocated`` (within ``ROOF_MEM_BAND``); no process group
     in this process; no kernel launched.
 22. ranks — several ranks on the one card: two gloo ranks (NCCL refuses
     two ranks on one device), each a process on cuda:0, started once by
     ``repro_torch.distrib.ranks.run_ranks`` with no helper process beside
     them, the kernels built before: (a) the row mesh: phase 10(a)'s fig06
     grid (FATTREE_128, SwitchLB(ops, reps), ``collect="summary"`` with
     early exit) to 1200 ticks, past the first failure window, one row per
     rank; every row == the main path's run at tick 1200 (phase 4 keeps
     both cells' states there) on every leaf, exact launches per rank, and
     ``ticks_run`` the one-rank sweep's; (b) the connection axis: phase
     12's 10**5 row with ``conn_devices=2`` ((rows, conns) = (1, 2)), every
     leaf == phase 12's one-rank card run, each rank's peak memory and
     bitmap bytes per connection against it; (c) MoE expert parallelism:
     phase 19's phi3.5-moe (full width, 8 layers, bf16) on a (1, 2)
     ("data", "model") mesh, each rank drawing only its half of the experts,
     its 4 x 32 prefill and 4 decode steps fed phase 19's greedy tokens:
     logits against phase 19's by the bf16 serve rule, the prefill's drops
     equal; init seconds, peak memory and decode tokens/s per rank; (d)
     ``checkpoint.restore(axes=)`` of a reduced checkpoint the parent saved
     onto the (1, 2) mesh, each rank's shards bit-equal to their blocks.
     The collectives of a CUDA tensor go through the host (gloo); no run
     here covers NCCL across several cards.
 23. examples — the bench runner's flight recorder and the user examples
     (``repro_torch.examples``): quickstart (ECMP / OPS / REPS at 240 ticks,
     OPS and REPS under two uplinks down from tick 300 at 320) and
     failover_demo (the soak runtime's injected spine at 250, read live at
     350, horizon 400) on the card, every printed line and summary == the
     CPU's (two helper processes, gone before the next step), quickstart's
     launches exact; ``python -m repro_torch.bench.run --only fig03 --smoke``
     untraced and with ``--trace 64``: every row's ``derived`` equal, rows
     stamped ``trace`` 0 and 64, the grid walls side by side, and a traced
     run of ``table1`` merged into the untraced file reads ``"trace":
     "mixed"``; serve_batched with the reference's arguments (tokens in the
     vocabulary, the prefill's logits finite); train_lm (reduced
     mistral-nemo-12b, 8 x 128) for 20 steps checkpointed every 10 == a run
     ``--resume``d from a copy of its step-10 checkpoint, bit for bit
     (deterministic algorithms).

The line before the last is a JSON object with one entry per kernel
(``launches`` counts the main path's, fig18's, the arena's, the fleet's,
the telemetry, the sweep, the fabric, the scale, the balls-into-bins, the
soak, the chaos and the fig15-hook phases' runs, and the channels,
the two serve, the train and the roofline phases', which launch none, the
ranks phase's, summed over its ranks, and the examples phase's; the flat
``ecmp_hash`` is
launched there no more); the last line
is ``{"ok": true, "device": {...}}``.  It imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import multiprocessing
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))  # serve_parity: the serving tests' rule (no JAX)

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
# the ranks phase (22): the fig06 grid's horizon on two ranks, past the first
# failure window (150-800); the main path keeps its rows' states at this tick
RANKS_FIG06_TICKS = 1200
RANKS_MOE_DECODE = 4  # phi3.5-moe's decode steps on the (1, 2) model mesh
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
    bins_kernel_shapes(dev, rs, shapes["BINS_STEPS"])
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


def index_add_ms(seg, fields, S: int, got, what: str) -> float:
    """The library column of ``seg_sum`` at a shape: one ``index_add_``
    (zeroing included, as at the engine's shape) over the fields stacked as
    int32 ``(F, B * K)`` onto the rows' bins flattened row-major, ``B * (S +
    1)`` (an id out of range onto its row's spill bin ``S``); its result
    held against the kernel's ``got``; device ms, CUDA-graph replay, median
    of 5."""
    import torch

    B = seg.shape[0] if seg.dim() == 2 else 1
    seg2 = seg.reshape(B, -1)
    K, F = seg2.shape[1], len(fields)
    vals = torch.stack([f.reshape(B, K).to(torch.int32) for f in fields]).reshape(F, B * K)
    off = torch.arange(B, device=seg.device)[:, None] * (S + 1)
    idx = (torch.where((seg2 >= 0) & (seg2 < S), seg2, S) + off).reshape(-1).long()

    def library():
        return torch.zeros((F, B * (S + 1)), dtype=torch.int32,
                           device=seg.device).index_add_(1, idx, vals)

    lib = library().reshape(F, B, S + 1)[:, :, :S].permute(1, 0, 2)
    if not torch.equal(lib, got.reshape(B, F, S)):
        raise AssertionError(f"seg_sum {what}: index_add_ differs from the kernel")
    inner = 50 if B * K <= 2**20 else 5
    return time_ms(library, reps=5, inner=inner)


def bins_kernel_shapes(dev, rs, steps: int) -> None:
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
        lib = index_add_ms(t, [ones], n, cnt, f"balls-bins step n={n}")
        log(f"kernel balls-bins step n={n}: seg_rank (K=S={n}) bit-exact, {nbytes(t, rk)} B, device "
            f"{time_ms(lambda: sr_mod.seg_rank_cuda(t, n)):.5f} ms, bound {sr_b[0]:.3e} ms "
            f"({sr_b[1]}); seg_sum (K=S={n}, one bool field) {nbytes(t, ones, cnt)} B, device "
            f"{time_ms(lambda: ss_mod.seg_sum_cuda(t, [ones], n)):.5f} ms, library (index_add_) "
            f"{lib:.5f} ms, bound {ss_b[0]:.3e} ms")
    for B, K, S, what in ((steps, 128, 128, "OPS run, steps x n"), (8, 2**21, 32, "fig16 chunk"),
                          (64, 2**21, 32, "fig16, all 64 trials")):
        seg = i32(rs.randint(0, S, size=(B, K)))
        vals = torch.as_tensor(rs.rand(B, K) < 0.99, device=dev)
        got = ss_mod.seg_sum_cuda(seg, [vals], S)
        equal_all([got], [ref.seg_sum_ref(seg, [vals], S)], f"seg_sum {what}")
        b = bound_ms(nbytes(seg, vals, got), B * K)
        ms = time_ms(lambda: ss_mod.seg_sum_cuda(seg, [vals], S), reps=3, inner=5)
        lib = index_add_ms(seg, [vals], S, got, what)
        log(f"kernel seg_sum ({what}: B={B}, K={K}, S={S}, one bool field): bit-exact; "
            f"{nbytes(seg, vals, got)} B, device {ms:.5f} ms, library (index_add_) {lib:.5f} ms, "
            f"bound {b[0]:.3e} ms ({b[1]})")
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
            ss_lib = index_add_ms(seg, fields, S, got, f"NC={NC} B={B}")
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
                f"device {ss_ms:.5f} ms, library (index_add_) {ss_lib:.5f} ms, bound "
                f"{ss_b[0]:.3e} ms ({ss_b[1]}); seg_rank (S={NC + 1}, "
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


FABRIC_LBS = ("reps", "adaptive_roce")


def fabric_check_sim(fabric: str, lbn: str, dev):
    """A cell of the fabric phase's (b): ``fabric`` at 128 hosts, ``lbn``,
    a permutation of 1024-packet messages, ToR-0's first two up queues
    down from tick 100."""
    from repro_torch.configs import FATTREE_128
    from repro_torch.core import make_lb
    from repro_torch.netsim import Simulator, Topology, failures, workloads

    cfg = FATTREE_128.replace(fabric=fabric)
    ups = [int(q) for q in Topology.build(cfg).t0_up_queues(0)[:2]]
    return Simulator(cfg, workloads.permutation(cfg.n_hosts, 1024, seed=3),
                     make_lb(lbn, evs_size=cfg.evs_size),
                     failures=failures.link_down(ups, 100, failures.FOREVER), device=dev)


def fabric_phase(dev, fig18_card: dict, fig18_ticks: int, check_ticks: int, cpu_run) -> dict:
    """Generated fabrics at full width: (a) the clos3 table form of
    FATTREE_128_3T (``clos3:pods=4,tors=2,hosts=16,aggs=4,up=4``), fig18's
    REPS cell, equals the fig18 phase's arithmetic card run of
    ``fig18_ticks`` (its card-vs-CPU horizon) on every leaf; (b) ``rail`` and ``mesh`` at 128 hosts (8 ToRs x 16 hosts; 16
    rails, 2 planes), REPS and adaptive RoCE, a permutation of 1024-packet
    messages with ToR-0's first two up queues down from tick 100, card ==
    CPU on every leaf after ``check_ticks`` (the CPU's runs ``cpu_run``, a
    pending ``early_cpu_run("fabrics", check_ticks)``).  The table form
    launches once per tick, the arithmetic routing and the flat hash never.
    Returns the launches per kernel."""
    from repro_torch.configs import FATTREE_128_3T
    from repro_torch.core import make_lb
    from repro_torch.kernels import ops
    from repro_torch.netsim import Simulator, sim_state_to_numpy, summarize, workloads

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
    cpu = None
    for fabric in TABLE_FABRICS[1:3]:
        for lbn in FABRIC_LBS:
            sim = fabric_check_sim(fabric, lbn, dev)
            state, counts, secs = counted_run(f"{fabric}/{lbn}", sim, check_ticks,
                                              fabric_per_tick(lbn == "reps"))
            for k, n in counts.items():
                totals[k] += n
            finals = [sim_state_to_numpy(state)]
            log(f"fabric {fabric} {lbn}: {check_ticks} ticks on {dev} in {secs:.3f} s")
            if cpu is None:
                cpu, c_secs = cpu_run.get(timeout=900)
                log(f"fabrics: every rail and mesh cell's {check_ticks} ticks on cpu in "
                    f"{c_secs:.3f} s (a helper process)")
            finals.append(cpu[(fabric, lbn)])
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
    the launches per kernel and the 10**5 row's card run ``(SimState
    leaves, run_row's info)``."""
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
    win = 10  # profiled ticks of each tick body
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
            row5 = (finals[0], info)  # the ranks phase's one-rank reference
            del eng, res
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
    return totals, row5


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


def main_path(dev, ticks: int, snap_at: int = RANKS_FIG06_TICKS) -> tuple[dict, dict, dict, dict]:
    """The fig06 OPS and REPS cells for ``ticks`` ticks with exact launch
    counts; returns the launches per kernel, the ticks/s per cell, each
    cell's ``(simulator, final state, ticks)`` (the sweep phase continues
    them as its serial references) and each cell's SimState leaves at tick
    ``snap_at`` (the ranks phase's serial references; the run is stepped to
    there, copied to the host untimed, and stepped on)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.netsim import sim_state_to_numpy, summarize
    from repro_torch.netsim.engine import TickTrace, add_rows, drop_rows

    # the routing step is one next_queue launch; the flat hash runs no more
    per_tick = {"ops": {"seg_sum": 4, "seg_rank": 1, "queue_tick": 1, "reps_tick": 0,
                        "next_queue": 1, "ecmp_hash": 0},
                "reps": {"seg_sum": 4, "seg_rank": 1, "queue_tick": 1, "reps_tick": 1,
                         "next_queue": 1, "ecmp_hash": 0}}
    totals = {k: 0 for k in ops.KERNEL_MODULES}
    rates, finals, snaps = {}, {}, {}
    for lb in ("ops", "reps"):
        sim = fig06_cell(lb, dev)
        states = add_rows(sim.init_state())
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        secs, parts = 0.0, []
        for t0, n in ((0, snap_at), (snap_at, ticks - snap_at)):
            c0 = time.perf_counter()
            states, tr = sim.run_rows(n, states, sim.base_key[None], t0=t0)
            torch.cuda.synchronize()
            secs += time.perf_counter() - c0
            parts.append(tr)
            if t0 == 0:
                snaps[lb] = sim_state_to_numpy(drop_rows(states))
        state = drop_rows(states)
        trace = TickTrace(*(torch.cat(f)[:, 0] for f in zip(*parts)))
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
    return totals, rates, finals, snaps


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


def profile_ticks(label: str, step, ticks: int, unit: str = "tick") -> None:
    """``step(i)`` for ``i < ticks`` under ``torch.profiler``: wall time per
    tick (or other ``unit`` of work), the device's busy share, device
    launches per tick, and the port's kernels' device time per launch inside
    the real tick."""
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
    log(f"profile ({label}): {wall_us / ticks:.1f} us wall per {unit} "
        f"(profiler on), device busy {busy_us / ticks:.1f} us per {unit} = "
        f"{100 * busy_us / wall_us:.2f} % busy, {len(dev_events) / ticks:.1f} device "
        f"launches per {unit}")
    for tag, (per_tick, med, tot) in ours.items():
        log(f"profile ({label}): {tag}: {per_tick:.1f} launches per {unit}, median {med:.2f} us "
            f"device per launch, {tot:.2f} us per {unit}")
    for name, durs in top:
        log(f"profile top ({label}): {sum(durs) / ticks:8.2f} us/{unit} "
            f"{len(durs) / ticks:5.1f}x  {name[:90]}")


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


def three_tier_cell(dev, ticks: int, check_ticks: int, cpu_run) -> tuple[dict, dict]:
    """The fig18/3tier/reps cell on the card with exact launch counts, every
    queue region carrying traffic; then card == CPU on every SimState leaf
    after ``check_ticks`` (the CPU's run ``cpu_run``, a pending
    ``early_cpu_run("fig18", check_ticks)``).  Returns the launches per
    kernel and the leaves of the card run of ``check_ticks``
    (``sim_state_to_numpy``)."""
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
    t0 = time.perf_counter()
    st, _ = fig18_cell(dev).run(check_ticks)
    finals = [sim_state_to_numpy(st)]
    log(f"card vs CPU: fig18/3tier/reps {check_ticks} ticks on {dev} in "
        f"{time.perf_counter() - t0:.3f} s")
    cpu, c_secs = cpu_run.get(timeout=900)
    finals.append(cpu)
    log(f"card vs CPU: fig18/3tier/reps {check_ticks} ticks on cpu in {c_secs:.3f} s "
        f"(a helper process)")
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


def small_fleet(dev):
    """The fleet phase's (b): FATTREE_32_CI, REPS, a permutation of 48-packet
    messages, two ToR-0 uplinks down over ticks 30-300, seeds 0, 5, 9."""
    from repro_torch.configs import FATTREE_32_CI
    from repro_torch.core import make_lb
    from repro_torch.netsim import FleetRunner, Topology, failures, workloads

    cfg = FATTREE_32_CI
    ups = [int(q) for q in Topology.build(cfg).t0_up_queues(0)[:2]]
    return FleetRunner(cfg, workloads.permutation(32, 48, seed=3),
                       make_lb("reps", evs_size=cfg.evs_size, freezing_timeout=200),
                       failures=failures.link_down(ups, 30, 300), seeds=(0, 5, 9), device=dev)


def fleet_phase(dev, rows_ticks: int, check_ticks: int, bench_ticks: int, rounds: int,
                warm: int, one_run_rate: float, cpu_small) -> dict:
    """The fig06/reps cell as a fleet of seeds (``FleetRunner``): (a) B = 4
    rows equal four serial card runs on every SimState leaf and trace field;
    (b) a small fleet (FATTREE_32_CI, B = 3) is the same on the card and on
    the CPU (``cpu_small``, a pending ``early_cpu_run("fleet",
    check_ticks)``); (c) each kernel's launches per tick are exact and the
    same at every B; (d) row-ticks/s against B in (1, 4, 16, 64), ``rounds`` rounds
    with the B values interleaved, ``bench_ticks`` ticks each from a state
    warmed for ``warm`` ticks, each also set against ``one_run_rate`` (the
    main path's fig06/reps ticks/s over its whole run); (e) a profiled
    window of 32 ticks at B = 64.  Returns the launches of the fleet runs
    per kernel, and the warmed B = 64 fleet ``(fleet, states, warm)``."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.netsim import sim_state_to_numpy
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

    # (b) card == CPU, a small fleet (the CPU's run in a helper process)
    small = small_fleet(dev)
    st, _ = small.run(check_ticks)
    finals = [[sim_state_to_numpy(small.state_at(st, i)) for i in range(small.n_runs)],
              cpu_small.get(timeout=900)[0]]
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
    n_prof = 32
    draws = sim.tick_draws(keys, warm, n_prof)

    def step(i):
        nonlocal st
        st, _ = sim.step_rows(st, warm + i, draws.row(i))

    profile_ticks(f"fleet B={B}, ticks {warm}-{warm + n_prof}", step, n_prof)
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


def small_telemetry(dev, ticks: int) -> tuple:
    """The telemetry phase's (b): ``small_rows`` as a B = 3 fleet, each row
    its own scenario, the default spec with even / odd cohort channels,
    ``run_summary`` for ``ticks``; ``(fleet, states, telemetry)``."""
    from repro_torch.netsim import TelemetrySpec

    rows = small_rows()
    nc = rows[0][0][1].n_conns
    spec = TelemetrySpec.default().with_cohorts({"even": range(0, nc, 2),
                                                 "odd": range(1, nc, 2)})
    small, scn = row_fleet(rows, (0, 5, 9), dev)
    return (small, *small.run_summary(ticks, spec, scn=scn))


def early_cpu_run(what: str, ticks: int) -> tuple:
    """The CPU side of a card-vs-CPU check of phases 5, 8, 9 and 11, for a
    helper process started before them: ``(result, seconds)`` after
    ``ticks``, the result the SimState leaves of the fig18/3tier/reps cell
    (``"fig18"``), ``{(fabric, LB): leaves}`` of the rail and mesh cells
    (``"fabrics"``), each row's leaves of the small fleet (``"fleet"``), or
    the small telemetry fleet's carry and each row's leaves
    (``"telemetry"``)."""
    import torch

    from repro_torch.netsim import sim_state_to_numpy

    torch.set_num_threads(2)
    t0 = time.perf_counter()
    rows = lambda f, st: [sim_state_to_numpy(f.state_at(st, i)) for i in range(f.n_runs)]
    if what == "fig18":
        out = sim_state_to_numpy(fig18_cell("cpu").run(ticks)[0])
    elif what == "fabrics":
        out = {(f, lbn): sim_state_to_numpy(fabric_check_sim(f, lbn, "cpu").run(ticks)[0])
               for f in TABLE_FABRICS[1:3] for lbn in FABRIC_LBS}
    elif what == "fleet":
        f = small_fleet("cpu")
        out = rows(f, f.run(ticks)[0])
    else:
        f, st, tl = small_telemetry("cpu", ticks)
        out = (tl.tel, rows(f, st))
    return out, time.perf_counter() - t0


def telemetry_phase(dev, ticks: int, check_ticks: int, bench_ticks: int, rounds: int,
                    warmed, cpu_small) -> dict:
    """The summary path (``FleetRunner.run_summary``, default telemetry) on
    the card: (a) four heterogeneous rows at full width (fig08's REPS
    column and fig06) equal their serial card runs on every SimState leaf
    and telemetry slot; (b) a FATTREE_32_CI fleet of three rows, each its
    own scenario, with cohort channels: card == CPU, carry and leaves (the
    CPU's run ``cpu_small``, a pending ``early_cpu_run("telemetry",
    check_ticks)``); (c)
    launches per tick by name with the default spec against without it, at
    B = 1 and 64 on fig06/reps (the telemetry's the same at both), and no
    device-to-host copy or synchronize per tick; (d) row-ticks/s of
    ``run_summary`` against ``run_rows`` (``run``'s body) at B = 1 and 64,
    both resumed at the fleet phase's warmed rows, interleaved rounds.
    Returns the launches per kernel."""
    import bisect
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
    t0 = time.perf_counter()
    small, st_g, tl_g = small_telemetry(dev, check_ticks)
    log(f"card vs CPU: telemetry FATTREE_32_CI rows B=3 on {dev}: {check_ticks} ticks in "
        f"{time.perf_counter() - t0:.3f} s")
    (tel_c, leaves_c), c_secs = cpu_small.get(timeout=900)
    log(f"card vs CPU: telemetry FATTREE_32_CI rows B=3 on cpu: {check_ticks} ticks in "
        f"{c_secs:.3f} s (a helper process)")
    if tl_g.tel.tobytes() != tel_c.tobytes():
        raise AssertionError("card vs CPU: the telemetry carries differ at "
                             f"{(tl_g.tel != tel_c).nonzero()}")
    for i in range(3):
        same_leaves(sim_state_to_numpy(small.state_at(st_g, i)), leaves_c[i],
                    f"telemetry small row {i}")
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

    prof_ticks = 10
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
            cpu = torch.autograd.DeviceType.CPU
            d2h = ends = 0
            inside = []
            events = prof.events()
            ranges = sorted((e.time_range.start, e.time_range.end) for e in events
                            if e.name == TICK_RANGE and e.device_type == cpu)
            starts_at = [lo for lo, _ in ranges]

            def in_tick(t):
                i = bisect.bisect_right(starts_at, t) - 1
                return i >= 0 and t < ranges[i][1]

            for e in events:
                d2h += "DtoH" in e.name or "DeviceToHost" in e.name
                if "Synchronize" in e.name:
                    # the window's closing synchronize and the profiler's own
                    # are device synchronizes that begin after the last tick's
                    # range; a tick's would be a stream synchronize (a blocking
                    # copy) or any synchronize begun inside a tick's range.
                    # Placed on the host's timeline: the profiler's nesting of
                    # runtime calls under other events is not reliable
                    if e.name == "cudaDeviceSynchronize" and not in_tick(e.time_range.start):
                        ends += 1
                    else:
                        inside.append(e)
                if e.device_type == torch.autograd.DeviceType.CUDA and e.name != TICK_RANGE:
                    per[e.name] += 1
            if d2h or inside:
                last = ranges[-1][1] if ranges else 0.0
                seen = "; ".join(
                    f"{e.name} at {e.time_range.start - last:+.1f} us from the last tick's end "
                    f"(parent {e.cpu_parent.name if e.cpu_parent is not None else None})"
                    for e in inside)
                raise AssertionError(f"B={B} summary={summary}: {d2h} device-to-host copies and "
                                     f"{len(inside)} synchronizes in {prof_ticks} ticks: {seen}")
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
                f"kernels {ours:g}); {d2h} device-to-host copies, {len(inside)} synchronizes "
                f"inside ticks ({ends} device synchronizes after the last tick: the window's end, the "
                f"profiler's)")
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
    # a ring that holds a whole 8000-tick run of the REPS row (a few
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

    # (a) the fig06 grid at full width, to ``fig06_ticks``
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
    n_w = min(lo // 2, prof_ticks)
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


def bins_cpu_groups(steps: int, n: int) -> list:
    """The CPU side's cells split over ``n`` helper processes: fig13's and
    fig17's in the first, fig16's over the rest by their draws (trials x
    m; the largest first, onto the least loaded), which dominate it."""
    from repro_torch.bench import bins

    keys = [k for k, _ in bins.cells("cpu", steps)]
    groups = [[k for k in keys if k[0] != "evs"]] + [[] for _ in range(n - 1)]
    draws = lambda k: fig16_cpu_trials(k[1] * 2**k[2]) * k[1] * 2**k[2]
    load = [0] * n
    for k in sorted((k for k in keys if k[0] == "evs"), key=draws, reverse=True):
        i = min(range(1, n), key=load.__getitem__)
        groups[i].append(k)
        load[i] += draws(k)
    return groups


def bins_runs(dev, steps: int, keys=None) -> dict:
    """The outputs of ``bench/bins.py``'s cells (those in ``keys``, all by
    default) on ``dev``, as numpy arrays keyed by cell (the card's in
    ``bins_phase``, the CPU's in helper processes beside it, the cells split
    by ``bins_cpu_groups``, fig16 on ``fig16_cpu_trials``), with each cell's
    seconds under ``("secs", key)``."""
    import torch

    from repro_torch.bench import bins

    torch.set_num_threads(2)
    on_card = torch.device(dev).type == "cuda"
    out = {}
    trials = (lambda m: bins.FIG16_TRIALS) if on_card else fig16_cpu_trials
    for k, fn in bins.cells(dev, steps, bins.PARTS, trials):
        if keys is not None and k not in keys:
            continue
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
    port's plain path on the CPU (in four helper processes while the card
    runs): fig13/14 at n = 8, 32, 128 for ``steps`` steps, fig17's
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
    groups = bins_cpu_groups(steps, 4)
    with multiprocessing.get_context("spawn").Pool(len(groups)) as pool:
        pending = [pool.apply_async(bins_runs, ("cpu", steps, g)) for g in groups]
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
SOAK_TICKS, SOAK_CHUNK, SOAK_KILL_AT, SOAK_RING = 120, 120, 120, 2048
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


# the chaos phase: tests/test_chaos.py's campaign seed (11) and three of
# its scenarios on FATTREE_32_CI: the known-bad fixture (24-packet messages)
# at the 640 ticks it needs to violate, link flapping with a degraded link
# (generate(2)) and gray loss at rate 0.2424 (generate(3)), 1280 ticks each
# at the campaign's own 64-packet messages (at the tests' 24 the traffic has
# drained before the flapping link first goes down: no drop to recover from)
CHAOS_SEED = 11
CHAOS_LABELS = ("known_bad", "generate(2)", "generate(3)")


def chaos_scenarios() -> dict:
    from repro_torch.netsim import chaos

    c = chaos.ChaosCampaign(seed=CHAOS_SEED, device="cpu")  # generate draws on the host
    return {"known_bad": chaos.known_bad_scenario(ticks=640, chunk=160),
            "generate(2)": c.generate(2), "generate(3)": c.generate(3)}


def chaos_run(label: str, dev) -> dict:
    """One chaos scenario through ``ChaosCampaign.run_scenario`` on ``dev``
    (the CPU side in a helper process): its violations as dicts, its record,
    the record's digest and the seconds."""
    import torch

    from repro_torch.netsim import chaos

    if torch.device(dev).type == "cpu":
        torch.set_num_threads(2)
    c = chaos.ChaosCampaign(seed=CHAOS_SEED, device=dev)
    t0 = time.perf_counter()
    violations, record = c.run_scenario(chaos_scenarios()[label])
    return {"violations": [v.to_dict() for v in violations], "record": record,
            "digest": chaos.record_digest(record), "secs": time.perf_counter() - t0}


def chaos_phase(dev, cpu_runs: dict) -> dict:
    """The chaos engine (``repro_torch.netsim.chaos``) on the card: the three
    ``CHAOS_LABELS`` scenarios through ``ChaosCampaign(device=cuda)`` (a
    ``SoakRunner`` per scenario, invariants checked at every 160-tick chunk
    boundary and post hoc), each against the same scenario on the CPU (in
    helper processes beside the card): the violation lists and the record
    digests equal; the known-bad fixture under ECMP violates with
    ``{"completion"}`` exactly, the other two pass.  Exact kernel launches
    per scenario (a summary sweep's per-tick counts; ``reps_tick`` only
    where REPS runs).  Returns the launches per kernel."""
    from repro_torch.kernels import ops

    totals = {k: 0 for k in ops.KERNEL_MODULES}
    counted = _counting(totals)
    t_start = time.perf_counter()
    scenarios = chaos_scenarios()
    got = {}
    for label in CHAOS_LABELS:
        s = scenarios[label]
        card, secs, counts = counted(lambda: chaos_run(label, "cuda"))
        want = {k: n * s.ticks for k, n in SWEEP_PER_TICK.items()}
        want["reps_tick"] = s.ticks if s.lb == "reps" else 0
        exact_launches(f"chaos {label}", counts, want)
        cpu = cpu_runs[label].get(timeout=900)
        if card["violations"] != cpu["violations"]:
            raise AssertionError(f"chaos {label}: card violations {card['violations']} != CPU "
                                 f"{cpu['violations']}")
        if card["digest"] != cpu["digest"] or json.dumps(card["record"], sort_keys=True) != \
                json.dumps(cpu["record"], sort_keys=True):
            raise AssertionError(f"chaos {label}: card record {card['digest'][:12]} != CPU "
                                 f"{cpu['digest'][:12]}")
        got[label] = card
        summ = card["record"]["summaries"][s.name][0]
        log(f"chaos {label} ({s.lb}, {s.ticks} ticks, faults "
            f"{[(f.archetype, f.start, f.end, f.rate) for f in s.faults]}): violations "
            f"{sorted({v['invariant'] for v in card['violations']})}; completed="
            f"{summ['completed']}/{summ['n_conns']} drops_fail={summ['drops_fail']} "
            f"timeouts={summ['timeouts']}; card {secs:.3f} s ({s.ticks / secs:.1f} ticks/s), CPU "
            f"{cpu['secs']:.3f} s; card == CPU: violations and record digest "
            f"{card['digest'][:12]}; launches={ {k: v for k, v in counts.items() if v} }")
    bad = {v["invariant"] for v in got["known_bad"]["violations"]}
    if bad != {"completion"}:
        raise AssertionError(f"chaos known_bad: violations {bad}, expected {{'completion'}}")
    for label in ("generate(2)", "generate(3)"):
        if got[label]["violations"]:
            raise AssertionError(f"chaos {label}: REPS violated {got[label]['violations']}")
    log(f"chaos phase: {time.perf_counter() - t_start:.1f} s")
    return totals


# the fig15 hook phase: ForcedFreezeReps on FATTREE_32_CI tornado traffic
# (96-packet messages, in flight past F), forced at F inside the horizon
FIG15_FORCE_AT, FIG15_TICKS, FIG15_MSG_PKTS = 200, 300, 96


def fig15_run(dev) -> dict:
    """``ForcedFreezeReps(force_at=F)`` (``bench/fig15_forced_freezing``) on
    ``dev``: ticks ``[0, F)``, tick F, then the rest to ``FIG15_TICKS``;
    the SimState leaves after each part, as numpy, and the seconds."""
    import torch

    from repro_torch.bench.fig15_forced_freezing import ForcedFreezeReps
    from repro_torch.configs import FATTREE_32_CI
    from repro_torch.netsim import Simulator, sim_state_to_numpy, workloads
    from repro_torch.netsim.engine import add_rows, drop_rows

    on_card = torch.device(dev).type == "cuda"
    if not on_card:
        torch.set_num_threads(2)
    cfg, F = FATTREE_32_CI, FIG15_FORCE_AT
    sim = Simulator(cfg, workloads.tornado(cfg.n_hosts, FIG15_MSG_PKTS),
                    ForcedFreezeReps(force_at=F, evs_size=cfg.evs_size), device=dev)
    out, st, t0 = {}, sim.init_state(), time.perf_counter()
    for part, (start, n) in (("before", (0, F)), ("at", (F, 1)),
                             ("final", (F + 1, FIG15_TICKS - F - 1))):
        st = drop_rows(sim.run_rows(n, add_rows(st), sim.base_key[None], t0=start)[0])
        out[part] = sim_state_to_numpy(st)
    out["secs"] = time.perf_counter() - t0
    out["freezing_timeout"] = sim.lb.cfg.freezing_timeout
    return out


def fig15_phase(dev, cpu_run) -> dict:
    """fig15's forced freeze through ``RepsLB``'s ``after_acks`` hook on the
    card: card == CPU on every SimState leaf before F, after F and at the
    horizon; every connection with ``explore_counter == 0`` before F (and
    not leaving an earlier freeze at F) is freezing after F, until
    ``F + freezing_timeout``; ``reps_tick`` launches once per tick and once
    more at F (the ACK-only launch before the hook), the other kernels as
    on any REPS tick.  Returns the launches per kernel."""
    from repro_torch.kernels import ops

    totals = {k: 0 for k in ops.KERNEL_MODULES}
    counted = _counting(totals)
    t_start = time.perf_counter()
    card, secs, counts = counted(lambda: fig15_run("cuda"))
    T, F = FIG15_TICKS, FIG15_FORCE_AT
    want = {k: n * T for k, n in FLEET_PER_TICK.items()}
    want["reps_tick"] = T + 1
    exact_launches("fig15 hook", counts, want)
    cpu = cpu_run.get(timeout=900)
    for part in ("before", "at", "final"):
        same_leaves(card[part], cpu[part], f"fig15 hook ({part})")
    b, a = card["before"], card["at"]
    leaving = b["lb_state.is_freezing"] & (F > b["lb_state.exit_freezing"])
    can = (b["lb_state.explore_counter"] == 0) & ~leaving
    entered = can & ~b["lb_state.is_freezing"]
    if not entered.any() or not a["lb_state.is_freezing"][can].all() or not (
            a["lb_state.exit_freezing"][entered] == F + card["freezing_timeout"]).all():
        raise AssertionError(f"fig15 hook: at F={F}, {int(can.sum())} connections could freeze, "
                             f"{int(a['lb_state.is_freezing'][can].sum())} froze")
    log(f"fig15 hook: ForcedFreezeReps(force_at={F}) on FATTREE_32_CI tornado, {T} ticks in "
        f"{secs:.3f} s on the card (CPU {cpu['secs']:.3f} s): card == CPU on all "
        f"{len(card['final'])} SimState leaves before F, after F and at {T}; "
        f"{int(can.sum())} connections with explore_counter 0 all freezing after F "
        f"({int(entered.sum())} newly); launches={ {k: v for k, v in counts.items() if v} } "
        f"(reps_tick {T} + 1 at F)")
    log(f"fig15 hook phase: {time.perf_counter() - t_start:.1f} s")
    return totals


# the channels phase: benchmarks/reps_channels_bench.py's three scenarios
# (256 chunks in rounds of 32 over 16 channels) under the REPS scheduler
def channels_run(dev) -> dict:
    """``bench/reps_channels_bench``'s scenarios under REPS on ``dev`` (the
    CPU side in a helper process): per scenario the ``ReduceReport`` as a
    dict, the scheduler's state leaves and key as numpy, its rounds and
    the seconds."""
    import dataclasses

    import torch

    from repro_torch.bench import reps_channels_bench as rcb
    from repro_torch.core.reps import FIELDS

    if torch.device(dev).type == "cpu":
        torch.set_num_threads(2)
    out = {}
    for name, _ in rcb.SCENARIOS:
        rep, sched, secs = rcb.run_scenario(name, "reps", dev)
        out[name] = {"report": dataclasses.asdict(rep), "secs": secs,
                     "state": {f: getattr(sched.state, f).cpu().numpy() for f in FIELDS},
                     "key": sched.key.cpu().numpy(), "round_idx": sched.round_idx}
    return out


def channels_phase(dev, cpu_run) -> dict:
    """The REPS channel scheduler (``repro_torch.ft``) with its state and
    key on the card against the same scenarios on the CPU (a helper
    process): every ``ReduceReport`` field, every state leaf and the key
    equal; no kernel launched (the scheduler is ``core.reps``' tensor code,
    one chunk at a time).  Returns the launches per kernel (none)."""
    from repro_torch.kernels import ops

    totals = {k: 0 for k in ops.KERNEL_MODULES}
    counted = _counting(totals)
    t_start = time.perf_counter()
    card, secs, counts = counted(lambda: channels_run(dev))
    exact_launches("channels", counts, {})
    cpu = cpu_run.get(timeout=600)
    for name, c in card.items():
        w = cpu[name]
        if c["report"] != w["report"] or c["round_idx"] != w["round_idx"]:
            raise AssertionError(f"channels {name}: card report {c['report']} != CPU {w['report']}")
        same_leaves({**c["state"], "key": c["key"]}, {**w["state"], "key": w["key"]},
                    f"channels {name}")
        r = c["report"]
        chunks = 256 + r["timeouts"]
        log(f"channels {name}/reps: rounds={r['rounds']} makespan_us="
            f"{r['total_latency_us']:.0f} p99_us={r['p99_chunk_latency_us']:.0f} timeouts="
            f"{r['timeouts']} ecn={r['ecn_marked']}; card {c['secs']:.3f} s "
            f"({chunks / c['secs']:.1f} chunks/s), CPU {w['secs']:.3f} s; card == CPU on the "
            f"report, all {len(c['state'])} state leaves and the key")
    log(f"channels phase: {time.perf_counter() - t_start:.1f} s (card runs {secs:.1f} s; "
        f"no kernel launched)")
    return totals


# the serve phase: the six transformer archs the port builds, at reduced();
# a prompt past reduced gemma3's 64-token window, then decode steps; the
# tolerances (max|d| / max|ref|) of tests/test_torch_serve.py
SERVE_ARCHS = ("gemma3-4b", "gemma-7b", "mistral-nemo-12b", "qwen1.5-4b", "musicgen-large",
               "llava-next-mistral-7b")
SERVE_B, SERVE_P, SERVE_GEN = 2, 80, 3
SERVE_TOL = {"fp32": 1e-4, "bf16": 3e-2}
SERVE_CACHE_TOL = {"fp32": 2.0**-7, "bf16": 3e-2}
SERVE_INIT_TOL = 1e-5
# gemma3-4b at full size: the serve CLI's defaults, then one long prompt
# past the 1024-token window and the 1024-key chunk
SERVE_LONG = 2304


def rel_err(got, want) -> float:
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def family_forward(params, cfg, tokens):
    """The float32 eval forward's logits of any family."""
    from repro_torch.models import recurrent, transformer

    if cfg.family == "ssm":
        return recurrent.rwkv_forward(params, cfg, {"tokens": tokens})[0]
    if cfg.family == "hybrid":
        return recurrent.zamba_forward(params, cfg, {"tokens": tokens})[0]
    return transformer.forward(params, cfg, {"tokens": tokens})[0]


def serve_reduced_runs(dev, carry=None, cases=None, P: int = SERVE_P) -> dict:
    """Per case of ``cases`` (``(arch, shared-attention window or None)``;
    ``SERVE_ARCHS`` by default) at ``reduced()`` on ``dev``: the
    ``init_params(PRNGKey(0))`` leaves, the float32 forward logits of
    ``randint(PRNGKey(2), (B, P + GEN))``, and for the float32 model steps
    and the bfloat16 serve steps the logits and every state leaf (with its
    dtype) after the prefill and after each decode step
    (``serve_parity.run_serve``), with each MoE call's routing.  With
    ``carry`` (the CPU's result) each decode step starts from the CPU's
    state: a bfloat16 element that rounds the other way moves the next
    step by more than the matmuls' own rounding."""
    import dataclasses

    import torch

    from repro_torch import rng
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.train import make_serve_steps
    from repro_torch.tree import tree_flatten_with_path
    from serve_parity import fp32_steps, port_routing, run_serve

    if torch.device(dev).type == "cpu":
        torch.set_num_threads(2)
    np_ = lambda t: t.float().cpu().numpy()
    out = {}
    for arch, window in cases or [(a, None) for a in SERVE_ARCHS]:
        label = arch if window is None else f"{arch}/window{window}"
        cfg = reduced(get_config(arch))
        if window is not None:
            cfg = dataclasses.replace(cfg, shared_attn_window=window)
        m = build_model(cfg)
        params = m.init_params(rng.PRNGKey(0, device=dev))
        toks = rng.randint(rng.PRNGKey(2, device=dev), (SERVE_B, P + SERVE_GEN), 0, cfg.vocab)
        # the recurrent families' forward takes whole chunks: the prompt
        fwd = toks[:, :P] if cfg.family in ("ssm", "hybrid") else toks
        r = {"params": {k: np_(v) for k, v in tree_flatten_with_path(params).items()},
             "forward": np_(family_forward(params, cfg, fwd)), "routing": {}, "P": P}
        for mode, steps in (("fp32", fp32_steps(m)), ("bf16", make_serve_steps(m))):
            r["routing"][mode] = []
            with port_routing(r["routing"][mode]):
                r[mode] = run_serve(*steps, params, toks.cpu().numpy(),
                                    lambda a: torch.from_numpy(a).to(dev), P,
                                    P + SERVE_GEN + 1,
                                    states=None if carry is None else carry[label][mode][1])
        out[label] = r
    return out


def serve_reduced_check(card: dict, cpu: dict, found_ok: bool = False) -> None:
    """Card against CPU for every case: init leaves within
    ``SERVE_INIT_TOL``, the forward and the float32 steps' logits within
    1e-4, every state leaf by its dtype (``serve_parity``), the bfloat16
    steps within 3e-2, everything finite; MoE routing ids and kept
    assignments equal in the float32 steps.  ``found_ok`` (the recurrent
    and MoE families) lets the bfloat16 steps' routing flips and the CPU's
    own bf16 excursions be found rather than held
    (``serve_parity.assert_bf16_close``)."""
    import numpy as np

    from repro_torch.configs import get_config, reduced
    from serve_parity import (LEAF_TOL, TOL, assert_bf16_close, routing_divergence,
                              serve_errors)

    for label, c in card.items():
        w = cpu[label]
        init = max(rel_err(c["params"][k], w["params"][k]) if np.abs(w["params"][k]).max() else
                   float(np.abs(c["params"][k]).max()) for k in w["params"])
        worst = {"forward": rel_err(c["forward"], w["forward"])}
        tol = {"forward": TOL["fp32"]}
        for name, (err, dtype) in serve_errors(c["fp32"], w["fp32"]).items():
            worst["fp32 " + name] = err
            tol["fp32 " + name] = TOL["fp32"] if dtype == "logits" else LEAF_TOL["fp32", dtype]
        for (_, gi, gk), (_, wi, wk) in zip(c["routing"]["fp32"], w["routing"]["fp32"]):
            if not (np.array_equal(gi, wi) and np.array_equal(gk, wk)):
                raise AssertionError(f"serve {label}: float32 routing differs card vs CPU")
        found = []
        if found_ok:
            n_layers = reduced(get_config(label.split("/")[0])).n_layers
            calls = c["routing"]["bf16"]
            div = routing_divergence(calls, w["routing"]["bf16"], n_layers,
                                     SERVE_B) if calls else None
            res = assert_bf16_close(c["bf16"], w["bf16"], w["fp32"], div)
            worst.update({"bf16 " + k: v for k, v in res["held"].items()})
            found = res["found"]
        else:
            for name, (err, dtype) in serve_errors(c["bf16"], w["bf16"]).items():
                worst["bf16 " + name] = err
        tol.update({k: TOL["bf16"] for k in worst if k.startswith("bf16 ")})
        finite = np.isfinite(c["forward"]).all() and all(
            np.isfinite(g).all() for mode in ("fp32", "bf16") for g in c[mode][0])
        if not finite or init > SERVE_INIT_TOL or any(worst[k] > tol[k] for k in tol):
            raise AssertionError(f"serve {label}: card vs CPU init {init:.3e}, {worst} "
                                 f"(tolerances {tol}), finite={finite}")
        log(f"serve {label} (reduced): card vs CPU: init {init:.2e} (<= {SERVE_INIT_TOL}); "
            + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
            + f" (prefill {c['P']} + {SERVE_GEN} decode steps; "
            f"tolerances by dtype, serve_parity)"
            + (f"; found, not held: {found}" if found else ""))


def serve_phase(dev, cpu_run, smi: str) -> dict:
    """The transformer serving path (``repro_torch.launch.serve``,
    ``make_serve_steps`` over ``repro_torch.models``).  gemma3-4b at full
    width and depth through the serve CLI's defaults (init from PRNGKey(0)
    in bfloat16, 4 x 32 prompts, 16 greedy steps: init seconds, the first
    prefill and decode); then warm: the same greedy run again (the same
    tokens; decode tokens/s), prefill at 4 x 32 and 1 x 2304 (CUDA events;
    2304 is past the 1024-token window and the 1024-key chunk, so a query's
    first chunk is wholly masked), decode against the full forward at both
    (rel < 0.03 with float32 params over a float32 KV cache; logged over
    the bf16 cache, for float32 params and for the bf16 serve steps; every
    logit finite), the prompts
    and the embedding's threefry draw at a chunk boundary against the
    CPU's, peak device memory.  Then the six reduced archs card vs CPU
    (``serve_reduced_check``; the CPU side from a helper process).  No port
    kernel is launched.  Returns the launches per kernel (none)."""
    import numpy as np
    import torch

    from repro_torch import rng
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import common, transformer
    from repro_torch.train import make_serve_steps
    from repro_torch.tree import tree_flatten_with_path

    totals = {k: 0 for k in ops.KERNEL_MODULES}
    counted = _counting(totals)
    t_start = time.perf_counter()

    def cli():
        torch.cuda.reset_peak_memory_stats()
        run = serve.main([])  # the CLI's defaults: gemma3-4b, 4 x 32, 16 steps, on the card
        torch.cuda.synchronize()
        run["peak"] = torch.cuda.max_memory_allocated()
        return run

    run, secs, counts = counted(cli)
    exact_launches("serve CLI", counts, {})
    cfg, model, params = run["cfg"], run["model"], run["params"]
    n_params = sum(t.numel() for t in tree_flatten_with_path(params).values())
    B, P, G = run["tokens"].shape[0], run["prompts"].shape[1], run["tokens"].shape[1]
    log(f"serve {cfg.name} full ({cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab}, {n_params} parameters in bf16) through the CLI: init "
        f"{run['init_s']:.3f} s; first prefill {B}x{P} {run['prefill_s'] * 1e3:.1f} ms; "
        f"{G - 1} decode steps {run['decode_s'] * 1e3:.1f} ms "
        f"({(G - 1) * B / run['decode_s']:.1f} tok/s); peak memory "
        f"{run['peak'] / 2**30:.3f} GiB; sample {run['tokens'][0][:12].tolist()}; {secs:.1f} s")

    def checks():
        out = {}
        if not torch.equal(run["prompts"].cpu(),
                           rng.randint(rng.PRNGKey(1, device="cpu"), (B, P), 0, cfg.vocab)):
            raise AssertionError("serve: the card's prompts differ from the CPU's draw")
        # the embedding (671 M values, drawn in chunks of INIT_CHUNK) across
        # its first chunk boundary, against the CPU's draw of those elements
        ks = common.split_keys(rng.PRNGKey(0, device="cpu"), cfg.n_layers + 3)
        s0, n = common.INIT_CHUNK - 4096, 8192
        scale = float(np.float32(1.0) / np.sqrt(np.float32(cfg.d_model)))
        want = (rng.normal(ks[-3], (n,), start=s0) * scale).to(torch.bfloat16).float()
        got = params["embed"].reshape(-1)[s0:s0 + n].float().cpu()
        out["init_err"] = rel_err(got.numpy(), want.numpy())
        out["init_equal"] = int((got == want).sum())
        if out["init_err"] > 2.0**-7:  # one bfloat16 step: erfinv on the card is not the CPU's
            raise AssertionError(f"serve: embedding draw at {s0} differs from the CPU's "
                                 f"(rel {out['init_err']})")
        torch.cuda.reset_peak_memory_stats()
        gen, out["prefill_warm_s"], out["decode_warm_s"] = serve.generate(
            model, params, run["prompts"], G)
        if not torch.equal(gen, run["tokens"]):
            raise AssertionError("serve: a second greedy run gave other tokens")
        # where a serve step's time goes: 3 prefills at 4 x 32, 8 decode steps
        prefill_step, decode_step = make_serve_steps(model)
        profile_ticks(f"{cfg.name} prefill {B}x{P}", lambda i: prefill_step(
            params, {"tokens": run["prompts"]}, P + G), 3, unit="prefill")
        _, cache, n = prefill_step(params, {"tokens": run["prompts"]}, P + 9)
        carry = [cache, n]

        def decode_one(i):
            _, carry[0], carry[1] = decode_step(params, carry[0], run["tokens"][:, i:i + 1],
                                                carry[1])

        profile_ticks(f"{cfg.name} decode, batch {B}", decode_one, 8, unit="step")
        del cache, carry
        prefill_bf16 = make_serve_steps(model)[0]
        params32 = common.cast_tree(params, torch.float32)  # the reference test's dtype
        # decode against the full forward: the bf16 serve steps and float32
        # params over the bf16 cache (logged: at 34 layers the cache's
        # rounding alone moves the logits past 0.03, in the reference too),
        # and float32 params over a float32 cache (held: the decode path
        # computes what the forward computes)
        modes = (("bf16", params, torch.bfloat16), ("fp32", params32, torch.bfloat16),
                 ("fp32 cache", params32, torch.float32))
        long = rng.randint(rng.PRNGKey(3, device=dev), (1, SERVE_LONG), 0, cfg.vocab)
        for label, toks in ((f"{B}x{P}", run["prompts"]), (f"1x{SERVE_LONG}", long)):
            S = toks.shape[1]
            out["ms " + label] = eager_ms(
                lambda: prefill_bf16(params, {"tokens": toks}, S + 1), reps=3, inner=1)
            for mode, p, cache_dtype in modes:
                full, _ = transformer.forward(p, cfg, {"tokens": toks})
                pl, cache, n = transformer.prefill(p, cfg, {"tokens": toks[:, :S - 1]}, S + 1,
                                                   cache_dtype=cache_dtype)
                ld, _ = transformer.decode_step(p, cfg, cache, toks[:, S - 1:S], n)
                if not bool(torch.isfinite(full).all() and torch.isfinite(pl).all()
                            and torch.isfinite(ld).all()):
                    raise AssertionError(f"serve {label} {mode}: logits not finite")
                ref, got = full[:, S - 1].float(), ld[:, 0].float()
                out[f"rel {mode} {label}"] = float((ref - got).abs().max()
                                                   / (ref.abs().max() + 1e-9))
                del full, pl, cache, ld
            if not out[f"rel fp32 cache {label}"] < 0.03:
                raise AssertionError(f"serve {label}: decode (float32 cache) vs full forward "
                                     f"rel {out[f'rel fp32 cache {label}']} (>= 0.03)")
        del params32
        torch.cuda.synchronize()
        out["peak"] = torch.cuda.max_memory_allocated()
        return out

    out, secs, counts = counted(checks)
    exact_launches("serve checks", counts, {})
    long = f"1x{SERVE_LONG}"
    log(f"serve {cfg.name} full on {smi}: init {run['init_s']:.3f} s; prefill {B}x{P} "
        f"{out[f'ms {B}x{P}']:.3f} ms, {long} {out['ms ' + long]:.3f} ms (warm; CUDA events, "
        f"median of 3); decode {(G - 1) * B / out['decode_warm_s']:.1f} tok/s at batch {B} "
        f"({G - 1} steps in {out['decode_warm_s'] * 1e3:.1f} ms, warm; tokens == the CLI's); "
        f"peak memory {run['peak'] / 2**30:.3f} GiB in the CLI, {out['peak'] / 2**30:.3f} GiB "
        f"in the checks (float32 params and the {long} forward's full logits); decode vs "
        f"full forward rel at {B}x{P} / {long}: float32 params over a float32 cache "
        f"{out[f'rel fp32 cache {B}x{P}']:.3e} / {out['rel fp32 cache ' + long]:.3e} (< 0.03); "
        f"over the bf16 cache (logged): float32 params {out[f'rel fp32 {B}x{P}']:.4f} / "
        f"{out['rel fp32 ' + long]:.4f}, bf16 serve steps {out[f'rel bf16 {B}x{P}']:.4f} / "
        f"{out['rel bf16 ' + long]:.4f}; logits finite; embedding draw across its first "
        f"chunk boundary vs the CPU: "
        f"rel {out['init_err']:.2e}, {out['init_equal']} of 8192 equal; {secs:.1f} s")
    del run, params, model

    cpu = cpu_run.get(timeout=600)
    card, secs, counts = counted(lambda: serve_reduced_runs(dev, carry=cpu))
    exact_launches("serve reduced", counts, {})
    serve_reduced_check(card, cpu)
    log(f"serve phase: {time.perf_counter() - t_start:.1f} s (reduced archs on the card "
        f"{secs:.1f} s)")
    return totals


# phase 19, the other families: rwkv6-1.6b and zamba2-7b at full size
# through the serve CLI's defaults, then a 1 x 512 prefill (32 RWKV chunks
# of 16, 16 SSD chunks of 32); phi3.5-moe at full width and 8 of its 32
# layers (all 32 are 78 GiB in bf16: they do not fit one card beside their
# activations); then the reduced MoE, RWKV6 and Zamba2 archs card vs CPU,
# one Zamba case with a shared-attention window (48) under its prompt (64)
# so that the ring wraps
FAMILY_LONG = 512
FAMILY_MOE_LAYERS = 8
FAMILY_RWKV_CHECK = 64  # RWKV decode token by token against its forward
# the depths of that check: tests/test_models.py's is reduced()'s 4 (held
# there); deeper, the random-init model amplifies float32 rounding ~2-3x
# per layer at full width, in the reference too (logged)
FAMILY_RWKV_DEPTHS = (2, 4, 6, 12, 24)
FAMILY_P = 64  # whole chunks of RWKV's 16 and the SSD's 32
FAMILY_CASES = (("phi3.5-moe-42b-a6.6b", None), ("qwen3-moe-235b-a22b", None),
                ("rwkv6-1.6b", None), ("zamba2-7b", None), ("zamba2-7b", 48))


def families_phase(dev, cpu_run, smi: str) -> dict:
    """The MoE, RWKV6 and Zamba2 serving paths (``repro_torch.launch.serve``
    over ``make_serve_steps``, ``models/{mlp,ssm,recurrent}``).  rwkv6-1.6b
    and zamba2-7b at full size through the serve CLI's defaults (init from
    PRNGKey(0) in bfloat16, 4 x 32 prompts, 16 greedy steps), then warm:
    the same greedy run (decode tokens/s), prefill at 4 x 32 and 1 x 512
    (CUDA events), a profiled decode window; RWKV decode token by token
    from the zero state against its forward over 64 tokens with float32
    params over the first 2, 4, 6, 12 and 24 layers (rel < 0.01,
    tests/test_models.py's bound, held at its depth, 4; logged deeper,
    where the random-init model amplifies rounding); Zamba's logits
    finite and its decode against a prefill one token longer over the bf16
    ring (logged).  phi3.5-moe at full width and 8 layers
    (``dataclasses.replace(cfg, n_layers=8)``) through ``serve.generate``;
    the assignments its 4 x 32 prefill dropped at capacity; then, the
    bfloat16 params freed, decode against the full forward with float32
    params over a float32 cache at tests/test_models.py's 2 x 16 (rel <
    0.03, its bound; cap = T there, so no assignment is dropped).
    Then the reduced archs card vs CPU (``serve_reduced_check``, the CPU
    side from a helper process).  No port kernel is launched.  Returns the
    launches per kernel (none) and phi3.5-moe's bf16 serve run, fed its
    greedy tokens (``tests/serve_parity.run_serve``: the tokens, each
    step's logits, every MoE call's routing, the prefill's drops per
    layer), for the ranks phase."""
    import dataclasses

    import torch

    from repro_torch import rng
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import build_model, common, recurrent, transformer
    from repro_torch.models.mlp import capacity as mlp_capacity
    from repro_torch.train import make_serve_steps
    from repro_torch.tree import tree_flatten_with_path
    from serve_parity import port_routing, run_serve

    totals = {k: 0 for k in ops.KERNEL_MODULES}
    counted = _counting(totals)
    t_start = time.perf_counter()
    torch.cuda.empty_cache()
    peaks = []
    moe_ref = {}
    gib = lambda b: b / 2**30

    def measured(fn):
        """``fn()`` counted, with its peak device memory kept."""
        def run():
            torch.cuda.reset_peak_memory_stats()
            out = fn()
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated())
            return out

        out, secs, counts = counted(run)
        exact_launches("serve families", counts, {})
        return out, secs, peaks[-1]

    def rel(ref, got):
        ref, got = ref.float(), got.float()
        return float((ref - got).abs().max() / (ref.abs().max() + 1e-9))

    def finite(*ts):
        if not all(bool(torch.isfinite(t).all()) for t in ts):
            raise AssertionError("serve families: logits not finite")

    def warm(model, cfg, params, prompts, tokens):
        """The serve numbers warm: the greedy run again, prefill at 4 x 32
        and 1 x FAMILY_LONG, a profiled decode window."""
        out = {}
        B, P, G = prompts.shape[0], prompts.shape[1], tokens.shape[1]
        gen, _, out["decode_s"] = serve.generate(model, params, prompts, G)
        if not torch.equal(gen, tokens):
            raise AssertionError(f"serve {cfg.name}: a second greedy run gave other tokens")
        prefill_step, decode_step = make_serve_steps(model)
        long = rng.randint(rng.PRNGKey(3, device=dev), (1, FAMILY_LONG), 0, cfg.vocab)
        for label, toks in ((f"{B}x{P}", prompts), (f"1x{FAMILY_LONG}", long)):
            S = toks.shape[1]
            out["ms " + label] = eager_ms(
                lambda: prefill_step(params, {"tokens": toks}, S + 1), reps=3, inner=1)
        out["long_logits"], _, _ = prefill_step(params, {"tokens": long}, FAMILY_LONG + 1)
        finite(out["long_logits"])
        _, state, n = prefill_step(params, {"tokens": prompts}, P + 4)
        carry = [state, n]

        def decode_one(i):
            _, carry[0], carry[1] = decode_step(params, carry[0], tokens[:, i:i + 1], carry[1])

        profile_ticks(f"{cfg.name} decode, batch {B}", decode_one, 3, unit="step")
        out["long"] = long
        return out

    def report(run, w, cfg, extra: str, secs: float):
        B, P, G = run["tokens"].shape[0], run["prompts"].shape[1], run["tokens"].shape[1]
        log(f"serve {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
            f"{cfg.vocab}, {run['n_params']} parameters in bf16) on {smi}: init "
            f"{run['init_s']:.3f} s; first prefill {B}x{P} {run['prefill_s'] * 1e3:.1f} ms, "
            f"{G - 1} decode steps {run['decode_s'] * 1e3:.1f} ms "
            f"({(G - 1) * B / run['decode_s']:.1f} tok/s); warm: prefill {B}x{P} "
            f"{w[f'ms {B}x{P}']:.3f} ms, 1x{FAMILY_LONG} {w[f'ms 1x{FAMILY_LONG}']:.3f} ms "
            f"(CUDA events, median of 3), decode {(G - 1) * B / w['decode_s']:.1f} tok/s at "
            f"batch {B} (tokens == the first run's); peak memory {gib(run['peak']):.3f} GiB in "
            f"the serve run; {extra}; sample {run['tokens'][0][:12].tolist()}; {secs:.1f} s")

    def cli(arch):
        run = serve.main(["--arch", arch])  # the CLI's defaults: 4 x 32, 16 steps, on the card
        torch.cuda.synchronize()
        run["peak"] = torch.cuda.max_memory_allocated()
        run["n_params"] = sum(t.numel() for t in tree_flatten_with_path(run["params"]).values())
        return run

    # RWKV6 at full size
    run, secs, _ = measured(lambda: cli("rwkv6-1.6b"))
    cfg, model, params = run["cfg"], run["model"], run["params"]

    def rwkv_checks():
        w = warm(model, cfg, params, run["prompts"], run["tokens"])
        p32 = common.cast_tree(params, torch.float32)  # the reference test's dtype
        toks = w["long"][:, :FAMILY_RWKV_CHECK]
        w["rel"] = {}
        for depth in FAMILY_RWKV_DEPTHS:  # the first `depth` layers of the model
            cfg_d = dataclasses.replace(cfg, n_layers=depth)
            full, _, _ = recurrent.rwkv_forward(p32, cfg_d, {"tokens": toks})
            state = recurrent.rwkv_state_init(cfg_d, 1, device=dev)
            outs = []
            for t in range(FAMILY_RWKV_CHECK):
                lg, _, state = recurrent.rwkv_forward(p32, cfg_d, {"tokens": toks[:, t:t + 1]},
                                                      state=state)
                outs.append(lg[:, 0])
            got = torch.stack(outs, dim=1)
            finite(full, got)
            w["rel"][depth] = rel(full, got)
        if not w["rel"][4] < 0.01:
            raise AssertionError(f"serve rwkv6: decode vs chunked forward rel {w['rel']} "
                                 "(>= 0.01 over the first 4 layers)")
        del p32, full, got, state
        return w

    w, secs2, peak = measured(rwkv_checks)
    report(run, w, cfg, f"decode token by token from the zero state vs the chunked "
           f"forward over {FAMILY_RWKV_CHECK} tokens, float32 params, over the first 4 layers "
           f"(tests/test_models.py's depth): rel {w['rel'][4]:.3e} (< 0.01); by depth "
           + ", ".join(f"{d}: {r:.3e}" for d, r in w["rel"].items())
           + f" (logged: the random-init model multiplies float32 rounding by ~2-3 per "
           f"layer, the reference too); 1x{FAMILY_LONG} logits finite; checks' peak "
           f"{gib(peak):.3f} GiB", secs + secs2)
    del run, cfg, model, params, w
    torch.cuda.empty_cache()

    # Zamba2 at full size
    run, secs, _ = measured(lambda: cli("zamba2-7b"))
    cfg, model, params = run["cfg"], run["model"], run["params"]

    def zamba_checks():
        w = warm(model, cfg, params, run["prompts"], run["tokens"])
        prefill_step, decode_step = make_serve_steps(model)
        prompts = run["prompts"]
        P = prompts.shape[1]
        whole, _, _ = prefill_step(params, {"tokens": prompts}, P + 1)
        _, state, n = prefill_step(params, {"tokens": prompts[:, :P - 1]}, P + 1)
        dec, state, _ = decode_step(params, state, prompts[:, P - 1:P], n)
        finite(whole, dec)
        w["rel"] = rel(whole[:, -1], dec[:, 0])
        w["window"] = state["k"].shape[2]
        return w

    w, secs2, peak = measured(zamba_checks)
    report(run, w, cfg, f"logits finite; decode of token {run['prompts'].shape[1]} "
           f"vs a prefill one token longer over the bf16 ring (window {w['window']}), bf16 "
           f"serve steps: rel {w['rel']:.3e} (logged); checks' peak {gib(peak):.3f} GiB",
           secs + secs2)
    del run, cfg, model, params, w
    torch.cuda.empty_cache()

    # phi3.5-moe at full width, 8 of 32 layers
    def moe_run():
        cfg = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b"), n_layers=FAMILY_MOE_LAYERS)
        model = build_model(cfg)
        t0 = time.perf_counter()
        params = model.init_params(rng.PRNGKey(0, device=dev), torch.bfloat16)
        torch.cuda.synchronize()
        run = {"cfg": cfg, "model": model, "params": params,
               "init_s": time.perf_counter() - t0,
               "n_params": sum(t.numel() for t in tree_flatten_with_path(params).values()),
               "prompts": rng.randint(rng.PRNGKey(1, device=dev), (4, 32), 0, cfg.vocab)}
        run["tokens"], run["prefill_s"], run["decode_s"] = serve.generate(
            model, params, run["prompts"], 16)
        run["peak"] = torch.cuda.max_memory_allocated()
        return run

    run, secs, _ = measured(moe_run)
    cfg, model = run["cfg"], run["model"]
    prompts = run["prompts"]
    B, P = prompts.shape

    def moe_checks():
        w = warm(model, cfg, run["params"], prompts, run["tokens"])
        # the prefill and RANKS_MOE_DECODE decode steps fed the greedy
        # tokens, routing recorded: the ranks phase's one-card reference
        toks = torch.cat([prompts, run["tokens"][:, :RANKS_MOE_DECODE]], dim=1)
        calls = []
        with port_routing(calls):
            logits, _ = run_serve(*make_serve_steps(model), run["params"], toks, lambda t: t,
                                  P, toks.shape[1] + 1)
        w["dropped"] = [int((~keep).sum()) for _, _, keep in calls[:cfg.n_layers]]
        moe_ref.update(toks=toks.cpu(), logits=logits, routing=calls, dropped=w["dropped"])
        return w

    w, secs2, peak = measured(moe_checks)
    p32 = common.cast_tree(run.pop("params"), torch.float32)  # the reference test's dtype
    peaks.append(torch.cuda.max_memory_allocated())  # bf16 and float32 params at once
    torch.cuda.empty_cache()  # the bf16 params are freed

    def moe_fp32():
        # tests/test_models.py's shape: 2 x 16 tokens, so cap (32) = T and
        # no assignment can be dropped in the forward or the prefill
        toks = rng.randint(rng.PRNGKey(0, device=dev), (2, 16), 0, cfg.vocab)
        full, _ = transformer.forward(p32, cfg, {"tokens": toks})
        pl, cache, n = transformer.prefill(p32, cfg, {"tokens": toks[:, :15]}, 20,
                                           cache_dtype=torch.float32)
        ld, _ = transformer.decode_step(p32, cfg, cache, toks[:, 15:16], n)
        finite(full, pl, ld)
        return rel(full[:, 15], ld[:, 0])

    w["rel"], secs3, peak32 = measured(moe_fp32)
    if not w["rel"] < 0.03:
        raise AssertionError(f"serve phi3.5-moe: decode (float32) vs full forward rel "
                             f"{w['rel']} (>= 0.03)")
    report(run, w, cfg, f"of {cfg.top_k * B * P} assignments per layer the {B}x{P} prefill dropped "
           f"{sum(w['dropped'])} at capacity in {cfg.n_layers} layers (per layer "
           f"{w['dropped']}; cap {mlp_capacity(B * P, cfg)}); decode vs full "
           f"forward at 2x16 (no drop possible), float32 params over a float32 cache: rel "
           f"{w['rel']:.3e} (< 0.03); checks' peak {gib(max(peak, peak32)):.3f} GiB",
           secs + secs2 + secs3)
    del run, cfg, model, p32, w
    torch.cuda.empty_cache()

    cpu = cpu_run.get(timeout=600)
    card, secs, _ = measured(lambda: serve_reduced_runs(dev, carry=cpu, cases=FAMILY_CASES,
                                                        P=FAMILY_P))
    serve_reduced_check(card, cpu, found_ok=True)
    log(f"serve families phase: {time.perf_counter() - t_start:.1f} s (reduced archs on the "
        f"card {secs:.1f} s); peak device memory {gib(max(peaks)):.3f} GiB; no kernel launched")
    return totals, moe_ref


# phase 20, training: rwkv6-1.6b uncut through the train CLI (24 layers,
# d_model 2048: its params, m, v, fp32 gradients and bf16 copy are ~29 GiB;
# mistral-nemo-12b, qwen1.5-4b and gemma3-4b would need ~70-245 GB at ~18-20
# bytes per parameter), mistral-nemo-12b (the CLI's default) at full width
# and 4 of its 40 layers, the ten reduced archs card vs CPU, and resume on
# the card
TRAIN_STEPS = 12  # (a): the median step is over steps 3-12
TRAIN_NEMO_LAYERS = 4
TRAIN_NEMO_STEPS = 3  # per remat mode (b): one warm step, then the median of two
TRAIN_B, TRAIN_S = 4, 64  # (c): whole chunks of RWKV's 16 and the SSD's 32
TRAIN_TOL = 1e-4
TRAIN_SMALL_GRAD = 1e-3  # tests/train_parity.py's SMALL_GRAD
TRAIN_MB_TOL = 5e-3  # tests/test_train_substrate.py's microbatch bound
TRAIN_ARCHS = ("gemma3-4b", "gemma-7b", "llava-next-mistral-7b", "mistral-nemo-12b",
               "musicgen-large", "phi3.5-moe-42b-a6.6b", "qwen1.5-4b", "qwen3-moe-235b-a22b",
               "rwkv6-1.6b", "zamba2-7b")


def train_batch(cfg, dev, seed: int = 5, b: int = TRAIN_B, s: int = TRAIN_S) -> dict:
    """tests/train_parity.py's ``make_batch`` on ``dev``: labels, and tokens
    or (the stub frontends) float32 embeddings, drawn with numpy."""
    import numpy as np
    import torch

    rs = np.random.RandomState(seed)
    batch = {"labels": rs.randint(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.frontend != "none":
        batch["embeds"] = rs.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = rs.randint(0, cfg.vocab, (b, s)).astype(np.int32)
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def train_reduced_runs(dev, ulp: bool = False) -> dict:
    """Per arch of ``TRAIN_ARCHS`` at ``reduced()``: one float32 train step
    on ``dev`` from ``init_train_state(PRNGKey(0))`` drawn on the CPU (the
    same weights on either side), its loss, metrics, gradients (and with
    ``ulp`` the gradients at parameters moved by one ulp, the model's own
    conditioning), the state after the step and each MoE call's routing,
    as numpy."""
    import numpy as np
    import torch

    from repro_torch import rng
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.train import AdamWConfig, TrainConfig, init_train_state, make_train_step
    from repro_torch.train.steps import make_grad_fn
    from repro_torch.tree import tree_flatten_with_path, tree_map_with_path
    from serve_parity import port_routing

    if torch.device(dev).type == "cpu":
        torch.set_num_threads(2)
    np_ = lambda t: t.detach().float().cpu().numpy()
    flat_np = lambda tree: {k: np_(v) for k, v in tree_flatten_with_path(tree).items()}
    tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=2), compute_dtype=torch.float32)
    out = {}
    for arch in TRAIN_ARCHS:
        cfg = reduced(get_config(arch))
        model = build_model(cfg)
        params, opt = init_train_state(model, rng.PRNGKey(0, device="cpu"))
        params, opt = (tree_map_with_path(lambda _, t: t.to(dev), x) for x in (params, opt))
        batch = train_batch(cfg, dev)
        r = {"routing": []}
        with port_routing(r["routing"]):
            loss, metrics, grads = make_grad_fn(model, tcfg)(params, batch)
        r["loss"], r["metrics"] = float(loss), {k: float(v) for k, v in metrics.items()}
        r["grads"] = {k: np_(v) for k, v in grads.items()}
        if ulp:
            coin = np.random.RandomState(9)
            moved = tree_map_with_path(lambda _, t: torch.nextafter(t, torch.from_numpy(
                np.where(coin.rand(*t.shape) < 0.5, np.inf, -np.inf).astype(np.float32)).to(
                dev)), params)
            r["grads_ulp"] = {k: np_(v) for k, v in make_grad_fn(model, tcfg)(moved, batch)[2]
                              .items()}
        params, opt, m = make_train_step(model, tcfg)(params, opt, batch)
        r["step_metrics"] = {k: float(v) for k, v in m.items()}
        r["state"] = {"params": flat_np(params), "m": flat_np(opt["m"]), "v": flat_np(opt["v"])}
        out[arch] = r
    return out


def train_reduced_check(card: dict, cpu: dict, smi: str) -> None:
    """Card against CPU for every reduced arch under the float32 parity rule
    of tests/test_torch_train_step.py: loss, metrics 1e-4, lr equal; each
    gradient leaf within 1e-4 or twice the CPU's own one-ulp distance (the
    model's conditioning), ``m`` the same, ``v`` twice; the parameters
    within 1e-4 where the CPU's gradient is at least 1e-3 of its leaf's
    largest (the first step is ill-conditioned below); routing ids and kept
    assignments equal; everything finite."""
    import numpy as np

    for arch, w in cpu.items():
        c = card[arch]
        worst, tol = {}, {}

        def hold(name, err, bound):
            worst[name], tol[name] = max(worst.get(name, 0.0), err), bound

        hold("loss", abs(c["loss"] - w["loss"]) / abs(w["loss"]), TRAIN_TOL)
        for k, v in w["step_metrics"].items():
            if k == "lr":
                if c["step_metrics"][k] != v:
                    raise AssertionError(f"train {arch}: lr {c['step_metrics'][k]} != {v}")
                continue
            hold(k, abs(c["step_metrics"][k] - v) / max(abs(v), 1e-30), TRAIN_TOL)
        bound = {k: max(TRAIN_TOL, 2 * rel_err(w["grads_ulp"][k], g) if np.abs(g).max() else 0)
                 for k, g in w["grads"].items()}
        for k, g in w["grads"].items():
            err = rel_err(c["grads"][k], g) if np.abs(g).max() else float(np.abs(c["grads"][k]).max())
            hold("grads", err / bound[k], 1.0)
        for name, scale in (("m", 1), ("v", 2)):
            for k, a in w["state"][name].items():
                err = rel_err(c["state"][name][k], a) if np.abs(a).max() else float(
                    np.abs(c["state"][name][k]).max())
                hold(name, err / (scale * bound[k]), 1.0)
        skipped = 0
        for k, a in w["state"]["params"].items():
            g = np.abs(w["grads"][k])
            held = g >= TRAIN_SMALL_GRAD * g.max()
            err = np.abs(c["state"]["params"][k].astype(np.float64) - a) / np.abs(a).max()
            hold("params", float(err[held].max(initial=0.0)), TRAIN_TOL)
            skipped += int((~held).sum())
        if len(c["routing"]) != len(w["routing"]) or not all(
                np.array_equal(gi, wi) and np.array_equal(gk, wk)
                for (_, gi, gk), (_, wi, wk) in zip(c["routing"], w["routing"])):
            raise AssertionError(f"train {arch}: float32 routing differs card vs CPU")
        finite = all(np.isfinite(x).all() for x in c["grads"].values()) and all(
            np.isfinite(x).all() for x in c["state"]["params"].values())
        if not finite or any(worst[k] > tol[k] for k in tol):
            raise AssertionError(f"train {arch} (reduced): card vs CPU {worst} (tolerances "
                                 f"{tol}), finite={finite}")
        wide = {k: round(b, 7) for k, b in bound.items() if b > TRAIN_TOL}
        log(f"train {arch} (reduced) on {smi}: card vs CPU, one float32 step: "
            + ", ".join(f"{k} {v:.2e}" for k, v in worst.items() if k not in ("grads", "m", "v"))
            + f"; gradients, m, v at {max(worst['grads'], worst['m']):.2f}, {worst['v']:.2f} of "
            f"their bounds (1e-4, or twice the CPU's one-ulp distance: {wide or 'none wider'}); "
            f"{skipped} parameter elements with a gradient below 1e-3 of the leaf's largest "
            f"not held; routing equal ({len(w['routing'])} MoE calls)")


def device_window(fn) -> tuple:
    """``fn()`` under ``torch.profiler`` (the device trace alone): ``(device
    events, their busy microseconds, wall microseconds)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(dev_events), sum(e.time_range.elapsed_us() for e in dev_events), wall_us


def train_profile(label: str, model, tcfg, params, opt, batch, smi: str) -> dict:
    """Where a train step's device work goes, in three profiled windows:
    the forward alone (the loss with the graph recorded), the gradient
    (``make_train_step``'s ``make_grad_fn``: forward and backward, the remat
    recomputation included) and the update (``apply_updates``).  Launches
    (device events) by part — the backward's is the gradient's less the
    forward's — and the busy share of the gradient and the update."""
    import torch

    from repro_torch.models.common import cast_tree
    from repro_torch.train import apply_updates
    from repro_torch.train.steps import make_grad_fn
    from repro_torch.tree import tree_map_with_path, tree_unflatten_like

    def forward():
        with torch.enable_grad():
            p = tree_map_with_path(lambda _, t: t.detach().requires_grad_(True), params)
            model.loss_fn(cast_tree(p, tcfg.compute_dtype), batch, remat=tcfg.remat,
                          remat_policy=tcfg.remat_policy)

    out = {}
    fwd, _, _ = device_window(forward)
    grad, grad_busy, grad_wall = device_window(
        lambda: out.setdefault("grads", make_grad_fn(model, tcfg)(params, batch)[2]))
    upd, upd_busy, upd_wall = device_window(lambda: apply_updates(
        tcfg.opt, params, tree_unflatten_like(params, out.pop("grads")), opt))
    if not fwd:
        log(f"profile (train {label}): the profiler recorded no device time; not measured")
        return {"launches": "not measured"}
    r = {"launches": {"forward": fwd, "backward": grad - fwd, "optimizer": upd},
         "busy": (grad_busy + upd_busy) / (grad_wall + upd_wall)}
    log(f"profile (train {label}, one step, profiler on) on {smi}: gradient "
        f"{grad_wall / 1e3:.1f} ms wall, {grad_busy / 1e3:.1f} ms device busy; update "
        f"{upd_wall / 1e3:.1f} ms wall, {upd_busy / 1e3:.1f} ms busy; step "
        f"{100 * r['busy']:.2f} % busy; device launches: forward {fwd}, backward {grad - fwd} "
        f"(remat recomputation included), optimizer {upd}")
    return r


def train_phase(dev, cpu_run, smi: str) -> dict:
    """The training path (``repro_torch.launch.train`` over
    ``make_train_step``, ``loss_fn`` with remat, autograd, ``apply_updates``).
    (a) rwkv6-1.6b uncut through the train CLI (12 steps of 8 x 128): init
    seconds, step ms (median of steps 3-12), tokens/s, peak memory, every
    step's loss and grad norm (finite: a gate; the drop logged), params
    moved from their initial values (a gate), one step profiled (launches
    by part, busy share).  (b) mistral-nemo-12b at full width and 4 of 40
    layers (8 x 128): its parameter count, remat on / off / ``"dots"`` (peak
    memory, step ms, losses finite), one step profiled, and in float32 4
    microbatches against 1 on one batch from the same state (max|Δ params|
    < 5e-3, the reference test's property).  (c) the ten reduced archs, one
    float32 step each, card vs CPU (``train_reduced_check``; the CPU side
    from a helper process).  (d) resume on the card: ``--reduced``
    mistral-nemo-12b, 10 steps checkpointed every 5 against 5 steps and a
    ``--resume`` to 10, under ``torch.use_deterministic_algorithms``: params
    and optimizer state bit-equal.  No port kernel is launched.  Returns
    the launches per kernel (none) and (a)'s median step seconds and peak
    bytes (phase 21 reads them)."""
    import dataclasses
    import os
    import shutil
    import tempfile

    import torch

    from repro_torch import rng
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.train import (AdamWConfig, TrainConfig, init_opt_state, init_train_state,
                                   make_train_step)
    from repro_torch.train.steps import make_grad_fn
    from repro_torch.tree import tree_flatten_with_path, tree_map_with_path

    totals = {k: 0 for k in ops.KERNEL_MODULES}
    counted = _counting(totals)
    t_start = time.perf_counter()
    gib = lambda b: b / 2**30
    leaf_sums = lambda tree: {k: float(v.double().sum()) for k, v in
                              tree_flatten_with_path(tree).items()}
    torch.cuda.empty_cache()

    def measured(fn):
        def run():
            torch.cuda.reset_peak_memory_stats()
            out = fn()
            torch.cuda.synchronize()
            return out, torch.cuda.max_memory_allocated()

        (out, peak), secs, counts = counted(run)
        exact_launches("train", counts, {})
        return out, secs, peak

    def finite_losses(what, losses, norms):
        if not all(map(math.isfinite, losses + norms)):
            raise AssertionError(f"train {what}: a loss or grad norm is not finite: {losses} "
                                 f"{norms}")

    # (a) rwkv6-1.6b uncut through the CLI
    arch = "rwkv6-1.6b"
    cfg = get_config(arch)
    init, _, _ = measured(lambda: leaf_sums(build_model(cfg).init_params(
        rng.PRNGKey(0, device=dev))))
    run, secs, peak = measured(lambda: train.main(
        ["--arch", arch, "--steps", str(TRAIN_STEPS), "--batch", "8", "--seq", "128"]))
    rwkv_peak = peak
    finite_losses(arch, run["losses"], run["grad_norms"])
    after = leaf_sums(run["params"])
    moved = [k for k in init if after[k] != init[k]]
    if len(moved) != len(init):
        raise AssertionError(f"train {arch}: leaves that did not move: "
                             f"{sorted(set(init) - set(moved))}")
    n_params = sum(t.numel() for t in tree_flatten_with_path(run["params"]).values())
    step_s = rwkv_step_s = statistics.median(run["step_s"][2:])
    log(f"train {arch} (uncut: {cfg.n_layers} layers, d_model {cfg.d_model}, {n_params} "
        f"parameters, fp32 master weights, bf16 compute, remat on) on {smi}: init "
        f"{run['init_s']:.3f} s; {TRAIN_STEPS} steps of 8x128 in {secs:.1f} s; step "
        f"{step_s * 1e3:.1f} ms (median of steps 3-{TRAIN_STEPS}; first "
        f"{run['step_s'][0] * 1e3:.1f} ms), {8 * 128 / step_s:.0f} tokens/s; peak memory "
        f"{gib(peak):.3f} GiB; all {len(init)} leaves moved; loss "
        + ", ".join(f"{x:.4f}" for x in run["losses"]) + " (drop "
        f"{run['losses'][0] - run['losses'][-1]:.4f}, logged); grad norm "
        + ", ".join(f"{x:.3f}" for x in run["grad_norms"]))
    model = run["model"]
    data = SyntheticLM(cfg.vocab, 128, 8, seed=17)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.shard_batch(TRAIN_STEPS).items()}
    prof_a, _, _ = measured(lambda: train_profile(arch, model, TrainConfig(), run["params"],
                                                  run["opt"], batch, smi))
    del run, model, init, after
    torch.cuda.empty_cache()

    # (b) mistral-nemo-12b at full width, 4 of 40 layers
    cfg = dataclasses.replace(get_config("mistral-nemo-12b"), n_layers=TRAIN_NEMO_LAYERS)
    model = build_model(cfg)
    (params, opt), init_s, _ = measured(lambda: init_train_state(model, rng.PRNGKey(
        0, device=dev)))
    n_params = sum(t.numel() for t in tree_flatten_with_path(params).values())
    data = SyntheticLM(cfg.vocab, 128, 8, seed=17)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in data.shard_batch(i).items()}
               for i in range(TRAIN_NEMO_STEPS)]
    modes = {}
    for mode, remat, policy in (("remat on", True, None), ("remat off", False, None),
                                ("remat dots", True, "dots")):
        tcfg = TrainConfig(remat=remat, remat_policy=policy)
        step = make_train_step(model, tcfg)

        def steps():
            out = []
            for b in batches:
                t0 = time.perf_counter()
                _, _, m = step(params, opt, b)
                torch.cuda.synchronize()
                out.append((time.perf_counter() - t0, float(m["loss"]), float(m["grad_norm"])))
            # the gradient pass alone: its peak above the state it starts from
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            grads = make_grad_fn(model, tcfg)(params, batches[0])[2]
            torch.cuda.synchronize()
            above = torch.cuda.max_memory_allocated() - base
            del grads
            return out, above

        (res, above), _, peak = measured(steps)
        finite_losses(f"nemo {mode}", [r[1] for r in res], [r[2] for r in res])
        modes[mode] = (statistics.median(r[0] for r in res[1:]), peak, res, above)
    log(f"train mistral-nemo-12b (full width: d_model {cfg.d_model}, GQA {cfg.n_heads}/"
        f"{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; {cfg.n_layers} of 40 layers; "
        f"{n_params} parameters) on {smi}: init {init_s:.3f} s; 8x128, bf16 compute, "
        + "; ".join(f"{mode}: step {s * 1e3:.1f} ms ({8 * 128 / s:.0f} tokens/s), peak "
                    f"{gib(p):.3f} GiB, the gradient pass {gib(a):.3f} GiB above the state, "
                    "losses " + ", ".join(f"{r[1]:.4f}" for r in res)
                    for mode, (s, p, res, a) in modes.items())
        + f" (each mode {TRAIN_NEMO_STEPS} steps on from the last; the median of the last "
        f"{TRAIN_NEMO_STEPS - 1})")
    prof_b, _, _ = measured(lambda: train_profile("mistral-nemo-12b, 4 layers", model,
                                                  TrainConfig(), params, opt, batches[0], smi))

    def microbatches():
        got = {}
        for n in (1, 4):  # from the same state: a copy, then the params themselves
            p = params if n == 4 else tree_map_with_path(lambda _, t: t.clone(), params)
            tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=1),
                               compute_dtype=torch.float32, microbatches=n)
            got[n] = make_train_step(model, tcfg)(p, init_opt_state(p), batches[0])[0]
            if n == 1:
                got[1] = tree_flatten_with_path(got[1])
        p4 = tree_flatten_with_path(got[4])
        return max(float((got[1][k] - p4[k]).abs().max()) for k in p4)

    del opt
    mb, secs, peak = measured(microbatches)
    if not mb < TRAIN_MB_TOL:
        raise AssertionError(f"train nemo: 4 microbatches vs 1, max|d params| {mb} "
                             f"(>= {TRAIN_MB_TOL})")
    log(f"train mistral-nemo-12b ({cfg.n_layers} layers) on {smi}: float32 compute, 4 "
        f"microbatches of 2x128 vs one batch of 8x128 from the same state: max|d params| "
        f"{mb:.3e} (< {TRAIN_MB_TOL}); {secs:.1f} s, peak {gib(peak):.3f} GiB")
    del params, batches, model
    torch.cuda.empty_cache()

    # (c) the ten reduced archs, card vs CPU
    cpu = cpu_run.get(timeout=600)
    card, secs, _ = measured(lambda: train_reduced_runs(dev))
    train_reduced_check(card, cpu, smi)

    # (d) resume on the card
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")

    def resume():
        args = ["--arch", "mistral-nemo-12b", "--reduced", "--batch", "4", "--seq", "64",
                "--ckpt-every", "5"]
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            whole = train.main(args + ["--steps", "10", "--ckpt-dir", os.path.join(tmp, "a")])
            train.main(args + ["--steps", "5", "--ckpt-dir", os.path.join(tmp, "b")])
            resumed = train.main(args + ["--steps", "10", "--ckpt-dir", os.path.join(tmp, "b"),
                                         "--resume"])
        finally:
            torch.use_deterministic_algorithms(False)
        return whole, resumed

    try:
        (whole, resumed), secs_d, _ = measured(resume)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if resumed["start"] != 5:
        raise AssertionError(f"train resume: started at {resumed['start']}, not 5")
    differ = [f"{name}/{k}" for name in ("params", "opt")
              for k, a in tree_flatten_with_path(whole[name]).items()
              if not torch.equal(a, tree_flatten_with_path(resumed[name])[k])]
    if differ or resumed["losses"] != whole["losses"][5:]:
        raise AssertionError(f"train resume: leaves {differ} differ, losses "
                             f"{resumed['losses']} vs {whole['losses'][5:]}")
    log(f"train resume on {smi}: --reduced mistral-nemo-12b, 10 steps checkpointed every 5 "
        f"== 5 steps then --resume to 10 (deterministic algorithms): all params and "
        f"optimizer leaves bit-equal, losses equal; {secs_d:.1f} s; the checkpoints' "
        f"directory removed")
    log(f"train phase: {time.perf_counter() - t_start:.1f} s (reduced archs on the card "
        f"{secs:.1f} s); launches per step: rwkv6-1.6b {prof_a['launches']}, "
        f"mistral-nemo-12b (4 layers) {prof_b['launches']}; no kernel launched")
    return totals, {"rwkv_step_s": rwkv_step_s, "rwkv_peak": rwkv_peak}


ROOF_CELLS = ((("mistral-nemo-12b", "train_4k", "fsdp", 2),),
              (("gemma3-4b", "decode_32k", "fsdp", 1),))
ROOF_TRAIN = ("rwkv6-1.6b", 8, 128)  # phase 20's uncut run: arch, batch, sequence
ROOF_DECODE = ("gemma3-4b", 4, 32, 16)  # phase 18's serve CLI: arch, batch, prompt, gen
# the fake step's peak over the card's max_memory_allocated: the allocator
# rounds every block up to 512 bytes and the CLI's run adds init temporaries
# and cuBLAS's workspace, a few percent at most; the fake misses nothing the
# step allocates
ROOF_MEM_BAND = (0.95, 1.05)
ROOF_KEYS = {"arch", "shape", "mesh", "rules", "microbatches", "n_devices", "lower_s",
             "compile_s", "memory", "flops_per_device", "hbm_bytes_per_device",
             "collective_bytes_per_device", "collective_breakdown", "model_flops_global",
             "t_compute_s", "t_memory_s", "t_memory_min_s", "t_collective_s", "bottleneck",
             "useful_flops_ratio", "roofline_fraction"}  # the reference's record


def dryrun_cells(cells) -> list:
    """Full-width dry-run records (in a helper process: host work)."""
    from repro_torch.launch import dryrun

    return [dryrun.dryrun_cell(a, s, rules_name=r, microbatches=mb, save=False, verbose=False)
            for a, s, r, mb in cells]


def roofline_shapes():
    from repro_torch.configs import ShapeConfig

    arch, b, s = ROOF_TRAIN
    darch, db, dp, dgen = ROOF_DECODE
    return ((arch, ShapeConfig(f"train_{b}x{s}", s, b, "train")),
            (darch, ShapeConfig(f"decode_b{db}", dp + dgen, db, "decode")))


def roofline_fakes() -> dict:
    """Phase 21's two steps counted on fake tensors, one device, no mesh
    (in a helper process): ``{arch: (flops, bytes, ops, argument bytes,
    peak bytes)}``."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model

    out = {}
    for arch, shape in roofline_shapes():
        cost, mem, _ = dryrun.trace_step(build_model(get_config(arch)), shape, None)
        out[arch] = (cost.flops, cost.bytes_accessed, cost.n_ops, mem["argument"], mem["peak"])
    return out


def roofline_phase(dev, smi: str, train_info: dict) -> dict:
    """(b) The roofline against the card, one card and no mesh, first,
    with no helper process running: rwkv6-1.6b's 8 x 128 train step (a
    fresh state, as phase 20's) and gemma3-4b's decode step at batch 4
    over the serve CLI's 4 x 32 prefill (cache 48), each counted on the
    card with ``op_cost`` and timed with CUDA events (median of 3).  Then
    the host work in two helper processes, with the card idle: (a) the
    full-width dry-run records, every key of the reference's record,
    finite, each logged with its per-device peak against the card's 80 GB;
    and (b)'s two steps counted on fake tensors.  Each card count ==
    the fake count (FLOPs), each step >= max(t_compute, t_memory) of its
    count (roofline share <= 100 %), its MFU logged; the fake train step's
    peak against phase 20's ``max_memory_allocated``, within
    ``ROOF_MEM_BAND``.  No kernel is launched and no process group is left
    in this process.  Returns the launches per kernel (none)."""
    import torch
    import torch.distributed as dist

    from repro_torch import rng
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch import op_cost, roofline as rl
    from repro_torch.models import build_model
    from repro_torch.models.common import cast_tree
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    totals = {k: 0 for k in ops.KERNEL_MODULES}
    counted = _counting(totals)
    t_start = time.perf_counter()
    gib = lambda b: b / 2**30

    def timed(fn, n: int = 3) -> float:
        times = []
        for _ in range(n):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b) / 1e3)
        return statistics.median(times)

    def train_part():
        arch, b, s = ROOF_TRAIN
        model = build_model(get_config(arch))
        params, opt = init_train_state(model, rng.PRNGKey(0, device=dev))
        data = SyntheticLM(model.cfg.vocab, s, b, seed=17)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.shard_batch(0).items()}
        step = make_train_step(model, TrainConfig())
        step(params, opt, batch)  # warm
        torch.cuda.synchronize()
        with op_cost.count() as card:
            step(params, opt, batch)
            torch.cuda.synchronize()
        return card, timed(lambda: step(params, opt, batch))

    def decode_part():
        arch, b, p, gen = ROOF_DECODE
        model = build_model(get_config(arch))
        params = model.init_params(rng.PRNGKey(0, device=dev), torch.bfloat16)
        prompts = rng.randint(rng.PRNGKey(1, device=dev), (b, p), 0, model.cfg.vocab)
        _, cache, clen = model.prefill_fn(params, {"tokens": prompts}, p + gen)
        tokens = prompts[:, -1:]
        decode = lambda: model.decode_fn(cast_tree(params, torch.bfloat16), cache, tokens, clen)
        decode()  # warm
        torch.cuda.synchronize()
        with op_cost.count() as card:
            decode()
            torch.cuda.synchronize()
        return card, timed(decode)

    # (b) on the card
    (train_card, train_s), secs_t, _ = counted(train_part)
    torch.cuda.empty_cache()
    (decode_card, decode_s), secs_d, _ = counted(decode_part)
    torch.cuda.empty_cache()
    exact_launches("roofline", totals, {})

    # the host work, the card idle
    t_host = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(2) as pool:
        dry = [pool.apply_async(dryrun_cells, (cells,)) for cells in ROOF_CELLS]
        dry_fake = pool.apply_async(roofline_fakes)
        recs = [r for d in dry for r in d.get(timeout=900)]
        fakes = dry_fake.get(timeout=900)
    secs_host = time.perf_counter() - t_host

    # (a)
    for r in recs:
        nums = [v for v in r.values() if isinstance(v, (int, float))]
        nums += list(r["memory"].values()) + list(r["collective_breakdown"].values())
        if set(r) != ROOF_KEYS or not all(map(math.isfinite, nums)) or \
                r["flops_per_device"] <= 0:
            raise AssertionError(f"dry-run {r['arch']} x {r['shape']}: a key missing or not "
                                 f"finite: {r}")
        m = r["memory"]
        coll = {k: f"{v:.3e}" for k, v in r["collective_breakdown"].items()}
        log(f"dry-run {r['arch']} x {r['shape']} on the {r['n_devices']}-rank fake mesh "
            f"{r['mesh']} ({r['rules']}, {r['microbatches']} microbatches; traced in "
            f"{r['lower_s']} s in a helper process): per device peak {m['peak_live_gb']:.2f} GB "
            f"of the card's 80 GB (arguments {m['argument_gb']:.2f}, temporaries "
            f"{m['temp_gb']:.2f}), {r['flops_per_device']:.4e} FLOPs, "
            f"{r['hbm_bytes_per_device']:.4e} bytes, collectives {coll}; t_compute "
            f"{r['t_compute_s'] * 1e3:.1f} ms, t_memory {r['t_memory_s'] * 1e3:.1f} ms (floor "
            f"{r['t_memory_min_s'] * 1e3:.1f}), t_collective {r['t_collective_s'] * 1e3:.1f} ms, "
            f"{r['bottleneck']}-bound; model FLOPs {r['model_flops_global']:.4e}, useful "
            f"{r['useful_flops_ratio']:.3f}, roofline fraction {r['roofline_fraction']:.4f} "
            f"(a model from the data sheet: {rl.PEAK_FLOPS:.3g} FLOP/s, {rl.HBM_BW:.3g} B/s, "
            f"{rl.LINK_BW:.3g} B/s)")

    # (b) against the fake counts
    def held(arch, shape, card, step_s, extra=""):
        flops, nbytes, n_ops, argument, peak = fakes[arch]
        if card.flops != flops:
            raise AssertionError(f"roofline {arch}: the card counts {card.flops} FLOPs, the fake "
                                 f"step {flops}")
        r = rl.analyze(card, 1, rl.model_flops_for(get_config(arch), shape))
        share = max(r.t_compute, r.t_memory) / step_s
        mfu = r.model_flops / rl.PEAK_FLOPS / step_s
        log(f"roofline {arch} {shape.name} on {smi}, one card: {card.flops:.6e} FLOPs counted on "
            f"the card == on fake tensors; {card.bytes_accessed:.4e} bytes on the card, "
            f"{nbytes:.4e} on fake tensors; {card.n_ops} ops ({n_ops} fake); t_compute "
            f"{r.t_compute * 1e3:.3f} ms, t_memory {r.t_memory * 1e3:.3f} ms (floor "
            f"{r.t_memory_min * 1e3:.3f}); measured step {step_s * 1e3:.3f} ms (CUDA events, "
            f"median of 3, no helper process running){extra}: roofline share "
            f"{100 * share:.2f} % (<= 100 %), MFU {100 * mfu:.3f} % (model FLOPs "
            f"{r.model_flops:.4e} / {rl.PEAK_FLOPS:.3g} / step)")
        if share > 1.0:
            raise AssertionError(f"roofline {arch}: the step beats its roofline: {share}")
        return peak, argument

    arch = ROOF_TRAIN[0]
    peak, argument = held(arch, roofline_shapes()[0][1], train_card, train_s,
                          f"; phase 20's median {train_info['rwkv_step_s'] * 1e3:.1f} ms")
    ratio = peak / train_info["rwkv_peak"]
    log(f"roofline {arch} memory: the fake step's peak {gib(peak):.3f} GiB (arguments "
        f"{gib(argument):.3f}) against phase 20's max_memory_allocated "
        f"{gib(train_info['rwkv_peak']):.3f} GiB: ratio {ratio:.4f} (band {ROOF_MEM_BAND})")
    if not ROOF_MEM_BAND[0] <= ratio <= ROOF_MEM_BAND[1]:
        raise AssertionError(f"roofline {arch}: peak memory ratio {ratio} outside "
                             f"{ROOF_MEM_BAND}")
    held(ROOF_DECODE[0], roofline_shapes()[1][1], decode_card, decode_s)
    if dist.is_initialized():
        raise AssertionError("roofline: a process group is left in the script's process")
    log(f"dry-run and roofline phase: {time.perf_counter() - t_start:.1f} s (on the card: "
        f"train part {secs_t:.1f} s, decode part {secs_d:.1f} s; then the dry-run helpers "
        f"{secs_host:.1f} s, the card idle); no kernel launched")
    return totals


# phase 22, several ranks on the one card: two gloo ranks (NCCL refuses two
# ranks on one device), each a process holding cuda:0, started once by
# ``repro_torch.distrib.ranks.run_ranks`` after the kernels are built, with
# no helper process beside them; each rank runs (a)-(d) in turn and returns
# numpy, and this process holds the results against its own runs
RANKS = 2
RANKS_SCALE_CONNS = 10**5
# the ranks' MoE layers replicate everything but the experts (split over
# "model"), so that a layer's only collectives are y's sum and the aux's
# two means: the forward and decode of phase 19 on two half-expert ranks
RANKS_MOE_RULES = {"batch": ("pod", "data"), "experts": "model", "seq_model": None,
                   "heads": None, "kv_heads": None, "kv_seq": None, "mlp": None,
                   "vocab": None, "state": None}


def _ranks_sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _ranks_timed(fn):
    """``fn()`` between a barrier of the ranks and a device sync, timed."""
    import torch.distributed as dist

    _ranks_sync()
    dist.barrier()
    t0 = time.perf_counter()
    out = fn()
    _ranks_sync()
    return out, time.perf_counter() - t0


def ranks_sweep(dev) -> dict:
    """(a) phase 10(a)'s fig06 grid (FATTREE_128's fabric, the OPS and REPS
    cells one SwitchLB bucket, ``collect="summary"`` with the early exit) at
    ``RANKS_FIG06_TICKS`` over a ``("rows",)`` mesh of both ranks: each row's
    leaves, its branch and the other slot's initial state; the launches."""
    import dataclasses

    from repro_torch import rng
    from repro_torch.bench import common as bc
    from repro_torch.bench import fig06_failures_micro as fig06
    from repro_torch.kernels import ops
    from repro_torch.netsim import SweepEngine, sim_state_to_numpy
    from repro_torch.netsim.interop import lb_state_to_numpy

    cfg = bc.ci_cfg(full=True)
    cases = [dataclasses.replace(c, ticks=RANKS_FIG06_TICKS, seeds=(0,))
             for c in fig06.cases(cfg, full=True)]
    eng = SweepEngine(cfg, cases, device=dev)  # devices="auto": the group's ranks

    def run():
        ops.reset_launch_counts()
        res = eng.run(collect="summary", early_exit=True)
        return res, ops.launch_counts()

    (res, counts), secs = _ranks_timed(run)
    rows = {}
    for c in cases:
        b, cell = res._find(c.name)
        init = b.lb.init_state(b.sim.wl.n_conns, rng.fold_in(rng.PRNGKey(c.seeds[0], device=dev),
                                                             777))[1]
        rows[c.name] = dict(lb=c.lb, branch=cell.branch,
                            state=sim_state_to_numpy(res.state_for(c.name)),
                            init={i: lb_state_to_numpy(v) for i, v in enumerate(init)
                                  if i != cell.branch})
    return dict(rows=rows, secs=secs, counts=counts, n_devices=eng.n_devices,
                plan=eng.plan.describe(), ticks_run=[b.ticks_run for b in res.buckets],
                local_rows=[int(b.keys.shape[0]) for b in eng.buckets],
                exec_s=[b.exec_wall_s for b in res.buckets])


def ranks_conn(dev, ticks: int) -> dict:
    """(b) phase 12's 10**5-connection scale row with its connection axis
    split over both ranks (``bench/scale_smoke.run_row(conn_devices=2)``):
    the gathered leaves and the rank's numbers."""
    from repro_torch.bench.scale_smoke import run_row
    from repro_torch.netsim import sim_state_to_numpy

    (eng, res, info), secs = _ranks_timed(
        lambda: run_row(RANKS_SCALE_CONNS, ticks, device=dev, conn_devices=RANKS))
    return dict(state=sim_state_to_numpy(res.state_for(eng.cases[0].name)), info=info,
                secs=secs, mesh=tuple(eng.mesh.shape))


def ranks_moe(dev, toks) -> dict:
    """(c) phase 19's phi3.5-moe (full width, ``FAMILY_MOE_LAYERS`` layers,
    bf16) on a (1, 2) ``("data", "model")`` mesh: each rank draws only its
    half of every layer's experts from PRNGKey(0), then the bf16 serve steps
    take phase 19's prompt and its greedy tokens (a prefill and
    ``RANKS_MOE_DECODE`` decode steps), routing recorded."""
    import dataclasses

    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import rng
    from repro_torch.configs import get_config
    from repro_torch.distrib import sharding as shd
    from repro_torch.launch.dryrun import axes_to_shardings
    from repro_torch.models import build_model
    from repro_torch.train import make_serve_steps
    from repro_torch.tree import tree_flatten_with_path, tree_map_with_path
    from serve_parity import as_np, port_routing

    cfg = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b"), n_layers=FAMILY_MOE_LAYERS)
    model = build_model(cfg)
    mesh = init_device_mesh(dev.type, (1, RANKS), mesh_dim_names=("data", "model"))
    e_loc = cfg.n_experts // RANKS
    lo = mesh.get_coordinate()[1] * e_loc
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    local, init_s = _ranks_timed(lambda: model.init_params(
        rng.PRNGKey(0, device=dev), torch.bfloat16, experts=(lo, lo + e_loc)))
    places = axes_to_shardings(mesh, model.param_axes(), None, RANKS_MOE_RULES)

    def placed(path, t):
        pl = places[path]
        shape = list(t.shape)
        for m, p in enumerate(pl):
            if p.is_shard():
                shape[p.dim] *= mesh.size(m)
        return DTensor.from_local(t, mesh, pl, run_check=False, shape=tuple(shape),
                                  stride=shd.contiguous_stride(shape))

    params = tree_map_with_path(placed, local)
    prefill, decode = make_serve_steps(model)
    toks = toks.to(dev)
    P = toks.shape[1] - RANKS_MOE_DECODE
    plain = lambda t: as_np(t.full_tensor() if isinstance(t, DTensor) else t)
    calls, logits, step_s = [], [], []
    with shd.mesh_rules(mesh, RANKS_MOE_RULES), implicit_replication(), port_routing(calls):
        (lg, state, clen), s = _ranks_timed(lambda: prefill(params, {"tokens": toks[:, :P]},
                                                            toks.shape[1] + 1))
        logits.append(plain(lg))
        step_s.append(s)
        for t in range(P, toks.shape[1]):
            (lg, state, clen), s = _ranks_timed(
                lambda t=t: decode(params, state, toks[:, t:t + 1], clen))
            logits.append(plain(lg))
            step_s.append(s)
    return dict(init_s=init_s, step_s=step_s, logits=logits, routing=calls,
                peak=torch.cuda.max_memory_allocated() if cuda else 0, experts=(lo, lo + e_loc),
                held_bytes=sum(t.nbytes for t in tree_flatten_with_path(local).values()))


def ranks_reshard(dev, path: str) -> dict:
    """(d) the checkpoint the parent saved (``tests/ranks_parity``'s reduced
    mistral-nemo trees) restored with ``axes=`` onto a (1, 2) mesh under the
    fsdp rules: per leaf, whether this rank's local shard is bit-equal to
    its block of the saved array."""
    import numpy as np
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import restore
    from repro_torch.distrib import sharding as shd
    from repro_torch.launch.dryrun import RULE_SETS
    from repro_torch.tree import tree_flatten_with_path
    from ranks_parity import reshard_trees

    like, axes = reshard_trees()
    mesh = init_device_mesh(dev.type, (1, RANKS), mesh_dim_names=("data", "model"))

    def run():
        with shd.mesh_rules(mesh, RULE_SETS["fsdp"]):
            return restore(path, like, axes=axes, device=dev)

    (trees, step), secs = _ranks_timed(run)
    coord, held, sharded, bad = mesh.get_coordinate(), 0, 0, []
    for name, tree in trees.items():
        saved = np.load(f"{path}/{name}.npz")
        for k, t in tree_flatten_with_path(tree).items():
            want = saved[k]
            if isinstance(t, DTensor):
                block = [slice(0, n) for n in want.shape]
                for m, p in enumerate(t.placements):
                    if p.is_shard():
                        size = want.shape[p.dim] // mesh.size(m)
                        block[p.dim] = slice(coord[m] * size, (coord[m] + 1) * size)
                        sharded += 1
                got, want = t.to_local().cpu().numpy(), want[tuple(block)]
            else:
                got = t.cpu().numpy()
            held += got.nbytes
            if (got.dtype, got.shape) != (want.dtype, want.shape) or (
                    got.tobytes() != want.tobytes()):
                bad.append(f"{name}/{k}")
    return dict(step=step, secs=secs, bad=bad, sharded=sharded, held=held,
                leaves=sum(len(tree_flatten_with_path(t)) for t in trees.values()))


def ranks_work(rank: int, device: str, moe_toks, ckpt: str, scale_ticks: int) -> dict:
    """One rank of phase 22: on the card the kernels loaded (built by the
    parent), then (a)-(d) in turn."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        from repro_torch.kernels import build

        build.library()
    out = {"a": ranks_sweep(dev), "b": ranks_conn(dev, scale_ticks)}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["c"] = ranks_moe(dev, moe_toks)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["d"] = ranks_reshard(dev, ckpt)
    return out


def ranks_phase(dev, snaps: dict, row5: tuple, moe_ref: dict, scale_ticks: int) -> dict:
    """Several ranks on the one card (see ``ranks_work``): (a) every row of
    the two-rank fig06 sweep equals the main path's run at tick
    ``RANKS_FIG06_TICKS`` (``snaps``) on every leaf, its active SwitchLB
    slot against the plain load balancer and the other slot at its init,
    and its ``ticks_run`` is the one-rank sweep's (no row is quiescent
    there, so no chunk boundary could have ended it sooner); (b) the
    conn-sharded 10**5 row equals phase 12's one-rank card run ``row5`` on
    every leaf; (c) phi3.5-moe's two half-expert ranks against phase 19's
    one-card run ``moe_ref`` by the bf16 serve rule (``tests/serve_parity``:
    logits per row within 3e-2, routing flips found at near ties), its
    prefill's drops equal; (d) every restored leaf's local shard equal to
    its block.  Returns the launches per kernel (summed over the ranks)."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint import save
    from repro_torch.distrib.ranks import run_ranks
    from repro_torch.kernels import ops
    from ranks_parity import reshard_trees
    from serve_parity import TOL, routing_divergence

    totals = {k: 0 for k in ops.KERNEL_MODULES}
    t_start = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        trees, axes = reshard_trees()
        ckpt = f"{tmp}/step_7"
        save(ckpt, 7, trees, axes=axes)
        del trees
        t0 = time.perf_counter()
        out = run_ranks(ranks_work, RANKS, dev.type, "gloo",
                        args=(dev.type, moe_ref["toks"], ckpt, scale_ticks), timeout=900)
        spawn_s = time.perf_counter() - t0
    gib = lambda b: "n/a" if b is None else f"{b / 2**30:.3f}"

    # (a) rows == the main path's runs at the horizon
    for r, o in enumerate(out):
        a = o["a"]
        if (a["n_devices"], a["local_rows"], a["ticks_run"]) != (RANKS, [1], [RANKS_FIG06_TICKS]):
            raise AssertionError(f"ranks (a) rank {r}: {a['n_devices']} ranks, local rows "
                                 f"{a['local_rows']}, ticks_run {a['ticks_run']}")
        for k, m in SWEEP_PER_TICK.items():
            if a["counts"][k] != m * RANKS_FIG06_TICKS:
                raise AssertionError(f"ranks (a) rank {r}: {k} launched {a['counts'][k]} times, "
                                     f"expected {m} x {RANKS_FIG06_TICKS}")
            totals[k] += a["counts"][k]
        for name, row in a["rows"].items():
            want = snaps[row["lb"]]
            got = row["state"]
            same_leaves({k: v for k, v in got.items() if not k.startswith("lb_state")},
                        {k: v for k, v in want.items() if not k.startswith("lb_state")},
                        f"ranks (a) rank {r} {name} vs the main path at {RANKS_FIG06_TICKS}")
            slot = lambda i: {"lb_state" + k[len(f"lb_state.1.{i}"):]: v for k, v in got.items()
                              if k == f"lb_state.1.{i}" or k.startswith(f"lb_state.1.{i}.")}
            same_leaves(slot(row["branch"]), {k: v for k, v in want.items()
                                              if k.startswith("lb_state")},
                        f"ranks (a) rank {r} {name}: active SwitchLB slot vs the plain LB")
            for i, init in row["init"].items():
                same_leaves(slot(i), init, f"ranks (a) rank {r} {name}: slot {i} vs init")
            if int(got["lb_state.0"]) != row["branch"]:
                raise AssertionError(f"ranks (a) {name}: branch {got['lb_state.0']}")
    done = {lb: int(s["c_done"].sum()) for lb, s in snaps.items()}
    if min(128 - d for d in done.values()) <= 0:
        raise AssertionError(f"ranks (a): a row is complete at {RANKS_FIG06_TICKS}: {done}")
    a0 = out[0]["a"]
    log(f"ranks (a) row mesh, {RANKS} gloo ranks on {dev}: the fig06 grid (FATTREE_128, "
        f"SwitchLB(ops, reps), collect=summary, early exit) to {RANKS_FIG06_TICKS} ticks, one row "
        f"per rank: ticks_run {a0['ticks_run']} == the one-rank sweep's (completed "
        f"{done} of 128 at the horizon: no chunk boundary was quiescent); on every rank every "
        f"row == the main path's run at tick {RANKS_FIG06_TICKS} on all "
        f"{len(next(iter(a0['rows'].values()))['state'])} leaves (the active SwitchLB slot "
        f"against the plain LB, the other at its init); launches per rank exact; "
        + ", ".join(f"rank {r}: {o['a']['secs']:.3f} s" for r, o in enumerate(out)))
    log("ranks (a) plan:\n" + a0["plan"])

    # (b) the conn-sharded row == phase 12's one-rank card run
    want, one = row5
    for r, o in enumerate(out):
        b = o["b"]
        same_leaves(b["state"], want, f"ranks (b) rank {r}: conn-sharded 10**5 row vs one rank")
        for k, n in FLEET_PER_TICK.items():
            if b["info"]["launches_per_tick"][k] != n:
                raise AssertionError(f"ranks (b) rank {r}: {k} "
                                     f"{b['info']['launches_per_tick'][k]} launches per tick")
            totals[k] += n * scale_ticks
    info = [o["b"]["info"] for o in out]
    log(f"ranks (b) connection axis, mesh {out[0]['b']['mesh']} (rows, conns): the 10**5 row, "
        f"{scale_ticks} ticks, all {len(want)} SimState leaves on every rank == phase 12's "
        f"one-rank card run; exec {', '.join(f'{i['exec_wall_s']:.3f}' for i in info)} s "
        f"({', '.join(f'{i['ticks_per_sec']:.1f}' for i in info)} ticks/s; one rank "
        f"{one['ticks_per_sec']:.1f}); peak memory per rank "
        f"{', '.join(gib(i['peak_mem_bytes']) for i in info)} GiB (one rank "
        f"{gib(one['peak_mem_bytes'])}); bitmap bytes per connection per rank "
        f"{', '.join(f'{i['bitmap_bytes_per_conn']:.4f}' for i in info)} (one rank "
        f"{one['bitmap_bytes_per_conn']:.4f}), per-connection vectors "
        f"{info[0]['conn_vector_bytes_per_conn']:.4f} B (one rank "
        f"{one['conn_vector_bytes_per_conn']:.4f})")

    # (c) phi3.5-moe on two half-expert ranks against phase 19's one card
    n_layers, batch = FAMILY_MOE_LAYERS, moe_ref["toks"].shape[0]
    for r, o in enumerate(out):
        c = o["c"]
        dropped = [int((~keep).sum()) for _, _, keep in c["routing"][:n_layers]]
        if dropped != moe_ref["dropped"]:
            raise AssertionError(f"ranks (c) rank {r}: prefill drops {dropped}, one card "
                                 f"{moe_ref['dropped']}")
        diverged = routing_divergence(c["routing"], moe_ref["routing"], n_layers, batch)
        worst, found = 0.0, []
        for i, (g, w) in enumerate(zip(c["logits"], moe_ref["logits"], strict=True)):
            norm = np.abs(w).max()
            if not (g.shape == w.shape and np.isfinite(g).all()):
                raise AssertionError(f"ranks (c) rank {r} step {i}: logits {g.shape}")
            for row in range(g.shape[0]):
                err = float(np.abs(g[row] - w[row]).max() / norm)
                if err <= TOL["bf16"]:
                    worst = max(worst, err)
                elif row in diverged[i]:
                    found.append((i, row, diverged[i][row]))
                else:
                    raise AssertionError(f"ranks (c) rank {r} step {i} row {row}: logits rel "
                                         f"{err} (> {TOL['bf16']})")
        o["c"]["worst"], o["c"]["found"] = worst, found
    c0 = out[0]["c"]
    dec = [sum(o["c"]["step_s"][1:]) for o in out]
    log(f"ranks (c) MoE expert parallel, mesh (1, {RANKS}) (data, model): phi3.5-moe "
        f"(full width, {n_layers} layers, bf16), each rank experts "
        f"{', '.join(str(o['c']['experts']) for o in out)} drawn alone: init "
        f"{', '.join(f'{o['c']['init_s']:.3f}' for o in out)} s, held "
        f"{', '.join(gib(o['c']['held_bytes']) for o in out)} GiB, peak "
        f"{', '.join(gib(o['c']['peak']) for o in out)} GiB; prefill "
        f"{batch}x{moe_ref['toks'].shape[1] - RANKS_MOE_DECODE} "
        f"{c0['step_s'][0] * 1e3:.1f} ms, decode {RANKS_MOE_DECODE} steps "
        f"{', '.join(f'{batch * RANKS_MOE_DECODE / d:.1f}' for d in dec)} tokens/s; prefill "
        f"drops {moe_ref['dropped']} == one card; logits vs phase 19's one card (bf16 rule, "
        f"rel <= {TOL['bf16']}): worst held {', '.join(f'{o['c']['worst']:.3e}' for o in out)}; "
        f"found, not held: {[o['c']['found'] for o in out]}")

    # (d) the re-shard
    for r, o in enumerate(out):
        d = o["d"]
        if d["bad"] or d["step"] != 7 or not d["sharded"]:
            raise AssertionError(f"ranks (d) rank {r}: leaves {d['bad']} differ (step "
                                 f"{d['step']}, {d['sharded']} sharded)")
    d0 = out[0]["d"]
    log(f"ranks (d) restore(axes=) onto (1, {RANKS}) under fsdp: all {d0['leaves']} leaves of "
        f"the reduced mistral-nemo checkpoint, {d0['sharded']} placements sharded: every "
        f"rank's local shard bit-equal to its block (rank bytes "
        f"{', '.join(str(o['d']['held']) for o in out)}); "
        f"{', '.join(f'{o['d']['secs']:.3f}' for o in out)} s")
    log(f"ranks phase: {time.perf_counter() - t_start:.1f} s ({spawn_s:.1f} s in the ranks; "
        f"(a) {a0['secs']:.1f}, (b) {out[0]['b']['secs']:.1f}, (c) init "
        f"{c0['init_s']:.1f} + serve {sum(c0['step_s']):.1f}, (d) {d0['secs']:.1f} s on rank "
        f"0); no helper process beside them; gloo on one card, not NCCL across cards")
    return totals


# phase 23, the bench runner's flight recorder and the user examples: the
# smallest figure grid whose --smoke run is short on the card (fig03: two
# rows, quiescent at 500 ticks) through ``repro_torch.bench.run`` traced and
# untraced; quickstart and failover_demo at cut horizons, card == CPU;
# serve_batched with its arguments; train_lm cut, checkpointed and resumed
EX_FIG = "fig03"
EX_TRACE = 64
# quickstart: by tick 240 ECMP has 30 of its 32 messages done (the last two
# wait for an RTO), OPS and REPS all 32 by 134; the uplinks fail at 300.
# failover_demo: the spine goes down at 250 and both rows' first re-routed
# delivery lands by 266
EX_QUICKSTART = dict(healthy_ticks=240, failure_ticks=320)
EX_FAILOVER = dict(ticks=400, window=100)
EX_TRAIN = dict(arch="mistral-nemo-12b", reduced=True, batch=8, seq=128, ckpt_every=10)
EX_TRAIN_STEPS = 20


def example_run(name: str, dev) -> tuple:
    """``quickstart`` or ``failover_demo`` at the phase's cut on ``dev``:
    ``(printed lines, the summaries (and the failover's recovery) as JSON,
    seconds)``.  On the CPU it runs in a helper process."""
    import contextlib
    import dataclasses
    import io
    import json as _json

    import torch

    from repro_torch.examples import failover_demo, quickstart

    if torch.device(dev).type == "cpu":
        torch.set_num_threads(2)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        if name == "quickstart":
            got = quickstart.main(dev, **EX_QUICKSTART)
            summ = {f"{blk}/{lbn}": dataclasses.asdict(s) for (blk, lbn), s in got.items()}
        else:
            res = failover_demo.main(dev, **EX_FAILOVER)["result"]
            summ = {n: {**dataclasses.asdict(s), "recovery": res.telemetry_for(n)["recovery"]}
                    for n, (s,) in res.summaries().items()}
    secs = time.perf_counter() - t0
    return buf.getvalue().splitlines(), _json.dumps(summ, sort_keys=True, default=float), secs


def examples_phase(dev, smi: str) -> dict:
    """(a) quickstart and failover_demo at ``EX_QUICKSTART`` / ``EX_FAILOVER``
    on the card, every printed line and summary == the CPU's (two helper
    processes, gone before (b)); (b) ``python -m repro_torch.bench.run
    --only EX_FIG --smoke`` untraced and with ``--trace EX_TRACE``, each into
    a temporary ``--out``: every row's ``derived`` equal, the stamps 0 and
    EX_TRACE, the traced grid's wall against the untraced one's, and a traced
    run of ``table1`` merged into the untraced file reads ``"trace":
    "mixed"``; (c) serve_batched with the reference's arguments: tokens in
    the vocabulary, the prefill's logits finite; (d) train_lm cut to
    EX_TRAIN_STEPS steps checkpointed every 10, against a run
    ``--resume``d to EX_TRAIN_STEPS from a copy of its middle checkpoint
    (deterministic algorithms): losses finite, params, optimizer state and
    losses bit-equal.  Returns the launches per kernel."""
    import json as _json
    import os
    import shutil
    import tempfile

    import torch

    from repro_torch.bench import run as bench_run
    from repro_torch.examples import serve_batched, train_lm
    from repro_torch.train import make_serve_steps
    from repro_torch.tree import tree_flatten_with_path

    t_start = time.perf_counter()
    totals = {k: 0 for k in ("seg_sum", "seg_rank", "reps_tick", "queue_tick", "ecmp_hash",
                             "next_queue", "next_queue_table")}
    counted = _counting(totals)

    # (a) the simulator examples, card == CPU
    with multiprocessing.get_context("spawn").Pool(2) as pool:
        cpu = {n: pool.apply_async(example_run, (n, "cpu"))
               for n in ("quickstart", "failover_demo")}
        card = {}
        for name in ("quickstart", "failover_demo"):
            out, _, counts = counted(lambda: example_run(name, dev))
            card[name] = (*out, counts)
        cpu = {n: p.get(timeout=600) for n, p in cpu.items()}
    h, f = EX_QUICKSTART["healthy_ticks"], EX_QUICKSTART["failure_ticks"]
    n = 3 * h + 2 * f  # one Simulator tick each: 3 healthy runs, 2 failure runs
    exact_launches("quickstart", card["quickstart"][3], {
        "seg_sum": 4 * n, "seg_rank": n, "queue_tick": n, "next_queue": n, "reps_tick": h + f})
    if not all(card["failover_demo"][3][k] for k in ("seg_sum", "seg_rank", "reps_tick",
                                                     "queue_tick", "next_queue")):
        raise AssertionError(f"failover_demo: launches {card['failover_demo'][3]}")
    for name in ("quickstart", "failover_demo"):
        lines, summ, secs, counts = card[name]
        c_lines, c_summ, c_secs = cpu[name]
        if lines != c_lines or summ != c_summ:
            raise AssertionError(f"{name}: the card's output differs from the CPU's:\n"
                                 + "\n".join(lines) + "\n-- CPU --\n" + "\n".join(c_lines))
        for ln in lines:
            log(f"  {name} | {ln}")
        log(f"{name} ({EX_QUICKSTART if name == 'quickstart' else EX_FAILOVER}) on {smi}: "
            f"every printed line and summary == the CPU's; card {secs:.3f} s (beside the "
            f"CPU helpers), CPU {c_secs:.3f} s; launches "
            f"{ {k: v for k, v in counts.items() if v} }")

    # (b)-(d) write into one temporary directory, removed at the end
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp:
        # (b) the runner's flight recorder: no helper process runs now
        env = {k: os.environ.get(k) for k in ("BENCH_SEEDS", "BENCH_TRACE")}
        try:
            outs, walls = {}, {}
            for trace in (0, EX_TRACE):
                out = os.path.join(tmp, f"trace{trace}.json")
                rc, secs, counts = counted(lambda: bench_run.main(
                    ["--only", EX_FIG, "--smoke", "--trace", str(trace), "--out", out,
                     "--device", dev.type]))
                if rc != 0:
                    raise AssertionError(f"bench.run --trace {trace}: exit code {rc}")
                with open(out) as f:
                    outs[trace] = _json.load(f)
                walls[trace] = outs[trace]["rows"][f"{EX_FIG}/sweep_total"]["us_per_call"] / 1e6
                log(f"bench.run --only {EX_FIG} --smoke --trace {trace}: {secs:.3f} s, grid exec "
                    f"{walls[trace]:.4f} s; launches {({k: v for k, v in counts.items() if v})}")
            plain, traced = (outs[t]["rows"] for t in (0, EX_TRACE))
            if plain.keys() != traced.keys() or len(plain) < 4:
                raise AssertionError(f"bench.run: rows {sorted(plain)} vs {sorted(traced)}")
            for name in plain:
                if plain[name]["derived"] != traced[name]["derived"]:
                    raise AssertionError(f"bench.run {name}: traced {traced[name]['derived']!r} vs "
                                         f"untraced {plain[name]['derived']!r}")
                if (plain[name]["trace"], traced[name]["trace"]) != (0, EX_TRACE):
                    raise AssertionError(f"bench.run {name}: stamps {plain[name]['trace']}, "
                                         f"{traced[name]['trace']}")
            merged_out = os.path.join(tmp, "trace0.json")
            rc, _, counts = counted(lambda: bench_run.main(
                ["--only", "table1", "--trace", str(EX_TRACE), "--out", merged_out,
                 "--device", dev.type]))
            with open(merged_out) as f:
                meta = _json.load(f)["meta"]
            if rc != 0 or meta["trace"] != "mixed" \
                    or meta["sweep_totals"] != [f"{EX_FIG}/sweep_total"]:
                raise AssertionError(f"bench.run merge: rc {rc}, meta {meta}")
            log(f"bench.run on {smi}: {len(plain)} rows of {EX_FIG} --smoke, traced (ring "
                f"{EX_TRACE}) == untraced on every derived field, stamped trace 0 and {EX_TRACE}; "
                f"grid wall traced {walls[EX_TRACE]:.4f} s against untraced {walls[0]:.4f} s "
                f"({walls[EX_TRACE] / walls[0]:.3f}x); a traced table1 run merged into the "
                f"untraced file: meta trace {meta['trace']!r}, sweep_totals {meta['sweep_totals']}")
        finally:
            for k, v in env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

        # (c) serve_batched with the reference's arguments
        out, secs_c, counts = counted(lambda: serve_batched.main(dev))
        exact_launches("serve_batched", counts, {})
        toks, cfg = out["tokens"], out["cfg"]
        logits = make_serve_steps(out["model"])[0](out["params"], {"tokens": out["prompts"]},
                                                   out["prompts"].shape[1] + toks.shape[1])[0]
        if toks.shape != (4, 16) or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab \
                or not bool(torch.isfinite(logits.float()).all()):
            raise AssertionError(f"serve_batched: tokens {tuple(toks.shape)}, logits finite "
                                 f"{bool(torch.isfinite(logits.float()).all())}")
        log(f"serve_batched on {smi}: reduced gemma3-4b, 4 x 32 prompts, 16 tokens each in the "
            f"vocabulary, the prefill's logits finite; prefill {out['prefill_s'] * 1e3:.1f} ms, "
            f"decode {out['decode_s'] * 1e3:.1f} ms; {secs_c:.3f} s")
        del out, logits

        # (d) train_lm cut, checkpointed and resumed
        # the resumed run starts from a copy of the whole run's middle
        # checkpoint (a run of fewer steps would decay its rate sooner)
        half = EX_TRAIN_STEPS // 2

        def resume():
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                whole = train_lm.main(dev, steps=EX_TRAIN_STEPS, ckpt_dir=os.path.join(tmp, "a"),
                                      **EX_TRAIN)
                shutil.copytree(os.path.join(tmp, "a", f"step_{half}"),
                                os.path.join(tmp, "b", f"step_{half}"))
                resumed = train_lm.main(dev, steps=EX_TRAIN_STEPS, ckpt_dir=os.path.join(tmp, "b"),
                                        extra=["--resume"], **EX_TRAIN)
            finally:
                torch.use_deterministic_algorithms(False)
            return whole, resumed

        (whole, resumed), secs_d, counts = counted(resume)
        exact_launches("train_lm", counts, {})
        if not all(map(math.isfinite, whole["losses"] + whole["grad_norms"])):
            raise AssertionError(f"train_lm: losses {whole['losses']}")
        if resumed["start"] != half:
            raise AssertionError(f"train_lm resume: started at {resumed['start']}")
        differ = [f"{name}/{k}" for name in ("params", "opt")
                  for k, a in tree_flatten_with_path(whole[name]).items()
                  if not torch.equal(a, tree_flatten_with_path(resumed[name])[k])]
        if differ or resumed["losses"] != whole["losses"][half:]:
            raise AssertionError(f"train_lm resume: leaves {differ} differ, losses "
                                 f"{resumed['losses']} vs {whole['losses'][half:]}")
        log(f"train_lm on {smi}: reduced {EX_TRAIN['arch']}, {EX_TRAIN['batch']} x "
            f"{EX_TRAIN['seq']}, {EX_TRAIN_STEPS} steps checkpointed every "
            f"{EX_TRAIN['ckpt_every']} (loss {whole['losses'][0]:.4f} -> "
            f"{whole['losses'][-1]:.4f}, all finite); --resume from a copy of its step-{half} "
            f"checkpoint to {EX_TRAIN_STEPS} == the whole run (deterministic algorithms): params, optimizer "
            f"state and losses bit-equal; {secs_d:.3f} s")
    log(f"examples phase: {time.perf_counter() - t_start:.1f} s")
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
    ap.add_argument("--arena-ticks", type=int, default=200,
                    help="arena ticks per cell (past the failures at 150)")
    ap.add_argument("--check-ticks", type=int, default=1200, help="REPS card-vs-CPU horizon")
    ap.add_argument("--zoo-check-ticks", type=int, default=200,
                    help="card-vs-CPU horizon of each zoo load balancer")
    ap.add_argument("--fig18-ticks", type=int, default=800, help="fig18/3tier/reps ticks")
    ap.add_argument("--fig18-check-ticks", type=int, default=400,
                    help="fig18/3tier/reps card-vs-CPU horizon")
    ap.add_argument("--fleet-ticks", type=int, default=200,
                    help="ticks of the B=4 fleet held against serial runs")
    ap.add_argument("--fleet-check-ticks", type=int, default=460,
                    help="card-vs-CPU horizon of the small fleet")
    ap.add_argument("--fleet-bench-ticks", type=int, default=50,
                    help="timed ticks per fleet per round")
    ap.add_argument("--fleet-rounds", type=int, default=2, help="interleaved rounds over B")
    ap.add_argument("--tel-ticks", type=int, default=200,
                    help="ticks of the four full-width telemetry rows held against serial runs")
    ap.add_argument("--tel-check-ticks", type=int, default=600,
                    help="card-vs-CPU horizon of the small telemetry fleet")
    ap.add_argument("--tel-bench-ticks", type=int, default=30,
                    help="timed ticks per (B, path) per telemetry round")
    ap.add_argument("--tel-rounds", type=int, default=2, help="interleaved telemetry rounds")
    ap.add_argument("--sweep-fig06-ticks", type=int, default=4200,
                    help="the sweep's fig06 horizon (the figure's own is 8000; by 4200 the REPS "
                         "row has completed and the OPS row has completions)")
    ap.add_argument("--fabric-check-ticks", type=int, default=200,
                    help="card-vs-CPU horizon of the rail and mesh cells")
    ap.add_argument("--scale-row5-ticks", type=int, default=150,
                    help="ticks of the 10**5-connection row (card vs CPU)")
    ap.add_argument("--scale-row6-ticks", type=int, default=200,
                    help="ticks of the 10**6-connection row")
    ap.add_argument("--scale-prof-ticks", type=int, default=32,
                    help="profiled ticks of the 10**6-connection row")
    ap.add_argument("--bins-steps", type=int, default=4000,
                    help="fig13/14 steps (the paper's scale is 10000; the Theorem 5.1 checks "
                         "need >= 4000)")
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
                  TEL_TICKS=args.tel_ticks, BINS_STEPS=args.bins_steps)
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

    totals, rates, main_refs, snaps_1200 = main_path(dev, args.ticks)
    profile_window(dev, warm=300, ticks=25)
    phase_done("main path and profile")
    # the CPU sides of phases 5, 11, 12, 8 and 9, in the order they are
    # needed, in two helper processes while the card runs
    with multiprocessing.get_context("spawn").Pool(2) as early:
        cpu_fig18, cpu_fabrics = (early.apply_async(early_cpu_run, a) for a in (
            ("fig18", args.fig18_check_ticks), ("fabrics", args.fabric_check_ticks)))
        cpu_row5 = early.apply_async(scale_row_cpu, (10**5, args.scale_row5_ticks))
        cpu_fleet, cpu_tel = (early.apply_async(early_cpu_run, a) for a in (
            ("fleet", args.fleet_check_ticks), ("telemetry", args.tel_check_ticks)))
        fig18_counts, fig18_card = three_tier_cell(dev, args.fig18_ticks,
                                                   args.fig18_check_ticks, cpu_fig18)
        for k, n in fig18_counts.items():
            totals[k] += n
        phase_done("fig18/3tier")
        for k, n in arena_cells(dev, args.arena_ticks).items():
            totals[k] += n
        phase_done("arena")
        dense_reps = card_vs_cpu(dev, args.check_ticks, args.zoo_check_ticks)
        phase_done("card vs CPU")
        for k, n in fabric_phase(dev, fig18_card, args.fig18_check_ticks,
                                 args.fabric_check_ticks, cpu_fabrics).items():
            totals[k] += n
        del fig18_card
        phase_done("generated fabrics")
        scale_totals, row5 = scale_phase(dev, dense_reps, args.scale_row5_ticks,
                                         args.scale_row6_ticks, args.scale_prof_ticks, cpu_row5)
        for k, n in scale_totals.items():
            totals[k] += n
        del dense_reps
        phase_done("scale mode")
        fleet_totals, warmed = fleet_phase(dev, args.fleet_ticks, args.fleet_check_ticks,
                                           args.fleet_bench_ticks, args.fleet_rounds, warm=300,
                                           one_run_rate=rates["reps"], cpu_small=cpu_fleet)
        for k, n in fleet_totals.items():
            totals[k] += n
        phase_done("fleet")
        for k, n in telemetry_phase(dev, args.tel_ticks, args.tel_check_ticks,
                                    args.tel_bench_ticks, args.tel_rounds, warmed,
                                    cpu_tel).items():
            totals[k] += n
        del warmed
        phase_done("telemetry")
    with multiprocessing.get_context("spawn").Pool(3) as pool:
        cpu_grids = {g: pool.apply_async(sweep_cpu_runs, (g,)) for g in ("fig04", "fig07", "zoo")}
        for k, n in sweep_phase(dev, args.sweep_fig06_ticks, main_refs, warm=100,
                                prof_ticks=10, cpu_grids=cpu_grids).items():
            totals[k] += n
    del main_refs
    phase_done("sweep")
    for k, n in bins_phase(dev, args.bins_steps).items():
        totals[k] += n
    phase_done("balls into bins")
    for k, n in soak_phase(dev).items():
        totals[k] += n
    phase_done("soak")
    with multiprocessing.get_context("spawn").Pool(3) as pool:
        cpu_chaos = {lbl: pool.apply_async(chaos_run, (lbl, "cpu")) for lbl in CHAOS_LABELS}
        cpu_fig15 = pool.apply_async(fig15_run, ("cpu",))
        for k, n in chaos_phase(dev, cpu_chaos).items():
            totals[k] += n
        phase_done("chaos")
        for k, n in fig15_phase(dev, cpu_fig15).items():
            totals[k] += n
        phase_done("fig15 hook")
    with multiprocessing.get_context("spawn").Pool(2) as pool:
        cpu_channels = pool.apply_async(channels_run, ("cpu",))
        cpu_serve = pool.apply_async(serve_reduced_runs, ("cpu",))
        for k, n in channels_phase(dev, cpu_channels).items():
            totals[k] += n
        phase_done("channels")
        for k, n in serve_phase(dev, cpu_serve, smi).items():
            totals[k] += n
        phase_done("serve")
    with multiprocessing.get_context("spawn").Pool(2) as pool:
        cpu_families = pool.apply_async(serve_reduced_runs, ("cpu",),
                                        {"cases": FAMILY_CASES, "P": FAMILY_P})
        cpu_train = pool.apply_async(train_reduced_runs, ("cpu",), {"ulp": True})
        family_totals, moe_ref = families_phase(dev, cpu_families, smi)
        for k, n in family_totals.items():
            totals[k] += n
        phase_done("serve families")
        counts, train_info = train_phase(dev, cpu_train, smi)
        for k, n in counts.items():
            totals[k] += n
        phase_done("train")
    for k, n in roofline_phase(dev, smi, train_info).items():
        totals[k] += n
    phase_done("dry-run and roofline")
    for k, n in ranks_phase(dev, snaps_1200, row5, moe_ref, args.scale_row5_ticks).items():
        totals[k] += n
    del snaps_1200, row5, moe_ref
    phase_done("ranks")
    for k, n in examples_phase(dev, smi).items():
        totals[k] += n
    phase_done("examples")

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
