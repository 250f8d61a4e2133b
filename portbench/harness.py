"""One run of one cell: set-up, the measured window, the traced sub-window,
and the comparison with the plain reference.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``
(configuration, traffic, metrics), ``workloads/<cell>.json`` (how the run
drives it), ``configs/<config>.json`` (the fabric), ``traffic/<traffic>.json``
(the generator's parameters) and ``metrics/<metric>.py`` (one reader each).
The device is a parameter, so the tests drive the same path on the CPU at a
tiny size.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import time
from pathlib import Path

import numpy as np
import torch

from portbench import check, generator, roofline, trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


@dataclasses.dataclass
class Cell:
    name: str
    fabric: dict
    traffic: dict
    run: dict  # chunk, warmup_chunks, sample_rows, trace_ticks
    end_to_end: list
    per_layer: list


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` as ``BENCHMARK.json`` and its files define it."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")
    cfg = load_json(HERE / "configs" / f"{entry['config']}.json")
    mine = lambda m: name in m.get("workloads", [name])
    return Cell(
        name=name, fabric=cfg["fabric"],
        traffic=load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        run=load_json(HERE / "workloads" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if mine(m)],
        per_layer=[m for m in bench["per_layer"] if mine(m)],
    )


def reader(metric: str):
    """The ``read(run)`` of ``metrics/<metric>.py`` (a name may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}",
                                                  HERE / "metrics" / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class SweepProgram:
    """The system under test: the port's ``SweepEngine`` over one batch, a
    single bucket, driven chunk by chunk as ``SweepEngine.run`` drives it
    with ``early_exit`` (``bucket_carry``, ``run_chunk``, the quiescence
    check at each chunk boundary)."""

    def __init__(self, fabric: dict, batch: generator.Batch, device):
        from repro_torch.netsim import PackerConfig, SimConfig, SweepCase, SweepEngine
        from repro_torch.netsim.engine import FailureSchedule, Workload

        cfg = SimConfig(**fabric)
        wl = Workload(batch.src, batch.dst, batch.msg_pkts, batch.start, batch.dep, batch.name)
        fs = FailureSchedule(batch.f_queue, batch.f_start, batch.f_end, batch.f_kind)
        seeds = [[s for b, s in batch.rows if b == i] for i in range(len(batch.lbs))]
        cases = [SweepCase(f"{name}/{i}", wl, name, ticks=batch.horizon, lb_kwargs=kw,
                           failures=fs, watch_queues=batch.watch, seeds=tuple(seeds[i]))
                 for i, (name, kw) in enumerate(batch.lbs)]
        self.collect = batch.collect
        # the packer's row threshold is the batch's rows, so that the grid is
        # one bucket, as a user whose card holds it would ask
        self.eng = SweepEngine(cfg, cases, devices=None, measured_costs={}, device=device,
                               packer=PackerConfig(max_rows_per_bucket=len(batch.rows)))
        if len(self.eng.buckets) != 1:
            raise ValueError(f"a cell is one bucket; the packer made {len(self.eng.buckets)}")
        self.bucket = self.eng.buckets[0]
        # batch row (lb i, its j-th seed) -> the bucket's row
        by_case = {c.case.name: c.rows for c in self.bucket.cells}
        self.row_of = [by_case[cases[b].name][seeds[b].index(s)] for b, s in batch.rows]
        self._quiet = self.eng._quiescent(self.bucket.program)

    def carry0(self):
        return self.eng.bucket_carry(self.bucket, self.collect)

    def step(self, carry, t0: int, n: int):
        return self.eng.run_chunk(self.bucket, carry, t0, n, self.collect)[0]

    def quiescent(self, carry, t: int) -> bool:
        states = carry[0] if self.collect == "summary" else carry
        return self._quiet(states, self.bucket.scn, self.bucket.horizons_t, t)

    def take_rows(self, carry, rows):
        idx = torch.as_tensor([self.row_of[r] for r in rows], device=self.eng.device)
        states, tel = carry if self.collect == "summary" else (carry, None)
        pick = lambda x: x.index_select(0, idx).cpu()
        from repro_torch.tree import tree_map
        return tree_map(pick, states), (pick(tel) if tel is not None else None)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Run:
    """The state of one run that the metric readers see."""

    def __init__(self, cell: Cell, traced: bool, device):
        self.cell, self.traced = cell, traced
        self.device = torch.device(device)
        self.setup_s = self.init_rows_s = self.window_s = None
        self.row_ticks = 0
        self.ticks = 0
        self.batches_done = 0
        self.peak_bytes = None
        self.prof = None  # the traced sub-window's reduction
        self.verify_s = None
        self.checks = {}
        self.attempted = self.failed = 0


def _profile_chunk(run: Run, prog, carry, t: int, n: int):
    """One chunk of ``n`` ticks under ``torch.profiler``, with the engine
    kernels' exact launch counters and the call shapes of the roofline's
    operations; returns the new carry and the reduction."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    before = ops.launch_counts()
    with roofline.CallRecorder(ops) as rec:
        _sync(run.device)
        acts = [ProfilerActivity.CUDA if run.device.type == "cuda" else ProfilerActivity.CPU]
        with profile(activities=acts) as prof:
            h0 = time.perf_counter()
            carry = prog.step(carry, t, n)
            _sync(run.device)
            h1 = time.perf_counter()
    after = ops.launch_counts()
    red = trace.reduce(trace.device_events(prof), h1 - h0)
    red.update(ticks=n, op_bytes=dict(rec.bytes),
               counter_delta={k: after[k] - before[k] for k in after})
    red["mismatch"] = trace.launch_mismatch(red, red["counter_delta"])
    return carry, red


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
             program=SweepProgram, log=print) -> Run:
    """Set-up, window and comparison of one run.  ``program`` builds the
    system under test from ``(fabric, batch, device)``."""
    run = Run(cell, traced, device)
    chunk = int(cell.run["chunk"])
    batch_no = 0
    batch = generator.make_batch(cell.fabric, cell.traffic, seed, batch_no)
    prog = program(cell.fabric, batch, run.device)
    _sync(run.device)
    t0 = time.perf_counter()
    carry = prog.carry0()
    _sync(run.device)
    run.init_rows_s = time.perf_counter() - t0
    n_rows = len(batch.rows)
    t = 0
    for _ in range(int(cell.run["warmup_chunks"])):
        carry = prog.step(carry, t, chunk)
        t += chunk
        prog.quiescent(carry, t)
    _sync(run.device)
    run.setup_s = time.perf_counter() - t_start

    # the window: chunks until `seconds` have passed; a batch that reaches
    # its fixed point or its horizon is followed by the next one
    done = []  # the last finished batch: (batch, ticks, sample, its rows, ended early)
    n_prof = int(cell.run.get("trace_ticks", chunk))
    w0 = time.perf_counter()
    elapsed = 0.0
    while elapsed < seconds or (traced and run.prof is None):
        n = min(chunk, batch.horizon - t)
        want_prof = run.prof is None or run.prof["mismatch"]
        profiled = traced and elapsed >= seconds / 2 and want_prof and n_prof >= 1
        if profiled:
            # once started, the profiler slows the launches of the rest of the
            # process, so the idle share is read against the window's ticks
            # before it first ran
            unprofiled = (run.prof or {}).get("unprofiled_s_per_tick") or (
                elapsed / run.ticks if run.ticks else None)
            n = min(n, n_prof)
            carry, run.prof = _profile_chunk(run, prog, carry, t, n)
            run.prof.update(rows=n_rows, unprofiled_s_per_tick=unprofiled)
            if run.prof["mismatch"]:
                log(f"portbench: the profiler's counts {run.prof['mismatch']} disagree with "
                    f"the launch counters over {n} ticks; shortening the sub-window")
                n_prof = n // 2
        else:
            carry = prog.step(carry, t, n)
        t += n
        run.row_ticks += n_rows * n
        run.ticks += n
        end = t >= batch.horizon or prog.quiescent(carry, t)
        _sync(run.device)
        elapsed = time.perf_counter() - w0
        if end:
            sample = generator.sample_rows(n_rows, int(cell.run["sample_rows"]), seed, batch_no)
            done = [(batch, t, sample, prog.take_rows(carry, sample), t < batch.horizon)]
            del prog, carry
            batch_no += 1
            run.batches_done += 1
            batch = generator.make_batch(cell.fabric, cell.traffic, seed, batch_no)
            prog = program(cell.fabric, batch, run.device)
            carry = prog.carry0()
            t = 0
    _sync(run.device)
    run.window_s = time.perf_counter() - w0
    if run.device.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated()
    sample = generator.sample_rows(n_rows, int(cell.run["sample_rows"]), seed, batch_no)
    if t > 0:
        done.append((batch, t, sample, prog.take_rows(carry, sample), False))
    del prog, carry
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    v0 = time.perf_counter()
    verify(run, done)
    run.verify_s = time.perf_counter() - v0
    return run


def verify(run: Run, batches) -> None:
    """Replay each batch's sampled rows with the plain reference up to the
    tick the program reached, and count what differs."""
    from portbench import reference

    totals = {k: 0 for k in check.LIMITS}
    for batch, ticks, sample, got, early in batches:
        ref = reference.Rows(run.cell.fabric, batch, sample, run.device)
        carry = ref.step(ref.carry0(), 0, ticks)
        diffs = check.compare(got, ref.take_rows(carry, list(range(len(sample)))))
        if early:  # the program stopped here: each row must be at its fixed point
            diffs["quiescence_diff"] = (~ref.quiet_rows(carry, ticks)).astype(np.int64)
        bad = np.zeros(len(sample), bool)
        for k, v in diffs.items():
            totals[k] += int(v.sum())
            bad |= v > 0
        run.attempted += len(sample)
        run.failed += int(bad.sum())
        del ref, carry
    run.checks = totals


def result(run: Run) -> dict:
    """The contract's last line: metrics of the run's kind, the device, the
    breakdown of a traced run and, last, each compared number and its limit."""
    metrics = {}
    for m in run.cell.per_layer if run.traced else run.cell.end_to_end:
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    cuda = run.device.type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name() if cuda else "cpu",
              "count": 1, "memory_peak_bytes": run.peak_bytes}
    within = all(v <= check.LIMITS[k] for k, v in run.checks.items())
    out = {"correct": run.attempted > 0 and run.failed == 0 and within,
           "attempted": run.attempted, "failed": run.failed, "metrics": metrics, "device": device}
    if run.traced and run.prof is not None:
        device.update(busy_s=run.prof["busy_s"], window_s=run.prof["window_s"])
        out["breakdown"] = {"device_ops": run.prof["device_ops"],
                            "idle_gaps": run.prof["idle_gaps"]}
    out["checks"] = {k: {"value": v, "limit": check.LIMITS[k]} for k, v in run.checks.items()}
    return out
