"""Shared helpers of the port's figure grids (counterpart of the
reference's ``benchmarks/common.py``): ``Rows``, ``ci_cfg``, ``msg``,
``sweep_case``, ``run_sweep``, ``sweep_rows`` and ``figure_grid``.

Rows are ``(name, us_per_call, derived)`` plus a structured record per row
(``Rows.records``) that ``repro_torch.bench.run`` writes to its BENCH file.
A figure runs as one sweep submission: the packer fuses near-identical
cell shapes and tick horizons into a few buckets, each one tick loop over
its rows on the device.  Each row's ``us_per_call`` is its bucket's wall
time split over the bucket's cells; nothing is compiled, so there is no
compile time to exclude.

The settings are the reference's environment variables, read at call time
unless passed explicitly: ``BENCH_FULL`` (paper scale: FATTREE_128's
fabric and MiB messages), ``BENCH_SEEDS`` (seeds per cell), ``BENCH_SMOKE``
(a figure's CI subset) and ``BENCH_COLLECT`` (``"summary"``, ``"none"`` or
``"full"``).
"""
from __future__ import annotations

import os

from repro_torch.netsim import SimConfig, SweepCase, SweepEngine
from repro_torch.netsim.sweep import measured_costs_from_bench

COLLECTS = ("none", "summary", "full")


def full_scale() -> bool:
    return bool(int(os.environ.get("BENCH_FULL", "0")))


def n_seeds() -> int:
    return max(1, int(os.environ.get("BENCH_SEEDS", "1")))


def smoke() -> bool:
    return bool(int(os.environ.get("BENCH_SMOKE", "0")))


def default_collect() -> str:
    collect = os.environ.get("BENCH_COLLECT", "summary")
    if collect not in COLLECTS:
        raise ValueError(f"BENCH_COLLECT must be one of {COLLECTS}, got {collect!r}")
    return collect


def ci_cfg(full: bool | None = None, **kw) -> SimConfig:
    """The grids' fabric: 64 hosts at CI scale; at paper scale
    FATTREE_128's (128 hosts, 16 uplinks per ToR, queue 85, RTO 854 ticks,
    65536 EVs)."""
    if full_scale() if full is None else full:
        base = dict(
            n_hosts=128, hosts_per_tor=16, uplinks_per_tor=16, evs_size=65536,
            queue_capacity=85, init_cwnd_pkts=85, max_cwnd_pkts=170,
            rto_ticks=854, max_msg_pkts=4096,
        )
    else:
        base = dict(
            n_hosts=64, hosts_per_tor=8, uplinks_per_tor=8, evs_size=256,
            queue_capacity=64, init_cwnd_pkts=50, max_cwnd_pkts=100,
            rto_ticks=500, max_msg_pkts=1024,
        )
    base.update(kw)
    return SimConfig(**base)


def msg(pkts_ci: int, pkts_full: int, full: bool | None = None) -> int:
    return pkts_full if (full_scale() if full is None else full) else pkts_ci


def sweep_case(name, wl, lbn, ticks, cfg, failures=None, watch=None, seeds=None,
               **lb_kwargs) -> SweepCase:
    """A SweepCase with the harness defaults: cfg-derived evs_size and the
    BENCH_SEEDS seed axis."""
    lb_kwargs.setdefault("evs_size", cfg.evs_size)
    return SweepCase(
        name=name, workload=wl, lb=lbn, ticks=ticks, lb_kwargs=lb_kwargs,
        failures=failures, watch_queues=watch,
        seeds=tuple(range(n_seeds())) if seeds is None else tuple(seeds),
    )


def bench_path() -> str:
    """The port's BENCH file, ``build/repro_torch/BENCH_torch.json`` at the
    repository root (never the reference's ``benchmarks/BENCH_netsim.json``)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    return os.path.join(root, "build", "repro_torch", "BENCH_torch.json")


def measured_costs() -> dict:
    """The packer's measured-cost feedback, from the port's own BENCH file's
    bucket rows when BENCH_MEASURED_COSTS=1 (else ``{}``: the footprint
    estimate)."""
    if not bool(int(os.environ.get("BENCH_MEASURED_COSTS", "0"))):
        return {}
    return measured_costs_from_bench(bench_path())


def run_sweep(cfg, cases, packer=None, collect=None, device=None, trace=None):
    """Submit a whole figure as one sweep.  ``collect`` defaults to
    BENCH_COLLECT; "none" and "summary" stop at quiescence (early exit;
    reported metrics are bit-identical to the full horizon), "full" keeps
    raw trace streams and runs every tick.  ``trace`` (a ``TraceSpec``,
    summary mode) also carries the flight recorder."""
    collect = collect or default_collect()
    eng = SweepEngine(cfg, cases, packer=packer, measured_costs=measured_costs(), device=device)
    res = eng.run(collect=collect, early_exit=collect != "full", trace=trace)
    return eng, res


def completion_fmt(s) -> str:
    return (
        f"runtime_ticks={s.runtime_ticks};completed={s.completed}/{s.n_conns};"
        f"drops={s.drops_cong}+{s.drops_fail};timeouts={s.timeouts}"
    )


def sweep_rows(rows, res, fmt=None, derive=None, collect=None, derive_res=None):
    """Emit one row per sweep cell (seed-0 metrics == the serial run).

    ``fmt(name, summary) -> str`` picks the derived string per cell
    (default: completion format); ``derive(case, summary, state) -> str``
    overrides it when the string needs the cell's final state;
    ``derive_res(case, summary, res) -> str`` when it needs the whole sweep
    result.  A cell's us_per_call is its bucket's wall split evenly over
    the bucket's cells; ticks_per_sec is bucket-aggregate (rows x ticks run
    over the bucket's wall)."""
    sums = res.summaries()
    for b in res.buckets:
        share_us = b.exec_wall_s / max(len(b.cells), 1) * 1e6
        tps = b.ticks_run * b.n_rows / max(b.exec_wall_s, 1e-9)
        for c in b.cells:
            s = sums[c.case.name][0]
            if derive_res is not None:
                d = derive_res(c.case, s, res)
            elif derive is not None:
                d = derive(c.case, s, res.state_for(c.case.name))
            elif fmt is not None:
                d = fmt(c.case.name, s)
            else:
                d = completion_fmt(s)
            rows.add(
                c.case.name, share_us, d,
                ticks=b.ticks, ticks_run=b.ticks_run, n_runs=len(c.case.seeds),
                ticks_per_sec=tps, bucket_rows=b.n_rows, bucket_wall_s=b.exec_wall_s,
                collect=collect or default_collect(),
            )
    return sums


def figure_grid(rows, fig, cfg, cases, fmt=None, derive=None, packer=None, collect=None,
                derive_res=None, device=None, trace=None):
    """Run a declarative figure grid (a list of SweepCases) as one sweep
    submission and emit its rows, one ``{fig}/bucket/*`` row per bucket
    (its PackPlan key beside the measured bucket_ticks_per_sec and
    measured_row_tick_us, the packer's measured-cost feedback) and a
    ``{fig}/sweep_total`` row.  Returns ``(engine, result)``."""
    collect = collect or default_collect()
    eng, res = run_sweep(cfg, cases, packer=packer, collect=collect, device=device, trace=trace)
    sweep_rows(rows, res, fmt=fmt, derive=derive, collect=collect, derive_res=derive_res)
    plan = eng.plan
    for i, b in enumerate(res.buckets):
        t, ad, nc, msg_, f, w = b.plan.key
        wall = max(b.exec_wall_s, 1e-9)
        rows.add(
            f"{fig}/bucket/g{b.plan.group}.{i}", b.exec_wall_s * 1e6,
            f"key=t{t}.ad{int(ad)}.nc{nc}.msg{msg_}.f{f}.w{w};"
            f"rows={b.n_rows}+{b.plan.pad_rows}pad;cells={len(b.cells)};"
            f"ticks_run={b.ticks_run}",
            bucket_key=list(b.plan.key),
            bucket_group=b.plan.group,
            ticks_run=b.ticks_run,
            bucket_rows=b.n_rows,
            padded_rows=b.plan.n_padded_rows,
            bucket_ticks_per_sec=b.ticks_run * b.n_rows / wall,
            measured_row_tick_us=wall * 1e6 / max(b.ticks_run * b.plan.n_padded_rows, 1),
            est_row_tick_cost=b.plan.est_row_cost / max(b.plan.ticks, 1),
            collect=collect,
        )
    agg_ticks = sum(b.ticks_run * b.n_rows for b in res.buckets)
    rows.add(
        f"{fig}/sweep_total", res.exec_wall_s * 1e6,
        f"cells={len(cases)};buckets={len(res.buckets)};"
        f"programs={plan.n_groups};rows={plan.n_rows};"
        f"merge_waste={plan.merge_waste:.3f};collect={collect}",
        ticks_per_sec=agg_ticks / max(res.exec_wall_s, 1e-9),
        compile_wall_s=res.compile_wall_s,
        buckets=len(res.buckets),
        collect=collect,
    )
    return eng, res


class Rows:
    """Benchmark rows, each printed as a CSV line when added; every record
    carries the run context it was produced under (``context``: seeds,
    full_scale, smoke, device), so that merged BENCH files stay
    attributable row by row."""

    def __init__(self, **context):
        self.rows: list[tuple[str, float, str]] = []
        self.records: list[dict] = []
        self.context = {"seeds": n_seeds(), "full_scale": full_scale(), "smoke": smoke(),
                        "collect": default_collect(), **context}

    def add(self, name: str, us: float, derived: str, **extra):
        self.rows.append((name, us, derived))
        self.records.append({"name": name, "us_per_call": us, "derived": derived,
                             **self.context, **extra})
        print(f"{name},{us:.0f},{derived}", flush=True)
