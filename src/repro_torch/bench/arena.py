"""LB arena: every registered load balancer head to head, on one
``figure_grid`` submission (the reference's ``benchmarks/arena.py``).

Three workload blocks x all LBs:

  * symmetric: permutation traffic, the paper's §4.2 baseline regime;
  * asymmetric: incast fan-in, persistent congestion at one downlink;
  * failure: permutation under randomly downed uplinks (§5 recovery).

Per-cell columns: completion, FCT p99 and failure-recovery latency from the
on-device telemetry (``recovery_us`` is NaN on the failure-free blocks, and
"-" when collect != "summary": no sketches exist).  The smoke subset
shrinks horizons and drops the asymmetric block; the LB columns always
cover the whole registry.
"""
from repro_torch.bench.common import Rows, ci_cfg, figure_grid, msg, sweep_case
from repro_torch.bench.common import smoke as smoke_default
from repro_torch.core.load_balancers import REGISTRY
from repro_torch.netsim import failures, workloads

# every registered single-LB contender ("mixed" needs cohort kwargs and is a
# composition, not a contender), in registry order for stable columns
ARENA_LBS = [n for n in REGISTRY if n != "mixed"]

LB_KW = {"reps": {"freezing_timeout": 800}}


def cases(cfg, smoke=None, full=None):
    """Declarative cell list of the arena grid (smoke = CI subset)."""
    smoke = smoke_default() if smoke is None else smoke
    n = cfg.n_hosts
    fs = failures.random_down_uplinks(cfg, 0.05, 150, failures.FOREVER, seed=7)
    blocks = [
        ("symmetric", workloads.permutation(n, msg(192, 1024, full), seed=1),
         2500 if smoke else 8000, None),
        ("failure", workloads.permutation(n, msg(192, 1024, full), seed=3),
         3000 if smoke else 9000, fs),
    ]
    if not smoke:
        blocks.insert(1, ("asymmetric", workloads.incast(n, 8, msg(192, 1024, full)), 9000,
                          None))
    return [
        sweep_case(f"arena/{wname}/{lbn}", wl, lbn, ticks, cfg, failures=f,
                   **LB_KW.get(lbn, {}))
        for wname, wl, ticks, f in blocks
        for lbn in ARENA_LBS
    ]


def derive(case, s, res):
    """Completion and sketch columns: FCT p99 and recovery latency."""
    try:
        rec = res.telemetry_for(case.name).get("recovery")
        rec_us = f"{rec['recovery_us']:.1f}" if rec else "-"
    except ValueError:  # collect != "summary": no sketches were reduced
        rec_us = "-"
    return (
        f"completed={s.completed}/{s.n_conns};p99_fct={s.p99_fct_ticks:.0f};"
        f"recovery_us={rec_us};timeouts={s.timeouts}"
    )


def main(rows=None, full=None, smoke=None, collect=None, device=None):
    rows = rows or Rows()
    cfg = ci_cfg(full)
    figure_grid(rows, "arena", cfg, cases(cfg, smoke, full), derive_res=derive,
                collect=collect, device=device)
    return rows
