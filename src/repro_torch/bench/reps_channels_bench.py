"""Beyond-paper: REPS as the cross-pod gradient-channel scheduler
(``repro_torch.ft.reps_channels``) against oblivious assignment, under
channel failures and degradation; the reference's
``benchmarks/reps_channels_bench.py``.

    python -m repro_torch.bench.run --only reps_channels [--device cpu]
"""
import time

from repro_torch.bench.common import Rows
from repro_torch.ft import (
    ChannelSim,
    ChannelSimConfig,
    OpsChannelScheduler,
    RepsChannelScheduler,
    run_cross_pod_reduce,
)

# (name, setup of the channel pool)
SCENARIOS = (
    ("healthy", lambda sim: None),
    ("fail6of16", lambda sim: sim.set_failed(range(6))),
    ("degraded4", lambda sim: sim.set_degraded(range(4))),
)


def run_scenario(name: str, scheduler: str, device=None):
    """One cell: 256 chunks in rounds of 32 over 16 channels (seed 0).
    Returns ``(report, scheduler, seconds)``."""
    setup = dict(SCENARIOS)[name]
    sim = ChannelSim(ChannelSimConfig(n_channels=16), seed=0)
    setup(sim)
    sched = (OpsChannelScheduler(16, seed=0) if scheduler == "ops"
             else RepsChannelScheduler(16, seed=0, device=device))
    t0 = time.time()
    rep = run_cross_pod_reduce(sched, sim, n_chunks_total=256, chunks_per_round=32)
    return rep, sched, time.time() - t0


def main(rows=None, full=None, smoke=None, collect=None, device=None):
    rows = rows or Rows()
    for name, _ in SCENARIOS:
        for sname in ("ops", "reps"):
            rep, _, secs = run_scenario(name, sname, device)
            rows.add(
                f"reps_channels/{name}/{sname}", secs * 1e6,
                f"makespan_us={rep.total_latency_us:.0f};rounds={rep.rounds};"
                f"timeouts={rep.timeouts};p99_us={rep.p99_chunk_latency_us:.0f}",
            )
    return rows
