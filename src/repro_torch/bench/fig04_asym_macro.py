"""Fig 4: asymmetric macro — ~2% of ToR uplinks degraded; synthetic and
collective workloads across load balancers (the reference's
``benchmarks/fig04_asym_macro.py``).  Adaptive RoCE buckets apart (in-network
routing is a static property); the smoke subset keeps the canonical LBs on
the synthetic workloads."""
from repro_torch.bench.common import Rows, ci_cfg, figure_grid, msg, sweep_case
from repro_torch.bench.common import smoke as smoke_default
from repro_torch.netsim import failures, workloads

LBS = ["ecmp", "ops", "reps", "plb", "bitmap", "adaptive_roce"]
SMOKE_LBS = ["ecmp", "ops", "reps"]


def cases(cfg, smoke=None, full=None):
    """Declarative cell list for the fig04 grid (smoke = CI subset)."""
    smoke = smoke_default() if smoke is None else smoke
    fs = failures.random_degraded_uplinks(cfg, 0.03, seed=4)
    n = cfg.n_hosts
    lbs = SMOKE_LBS if smoke else LBS
    out = [
        sweep_case(f"fig04/{wname}/{lbn}", wl, lbn, 5000, cfg, failures=fs)
        for wname, wl in {
            "permutation": workloads.permutation(n, msg(256, 2048, full), seed=1),
            "tornado": workloads.tornado(n, msg(256, 2048, full)),
        }.items()
        for lbn in lbs
    ]
    if not smoke:
        wl = workloads.ring_allreduce(16, msg(128, 1024, full))
        out += [
            sweep_case(f"fig04/ring_allreduce/{lbn}", wl, lbn, 14000, cfg, failures=fs)
            for lbn in ["ops", "reps", "bitmap"]
        ]
    return out


def main(rows=None, full=None, smoke=None, collect=None, device=None):
    rows = rows or Rows()
    cfg = ci_cfg(full)
    figure_grid(rows, "fig04", cfg, cases(cfg, smoke, full), collect=collect, device=device)
    return rows
