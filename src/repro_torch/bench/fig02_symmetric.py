"""Fig 2: healthy symmetric network — synthetic benchmarks, DC traces and
AI collectives across all load balancers (the reference's
``benchmarks/fig02_symmetric.py``).  The whole figure is one sweep; the
smoke subset keeps the three canonical LBs and the synthetic workloads."""
from repro_torch.bench.common import Rows, ci_cfg, completion_fmt, figure_grid, msg, sweep_case
from repro_torch.bench.common import smoke as smoke_default
from repro_torch.netsim import workloads

LBS = ["ecmp", "ops", "reps", "plb", "flowlet", "mptcp", "mprdma", "bitmap",
       "adaptive_roce"]
SMOKE_LBS = ["ecmp", "ops", "reps"]


def cases(cfg, smoke=None, full=None):
    smoke = smoke_default() if smoke is None else smoke
    n = cfg.n_hosts
    lbs = SMOKE_LBS if smoke else LBS
    wls = {
        "incast8": workloads.incast(n, 8, msg(128, 1024, full)),
        "permutation": workloads.permutation(n, msg(256, 2048, full), seed=1),
        "tornado": workloads.tornado(n, msg(256, 2048, full)),
    }
    out = [
        sweep_case(f"fig02/{wname}/{lbn}", wl, lbn, 4000, cfg)
        for wname, wl in wls.items()
        for lbn in lbs
    ]
    if not smoke:
        # DC traces (websearch) at moderate load
        wsw = workloads.websearch_trace(
            n, load=0.6, duration_ticks=1500, seed=2, max_pkts=cfg.max_msg_pkts
        )
        out += [
            sweep_case(f"fig02/websearch60/{lbn}", wsw, lbn, 4500, cfg)
            for lbn in ["ecmp", "ops", "reps", "plb", "bitmap"]
        ]
        # AI collectives
        out += [
            sweep_case(f"fig02/{cname}/{lbn}", wl, lbn, 12000, cfg)
            for cname, wl in {
                "ring_allreduce": workloads.ring_allreduce(16, msg(128, 1024, full)),
                "butterfly_allreduce": workloads.butterfly_allreduce(16, msg(128, 1024, full)),
                "alltoall_w4": workloads.alltoall(16, msg(16, 64, full), window=4),
            }.items()
            for lbn in ["ecmp", "ops", "reps", "adaptive_roce"]
        ]
    return out


def _fmt(name, s):
    if "/websearch" in name:  # trace cells read better with FCT stats
        return (
            f"completed={s.completed}/{s.n_conns};"
            f"mean_fct={s.mean_fct_ticks:.0f};"
            f"p99_fct={s.p99_fct_ticks:.0f}"
        )
    return completion_fmt(s)


def main(rows=None, full=None, smoke=None, collect=None, device=None):
    rows = rows or Rows()
    cfg = ci_cfg(full)
    figure_grid(rows, "fig02", cfg, cases(cfg, smoke, full), fmt=_fmt, collect=collect,
                device=device)
    return rows
