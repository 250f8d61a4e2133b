"""Fig 7: failure modes macro — persistent partial failures during
permutation / DC traces / ring AllReduce (the reference's
``benchmarks/fig07_failures_macro.py``).  The workload blocks have
different conn counts *and* tick horizons, so they bucket apart unless the
packer can fuse them under the waste budget (horizon-merged rows freeze at
their own horizon).  The smoke subset drops the websearch block."""
from repro_torch.bench.common import Rows, ci_cfg, figure_grid, msg, sweep_case
from repro_torch.bench.common import smoke as smoke_default
from repro_torch.netsim import failures, workloads

LBS = ["ops", "reps", "plb"]
SMOKE_LBS = ["ops", "reps"]


def cases(cfg, smoke=None, full=None):
    """Declarative cell list for the fig07 grid (smoke = CI subset)."""
    smoke = smoke_default() if smoke is None else smoke
    fs = failures.random_down_uplinks(cfg, 0.05, 150, failures.FOREVER, seed=7)
    n = cfg.n_hosts
    lbs = SMOKE_LBS if smoke else LBS
    blocks = [
        ("permutation", workloads.permutation(n, msg(256, 2048, full), seed=1), 8000),
        ("ring_allreduce", workloads.ring_allreduce(16, msg(96, 1024, full)), 16000),
    ]
    if not smoke:
        blocks.insert(1, (
            "websearch100",
            workloads.websearch_trace(n, 0.9, 1200, seed=2, max_pkts=cfg.max_msg_pkts),
            6000,
        ))
    out = []
    for wname, wl, ticks in blocks:
        for lbn in lbs:
            kw = {"freezing_timeout": 800} if lbn == "reps" else {}
            out.append(sweep_case(f"fig07/{wname}/{lbn}", wl, lbn, ticks, cfg, failures=fs, **kw))
    return out


def main(rows=None, full=None, smoke=None, collect=None, device=None):
    rows = rows or Rows()
    cfg = ci_cfg(full)
    figure_grid(rows, "fig07", cfg, cases(cfg, smoke, full), collect=collect, device=device)
    return rows
