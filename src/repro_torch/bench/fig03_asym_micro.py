"""Fig 3: asymmetric micro — one ToR uplink degraded to half rate; REPS
skews selection away from the slow link, OPS stays uniform (the
reference's ``benchmarks/fig03_asym_micro.py``).  The slow-link share is
derived from each cell's final ``q_served``."""
import numpy as np

from repro_torch.bench.common import Rows, ci_cfg, figure_grid, msg, sweep_case
from repro_torch.netsim import Topology, failures, workloads


def cases(cfg, smoke=None, full=None):
    topo = Topology.build(cfg)
    slow = int(topo.t0_up_queues(0)[0])
    fs = failures.link_degraded([slow], 0, failures.FOREVER)
    wl = workloads.permutation(cfg.n_hosts, msg(256, 2048, full), seed=3)
    watch = topo.t0_up_queues(0)
    return [
        sweep_case(f"fig03/{lbn}", wl, lbn, 4000, cfg, failures=fs, watch=watch)
        for lbn in ["ops", "reps"]
    ]


def main(rows=None, full=None, smoke=None, collect=None, device=None):
    rows = rows or Rows()
    cfg = ci_cfg(full)
    watch = Topology.build(cfg).t0_up_queues(0)

    def derive(case, s, st):
        served = np.asarray(st.q_served)[watch]
        share = served[0] / max(served.sum(), 1)
        return (
            f"runtime={s.runtime_ticks};slow_link_share={share:.3f};"
            f"uniform_share={1 / len(watch):.3f}"
        )

    figure_grid(rows, "fig03", cfg, cases(cfg, smoke, full), derive=derive, collect=collect,
                device=device)
    return rows
