"""Fig 5: coexistence — REPS foreground with ECMP background traffic
(incremental deployment; the reference's ``benchmarks/fig05_background.py``).
Both mixed-cohort cells ride one bucket (``make_lb("mixed", ...)`` behind a
``SwitchLB``); cohort FCTs come from each cell's final ``c_done_tick``."""
import numpy as np

from repro_torch.bench.common import Rows, ci_cfg, figure_grid, msg, sweep_case
from repro_torch.netsim import workloads


def _workload(cfg, full=None):
    return workloads.permutation_with_background(cfg.n_hosts, msg(256, 2048, full), 0.1, seed=1)


def cases(cfg, smoke=None, full=None):
    wl, bg = _workload(cfg, full)
    bg_conns = tuple(int(i) for i in np.nonzero(bg)[0])
    return [
        sweep_case(f"fig05/{fg}+ecmp_bg", wl, "mixed", 5000, cfg,
                   fg=fg, bg="ecmp", bg_conns=bg_conns)
        for fg in ["ops", "reps"]
    ]


def main(rows=None, full=None, smoke=None, collect=None, device=None):
    rows = rows or Rows()
    cfg = ci_cfg(full)
    wl, bg = _workload(cfg, full)

    def derive(case, s, st):
        done_tick = np.asarray(st.c_done_tick)[: wl.n_conns]
        fg_fct = done_tick[~bg & (done_tick > 0)].max() if (~bg).any() else -1
        bg_fct = done_tick[bg & (done_tick > 0)].max() if bg.any() else -1
        return f"fg_runtime={fg_fct};bg_runtime={bg_fct};completed={s.completed}/{s.n_conns}"

    figure_grid(rows, "fig05", cfg, cases(cfg, smoke, full), derive=derive, collect=collect,
                device=device)
    return rows
