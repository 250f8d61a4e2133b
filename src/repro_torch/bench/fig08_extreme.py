"""Fig 8: extreme failures — up to 50% of uplinks down; REPS stays close to
ideal while others degrade (the reference's ``benchmarks/fig08_extreme.py``).
The failure-fraction axis only changes the schedule length, so the grid
fuses into one bucket.  The smoke subset drops the middle fraction and the
PLB column."""
from repro_torch.bench.common import Rows, ci_cfg, figure_grid, msg, sweep_case
from repro_torch.bench.common import smoke as smoke_default
from repro_torch.netsim import failures, workloads

LBS = ["ops", "reps", "plb"]
SMOKE_LBS = ["ops", "reps"]


def cases(cfg, smoke=None, full=None):
    """Declarative cell list for the fig08 grid (smoke = CI subset)."""
    smoke = smoke_default() if smoke is None else smoke
    wl = workloads.permutation(cfg.n_hosts, msg(192, 2048, full), seed=5)
    fracs = [0.125, 0.5] if smoke else [0.125, 0.25, 0.5]
    lbs = SMOKE_LBS if smoke else LBS
    out = []
    for frac in fracs:
        fs = failures.random_down_uplinks(cfg, frac, 150, failures.FOREVER, seed=11)
        for lbn in lbs:
            kw = {"freezing_timeout": 800} if lbn == "reps" else {}
            out.append(sweep_case(f"fig08/fail{int(frac * 100)}pct/{lbn}", wl, lbn, 12000, cfg,
                                  failures=fs, **kw))
    return out


def main(rows=None, full=None, smoke=None, collect=None, device=None):
    rows = rows or Rows()
    cfg = ci_cfg(full)
    figure_grid(rows, "fig08", cfg, cases(cfg, smoke, full), collect=collect, device=device)
    return rows
