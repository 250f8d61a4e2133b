"""Fig 19 (Appendix D.3): staggered permanent failures of all but one uplink
of one ToR; REPS freezes again after each probe, OPS collapses (the
reference's ``benchmarks/fig19_incremental.py``, one ``Simulator`` per
LB)."""
from repro_torch.bench.common import Rows, ci_cfg, completion_row, lb_for, msg, run_one
from repro_torch.netsim import failures, workloads

LBS = ["ops", "reps"]


def main(rows=None, full=None, smoke=None, collect=None, device=None):
    rows = rows or Rows()
    cfg = ci_cfg(full)
    fs = failures.incremental_uplink_failures(
        cfg, tor=0, n_fail=cfg.uplinks_per_tor - 1, first_start=200, interval=500)
    wl = workloads.permutation(cfg.n_hosts, msg(512, 4096, full), seed=5)
    for lbn in LBS:
        kw = {"freezing_timeout": 800} if lbn == "reps" else {}
        _, _, _, s, wall = run_one(cfg, wl, lb_for(cfg, lbn, **kw), 15000, fs, device=device)
        completion_row(rows, f"fig19/{lbn}", s, wall)
    return rows
