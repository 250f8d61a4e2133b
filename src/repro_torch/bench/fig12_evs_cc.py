"""Fig 12: EVS-size sensitivity (REPS works with 32 EVs; OPS needs many) and
CC-algorithm sensitivity (DCTCP, EQDS-like, delay-based); the reference's
``benchmarks/fig12_evs_cc.py``, one ``Simulator`` per cell."""
from repro_torch.bench.common import Rows, ci_cfg, completion_row, lb_for, msg, run_one
from repro_torch.netsim import workloads

LBS = ["ops", "reps"]
EVS = [32, 256, 65536]
CCS = ["dctcp", "eqds", "delay"]


def main(rows=None, full=None, smoke=None, collect=None, device=None):
    rows = rows or Rows()
    wl_msg = msg(256, 2048, full)
    for evs in EVS:
        cfg = ci_cfg(full, evs_size=evs)
        wl = workloads.permutation(cfg.n_hosts, wl_msg, seed=3)
        for lbn in LBS:
            _, _, _, s, wall = run_one(cfg, wl, lb_for(cfg, lbn, evs_size=evs), 5000,
                                       device=device)
            completion_row(rows, f"fig12/evs{evs}/{lbn}", s, wall)
    for cc in CCS:
        cfg = ci_cfg(full, cc=cc)
        wl = workloads.permutation(cfg.n_hosts, wl_msg, seed=3)
        for lbn in LBS:
            _, _, _, s, wall = run_one(cfg, wl, lb_for(cfg, lbn), 5000, device=device)
            completion_row(rows, f"fig12/cc_{cc}/{lbn}", s, wall)
    return rows
