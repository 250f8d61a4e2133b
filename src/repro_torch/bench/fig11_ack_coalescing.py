"""Fig 11: ACK coalescing ratios; REPS keeps its advantage up to 8:1, and
under asymmetry even at 16:1 (the reference's
``benchmarks/fig11_ack_coalescing.py``, one ``Simulator`` per cell)."""
from repro_torch.bench.common import Rows, ci_cfg, completion_row, lb_for, msg, run_one
from repro_torch.netsim import Topology, failures, workloads

LBS = ["ops", "reps"]
RATIOS = [1, 2, 4, 8, 16]


def main(rows=None, full=None, smoke=None, collect=None, device=None):
    rows = rows or Rows()
    wl_msg = msg(256, 2048, full)
    for ratio in RATIOS:
        cfg = ci_cfg(full, ack_coalesce=ratio)
        wl = workloads.permutation(cfg.n_hosts, wl_msg, seed=3)
        for lbn in LBS:
            _, _, _, s, wall = run_one(cfg, wl, lb_for(cfg, lbn), 5000, device=device)
            completion_row(rows, f"fig11/sym/c{ratio}/{lbn}", s, wall)
    # the asymmetric variant at the extreme ratio
    cfg = ci_cfg(full, ack_coalesce=16)
    fs = failures.link_degraded(Topology.build(cfg).t0_up_queues(0)[:1], 0, 2**30)
    wl = workloads.permutation(cfg.n_hosts, wl_msg, seed=3)
    for lbn in LBS:
        _, _, _, s, wall = run_one(cfg, wl, lb_for(cfg, lbn), 6000, fs, device=device)
        completion_row(rows, f"fig11/asym/c16/{lbn}", s, wall)
    return rows
