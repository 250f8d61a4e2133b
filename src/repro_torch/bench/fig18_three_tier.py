"""Fig 18 (Appendix D.2): a 3-tier fat tree; REPS performs as on the 2-tier
one (one EV steers two choice hops).  The reference's
``benchmarks/fig18_three_tier.py``, one ``Simulator`` per LB."""
from repro_torch.bench.common import Rows, completion_row, full_scale, lb_for, msg, run_one
from repro_torch.netsim import SimConfig, workloads

LBS = ["ecmp", "ops", "reps"]
TICKS = 6000


def config(full=None) -> SimConfig:
    if full_scale() if full is None else full:
        return SimConfig(n_hosts=128, hosts_per_tor=16, tiers=3, tors_per_pod=2,
                         aggs_per_pod=4, agg_uplinks=4)
    return SimConfig(
        n_hosts=64, hosts_per_tor=8, tiers=3, tors_per_pod=2, aggs_per_pod=4,
        agg_uplinks=4, evs_size=256, queue_capacity=64, init_cwnd_pkts=50,
        max_cwnd_pkts=100, rto_ticks=600, max_msg_pkts=1024,
    )


def main(rows=None, full=None, smoke=None, collect=None, device=None):
    rows = rows or Rows()
    cfg = config(full)
    wl = workloads.permutation(cfg.n_hosts, msg(256, 2048, full), seed=3)
    for lbn in LBS:
        _, _, _, s, wall = run_one(cfg, wl, lb_for(cfg, lbn), TICKS, device=device)
        completion_row(rows, f"fig18/3tier/{lbn}", s, wall, ticks=TICKS)
    return rows
