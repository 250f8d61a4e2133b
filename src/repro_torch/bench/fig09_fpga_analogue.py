"""Figs 9/10 (FPGA testbed), the simulated analogue at the same scale: 16
endpoints on 2 ToRs, aggregate goodput under asymmetry (one uplink at half
rate), and packet drops under a mid-run link failure.  The reference's
``benchmarks/fig09_fpga_analogue.py``, one ``Simulator`` per cell."""
from repro_torch.bench.common import Rows, ci_cfg, lb_for, msg, run_one
from repro_torch.netsim import Topology, failures, workloads

LBS = ["ops", "reps"]


def main(rows=None, full=None, smoke=None, collect=None, device=None):
    rows = rows or Rows()
    cfg = ci_cfg(full, n_hosts=16, hosts_per_tor=8, uplinks_per_tor=4)
    topo = Topology.build(cfg)
    # asymmetry: one of the uplinks at half rate (fig 9b)
    fs = failures.link_degraded([int(topo.t0_up_queues(0)[0])], 0, 2**30)
    wl = workloads.tornado(16, msg(256, 2048, full))
    for lbn in LBS:
        _, _, _, s, wall = run_one(cfg, wl, lb_for(cfg, lbn), 6000, fs, device=device)
        goodput = wl.msg_pkts.sum() / max(s.runtime_ticks, 1)
        rows.add(f"fig09/asym/{lbn}", wall * 1e6,
                 f"agg_goodput_pkts_per_tick={goodput:.2f};runtime={s.runtime_ticks}")
    # failure drops (fig 10b)
    fs2 = failures.link_down([int(topo.t0_up_queues(0)[1])], 800, 2**30)
    for lbn in LBS:
        kw = {"freezing_timeout": 800} if lbn == "reps" else {}
        _, _, _, s, wall = run_one(cfg, wl, lb_for(cfg, lbn, **kw), 8000, fs2, device=device)
        rows.add(f"fig10/linkdown/{lbn}", wall * 1e6,
                 f"drops_fail={s.drops_fail};timeouts={s.timeouts};runtime={s.runtime_ticks}")
    return rows
