"""Fig 1: tornado microscopics, uplink utilization and queue occupancy over
time: OPS (noisy, queues above Kmin) against REPS (converges below Kmin).
The reference's ``benchmarks/fig01_tornado_micro.py``: each LB runs once on
one ``Simulator``, watching ToR 0's uplinks (``trace.watch_qlen``,
``trace.watch_served``)."""
from repro_torch.bench.common import Rows, ci_cfg, lb_for, msg, run_one
from repro_torch.netsim import Topology, workloads

LBS = ["ops", "reps"]
TICKS = 2500
WINDOW = 200  # ticks per utilization window


def main(rows=None, full=None, smoke=None, collect=None, device=None):
    rows = rows or Rows()
    cfg = ci_cfg(full)
    wl = workloads.tornado(cfg.n_hosts, msg(512, 4096, full))
    watch = Topology.build(cfg).t0_up_queues(0)
    for lbn in LBS:
        _, _, tr, s, wall = run_one(cfg, wl, lb_for(cfg, lbn), TICKS, watch=watch,
                                    device=device)
        ql = tr.watch_qlen.cpu().numpy()  # (T, W)
        served = tr.watch_served.cpu().numpy()
        active = ql.sum(1) + served.sum(1) > 0
        util = served[: (len(served) // WINDOW) * WINDOW].reshape(
            -1, WINDOW, served.shape[1]).mean(1)
        rows.add(
            f"fig01/{lbn}", wall * 1e6,
            f"runtime={s.runtime_ticks};mean_q={ql[active].mean():.2f};"
            f"max_q={ql.max()};kmin={cfg.kmin};util_std={util.std():.3f};"
            f"ecn={s.ecn_marks}",
        )
    return rows
