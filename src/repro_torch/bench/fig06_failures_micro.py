"""Fig 6: two transient uplink failures; REPS freezes within ~1 RTO and
avoids the failed paths, OPS keeps spraying (the reference's
``benchmarks/fig06_failures_micro.py``).  Both LB cells run as one bucket:
the failure schedules pad to one shape and the OPS / REPS columns share one
tick behind a ``SwitchLB`` branch index per row."""
from repro_torch.bench.common import Rows, ci_cfg, figure_grid, msg, sweep_case
from repro_torch.netsim import FailureSchedule, Topology, failures, workloads


def cases(cfg, smoke=None, full=None):
    topo = Topology.build(cfg)
    ups = topo.t0_up_queues(0)
    fs = FailureSchedule.concat(
        failures.link_down([int(ups[0])], 150, 800),
        failures.link_down([int(ups[1])], 1200, 2400),
    )
    wl = workloads.permutation(cfg.n_hosts, min(msg(768, 4096, full), cfg.max_msg_pkts), seed=3)
    watch = topo.t0_up_queues(0)
    return [
        sweep_case("fig06/ops", wl, "ops", 8000, cfg, failures=fs, watch=watch),
        sweep_case("fig06/reps", wl, "reps", 8000, cfg, failures=fs, watch=watch,
                   freezing_timeout=800),
    ]


def fmt(_name, s):
    return (f"runtime={s.runtime_ticks};drops_fail={s.drops_fail};"
            f"timeouts={s.timeouts};completed={s.completed}/{s.n_conns}")


def main(rows=None, full=None, smoke=None, collect=None, device=None):
    rows = rows or Rows()
    cfg = ci_cfg(full)
    figure_grid(rows, "fig06", cfg, cases(cfg, smoke, full), fmt=fmt, collect=collect,
                device=device)
    return rows
