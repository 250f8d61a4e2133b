"""Quickstart: REPS against OPS and ECMP on a small fat-tree, the paper's
story in a few runs (the port of the reference's ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

from repro_torch.configs import FATTREE_32_CI
from repro_torch.core import make_lb
from repro_torch.device import resolve_device
from repro_torch.examples import parse_device
from repro_torch.netsim import Simulator, Topology, failures, summarize, workloads


def main(device=None, healthy_ticks: int = 1500, failure_ticks: int = 4000) -> dict:
    """ECMP, OPS and REPS on a healthy FATTREE_32_CI for ``healthy_ticks``,
    then OPS and REPS (freezing timeout 600) for ``failure_ticks`` with
    ToR 0's first two uplinks down from tick 300; prints one line per run.
    Returns ``{("healthy" | "failure", lb): RunSummary}``."""
    dev = resolve_device(device)
    cfg = FATTREE_32_CI
    wl = workloads.permutation(cfg.n_hosts, 64, seed=1)
    topo = Topology.build(cfg)
    fs = failures.link_down([int(q) for q in topo.t0_up_queues(0)[:2]], 300, 2**30)
    out = {}

    print("== healthy symmetric network (64-pkt permutation) ==")
    for lbn in ["ecmp", "ops", "reps"]:
        sim = Simulator(cfg, wl, make_lb(lbn, evs_size=cfg.evs_size), seed=0, device=dev)
        st, _ = sim.run(healthy_ticks)
        s = out["healthy", lbn] = summarize(sim, st)
        print(f"  {lbn:5s} runtime={s.runtime_ticks:5d} ticks  drops={s.drops_cong:3d} "
              f"timeouts={s.timeouts}")

    print("== two uplinks fail at t=300 ==")
    for lbn in ["ops", "reps"]:
        lb = make_lb(lbn, evs_size=cfg.evs_size,
                     **({"freezing_timeout": 600} if lbn == "reps" else {}))
        sim = Simulator(cfg, wl, lb, failures=fs, seed=0, device=dev)
        st, _ = sim.run(failure_ticks)
        s = out["failure", lbn] = summarize(sim, st)
        print(f"  {lbn:5s} runtime={s.runtime_ticks:5d} ticks  lost={s.drops_fail:3d} "
              f"timeouts={s.timeouts}  (freezing mode reroutes within ~1 RTO)")
    return out


def cli(argv=None):
    return main(parse_device(__doc__, argv))


if __name__ == "__main__":
    cli()
