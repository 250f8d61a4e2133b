"""Live failover on the soak runtime: advance a running fabric, kill a
spine mid-flight, watch REPS recycle around it (the port of the
reference's ``examples/failover_demo.py``).

The paper's failover claim is a latency: after the first failure drop, the
sender's next delivery over a healthy path lands within ~100 us (first drop
to first re-routed delivery).  The demo builds one sweep grid (OPS against
REPS) and a ``SoakRunner``, advances until traffic is in flight, injects a
whole-spine failure at the current tick (merged through the path a
schedule declared up front takes, so the injected run equals that one),
and reads the live RecoveryTracker channel before the horizon.

    PYTHONPATH=src python -m repro_torch.examples.failover_demo [--device cpu]
"""
from __future__ import annotations

from repro_torch.configs import FATTREE_32_CI
from repro_torch.device import resolve_device
from repro_torch.examples import parse_device
from repro_torch.netsim import SoakConfig, SoakRunner, SweepCase, SweepEngine, failures, workloads


def cases(ticks: int, cfg=FATTREE_32_CI, failure=None) -> list:
    """The demo's grid: OPS and REPS on a 384-packet permutation, seed 0
    (``failure`` declares a schedule up front)."""
    wl = workloads.permutation(cfg.n_hosts, 384, seed=3)
    return [SweepCase(name=lbn, workload=wl, lb=lbn, ticks=ticks, failures=failure,
                      lb_kwargs={"evs_size": cfg.evs_size}, seeds=(0,))
            for lbn in ("ops", "reps")]


def main(device=None, ticks: int = 3000, spine: int = 2, window: int = 500) -> dict:
    """Advance 250 ticks, inject ``spine`` down, advance ``window`` and
    read the live recovery, then run to ``ticks``.  Returns ``{"before":
    inspect at the injection, "live": inspect ``window`` ticks later,
    "result": the SweepResult, "at": the injection's tick}``."""
    dev = resolve_device(device)
    cfg = FATTREE_32_CI
    # min_failure_slots reserves inert failure rows, so that the injected
    # delta re-materialises with no shape change (and the plan equals the
    # one of the failure declared up front)
    engine = SweepEngine(cfg, cases(ticks, cfg), min_failure_slots=8, device=dev)
    soak = SoakRunner(engine, SoakConfig(chunk=250, collect="summary"))

    print(f"permutation traffic on a {cfg.n_hosts}-host 2-tier fabric; horizon {ticks} ticks")
    soak.advance(250)
    before = soak.inspect()
    print(f"t={soak.cursor}: in flight, delivered so far: " + ", ".join(
        f"{n}={v['telemetry']['counters']['delivered']}" for n, v in before.items()))

    at = soak.cursor
    delta = failures.spine_down(cfg, spine, start=at)
    soak.inject(delta)
    print(f"t={soak.cursor}: spine {spine} down — {len(delta)} uplinks blackholed (one per TOR)")

    soak.advance(window)
    live = soak.inspect()
    print(f"t={soak.cursor}: live RecoveryTracker (first drop -> first re-routed delivery):")
    for name, v in live.items():
        r = v["telemetry"]["recovery"]
        print(f"  {name:4s}: first_drop={r['first_drop_tick']:4d}  "
              f"first_redeliver={r['first_redeliver_tick']:4d}  "
              f"recovery={r['recovery_us']:.2f}us")

    soak.advance(ticks)
    res = soak.result()
    print(f"t={soak.cursor}: horizon reached")
    for name, (s,) in sorted(res.summaries().items()):
        r = res.telemetry_for(name)["recovery"]
        print(f"  {name:4s}: completed={s.completed:3d}/{s.n_conns}  "
              f"drops_fail={s.drops_fail:4d}  timeouts={s.timeouts:3d}  "
              f"recovery={r['recovery_us']:.2f}us")
    return {"before": before, "live": live, "result": res, "at": at}


def cli(argv=None):
    return main(parse_device(__doc__, argv))


if __name__ == "__main__":
    cli()
