"""Fig 15 (Appendix A): forcing freezing mode without a failure costs ~1 %,
so entering freezing conservatively is safe (the reference's
``benchmarks/fig15_forced_freezing.py``).

The reference's ``ForcedFreezeReps`` overrides ``on_ack``; the port's
``RepsLB.step`` is one fused ``reps_tick`` launch that never calls it, so
the forced freeze goes through ``RepsLB``'s ``after_acks`` hook: at tick
``force_at`` every connection goes through ``on_failure_detection`` after
the tick's ACK rounds and before its timeouts and sends.  That tick takes
one ACK-only launch more; every other tick stays one launch."""
import torch

from repro_torch.bench.common import Rows, ci_cfg, completion_row, lb_for, msg, run_one
from repro_torch.core import reps as reps_core
from repro_torch.core.load_balancers import RepsLB
from repro_torch.netsim import workloads

FORCE_AT = 900
TICKS = 6000


class ForcedFreezeReps(RepsLB):
    name = "reps_forced_freeze"

    def __init__(self, force_at: int, **kw):
        super().__init__(**kw)
        self.force_at = force_at

    def after_acks_at(self, now: int) -> bool:
        return now == self.force_at

    def after_acks(self, state, now):
        all_conns = torch.ones_like(state.is_freezing)
        return reps_core.on_failure_detection(self.cfg, state, all_conns, now)


def main(rows=None, full=None, smoke=None, collect=None, device=None):
    rows = rows or Rows()
    cfg = ci_cfg(full)
    wl = workloads.tornado(cfg.n_hosts, msg(384, 4096, full))
    base = lb_for(cfg, "reps")
    forced = ForcedFreezeReps(force_at=FORCE_AT, evs_size=cfg.evs_size)
    for tag, lb in [("normal", base), ("forced_freeze", forced)]:
        _, _, _, s, wall = run_one(cfg, wl, lb, TICKS, device=device)
        completion_row(rows, f"fig15/{tag}", s, wall)
    return rows
