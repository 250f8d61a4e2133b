"""The rest of the load-balancer zoo through the whole engine, tick by tick
against the jitted JAX engine: every SimState leaf (the LB state's leaves
included), the tick trace and the RunSummary equal after every tick, on the
CPU.  The scenario is FATTREE_32_CI with 16-packet queues (so ECN marks
reach every LB's ACK path), a permutation of 48-packet messages and two
ToR-0 uplinks down over ticks 30-300, so that timeouts fire (RTO 400
ticks) and every ``on_timeout`` draw is taken.  ECMP, OPS and REPS run the
same test in tests/test_torch_netsim.py; the zoo is split over this file and
tests/test_torch_lb_engine_more.py to keep each file's run short."""
import numpy as np
import pytest
import torch

from repro.netsim import engine as jengine
from test_torch_netsim import FAIL, _scenario, run_tick_by_tick

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

QUEUE = 16


def check_zoo_lb(lbn: str, **kw):
    ups, _ = _scenario(lbn)
    _, js, _, _ = run_tick_by_tick(
        lbn, dict(evs_size=256, **kw), 470, lambda m: m.permutation(32, 48, seed=3),
        lambda m: m.link_down(ups, *FAIL), cfg_kw=dict(queue_capacity=QUEUE))
    stats = np.asarray(js.s_stats)
    assert stats[jengine.ST_TIMEOUTS] > 0 and stats[jengine.ST_ECN] > 0, stats


@pytest.mark.parametrize("lbn", ["plb", "flowlet", "mptcp", "mprdma", "bitmap"])
def test_zoo_engine_tick_by_tick_matches_reference(lbn):
    check_zoo_lb(lbn)
