"""The 3-tier fat tree through the whole engine, tick by tick against the
jitted JAX engine on the CPU: every SimState leaf and the tick trace equal
after every tick, and the final RunSummary equal.  The fabric is the 3-tier
one of tests/test_netsim.py (32 hosts, 2 ToRs per pod, 4 aggs per pod with
2 core uplinks each, 256 EVs); one agg uplink of pod 0 is down over a
window, so REPS hashes both choice hops around a failure and adaptive RoCE
steers both hops by queue length with the failure's penalty."""
import numpy as np
import pytest
import torch

from repro.configs import arcane_paper as jpresets
from repro.netsim import engine as jengine
from repro.netsim import topology as jtopo
from test_torch_netsim import run_tick_by_tick

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

CFG_KW = dict(hosts_per_tor=4, tiers=3, tors_per_pod=2, aggs_per_pod=4, agg_uplinks=2,
              rto_ticks=500, max_msg_pkts=256)  # on FATTREE_32_CI: 48-packet queues, cwnd 40/80
TICKS = 700
FAIL = (30, 600)


@pytest.mark.parametrize("lbn", ["reps", "adaptive_roce"])
def test_three_tier_tick_by_tick_matches_reference(lbn):
    topo = jtopo.Topology.build(jpresets.FATTREE_32_CI.replace(**CFG_KW))
    down = topo.agg_up_base  # pod 0, agg 0, core uplink 0
    kw = dict(evs_size=256, **(dict(freezing_timeout=200) if lbn == "reps" else {}))
    _, js, _, _ = run_tick_by_tick(
        lbn, kw, TICKS, lambda m: m.permutation(32, 48, seed=3),
        lambda m: m.link_down([down], *FAIL), cfg_kw=CFG_KW)
    served = np.asarray(js.q_served)
    # every region carried traffic: ToR up, agg up, core down, agg down, host down
    bounds = [0, topo.agg_up_base, topo.core_down_base, topo.agg_down_base, topo.t0_down_base,
              topo.n_queues]
    assert all(served[lo:hi].sum() > 0 for lo, hi in zip(bounds[:-1], bounds[1:])), served
    assert int(np.asarray(js.s_stats)[jengine.ST_DELIVERED]) > 0
    if lbn == "reps":  # hashed onto the down agg uplink, past the RTO
        stats = np.asarray(js.s_stats)
        assert stats[jengine.ST_DROPS_FAIL] > 0 and stats[jengine.ST_TIMEOUTS] > 0, stats
