"""tests/test_lb_arena.py::test_fleet_seeds_decorrelated_under_congestion on
the port: a fleet's rows re-path with their own seed's draws under a
congested incast (PLB, MPTCP), so no two rows are bit-identical; and each
row equals the JAX fleet's row on every ``SimState`` leaf (tolerance 0), on
the CPU."""
import numpy as np
import pytest
import torch

from repro.configs.arcane_paper import FATTREE_32_CI as J_CFG
from test_torch_fleet import assert_rows_equal, both_fleets

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores


@pytest.mark.parametrize("lbn", ["plb", "mptcp"])
def test_fleet_seeds_decorrelated_under_congestion(lbn):
    kw = dict(evs_size=J_CFG.evs_size)
    jf, tf = both_fleets(lbn, kw, lambda m: m.incast(32, 8, 48), (0, 1), queue_capacity=16)
    states, _ = tf.run(1200)
    sums = tf.summaries(states)
    # the congested incast actually exercised the repath paths
    assert all(s.ecn_marks > 0 for s in sums), sums
    if lbn == "mptcp":
        assert all(s.timeouts > 0 for s in sums), sums
    evs = states.lb_state.ev if lbn == "plb" else states.lb_state.sub_evs
    assert not np.array_equal(evs[0].numpy(), evs[1].numpy())
    assert not np.array_equal(states.c_done_tick[0].numpy(), states.c_done_tick[1].numpy())
    jstates, _ = jf.run(1200)
    assert_rows_equal(jf, jstates, tf, states, f"{lbn} incast")
