"""The load balancers that report no decision (ECMP, MPRDMA, bitmap,
adaptive RoCE, a SwitchLB of two of them) tick by tick against the
reference's flight recorder, and every LB's ``trace`` port on one call of
each site against the reference's ``trace``, on the CPU, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import rng
from test_torch_tracer import CFG_J, check_lb, sims

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores


@pytest.mark.parametrize("lbn", ["ecmp", "mprdma", "bitmap", "adaptive_roce",
                                 "switch:ops+ecmp"])
def test_silent_lbs_tick_events_and_ring_match_reference(lbn):
    kw = {"evs_size": CFG_J.evs_size} if lbn == "bitmap" else {}
    check_lb(lbn, {k: v for k, v in kw.items() if k != "evs_size"}, ticks=240)


@pytest.mark.parametrize("lbn", ["reps", "plb", "flowlet", "prime", "seqbalance",
                                 "flowlet_table", "mptcp"])
def test_trace_port_matches_reference_on_its_sites(lbn):
    """Each LB's ``trace`` on the states around one call of each site (a
    state already stepped 200 ticks), against the reference's ``trace``."""
    tsim_j, tsim_t = sims(lbn, {})
    js, _ = tsim_j.run(200)
    ts, _ = tsim_t.run(200)
    rs = np.random.RandomState(1)
    N = 32
    mask = rs.rand(N) < 0.6
    ev = rs.randint(0, CFG_J.evs_size, N).astype(np.int32)
    ecn = rs.rand(N) < 0.5
    jl, tl = tsim_j.lb, tsim_t.lb
    key = jax.random.PRNGKey(3)
    tk = rng.PRNGKey(3, "cpu")
    jm, tm = jnp.asarray(mask), torch.as_tensor(mask)
    sites = {
        "ack": (lambda s: jl.on_ack(s, jm, jnp.asarray(ev), jnp.asarray(ecn), 200, key),
                lambda s: tl.on_ack(s, tm, torch.as_tensor(ev), torch.as_tensor(ecn), 200,
                                    tl.draw_ack(tk, N))),
        "timeout": (lambda s: jl.on_timeout(s, jm, 200, key),
                    lambda s: tl.on_timeout(s, tm, 200, tl.draw_timeout(tk, N))),
        "choose": (lambda s: jl.choose_ev(s, jm, key, 200)[1],
                   lambda s: tl.choose_ev(s, tm, tl.draw(tk, N), 200)[1]),
    }
    for site, (jf, tf) in sites.items():
        want = np.asarray(jl.trace(site, js.lb_state, jf(js.lb_state), jm))
        got = tl.trace(site, ts.lb_state, tf(ts.lb_state), tm)
        assert got.shape == (1, 8)
        if site in tl.trace_sites or not want.any():
            np.testing.assert_array_equal(got[0].numpy(), want, err_msg=f"{lbn} {site}")
        assert (site in tl.trace_sites) or not want.any()


