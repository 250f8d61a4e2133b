"""The second half of the zoo's whole-run parity (see
tests/test_torch_lb_engine.py): adaptive RoCE, Prime, SeqBalance, the
flowlet table, and MixedLB with a REPS foreground beside an ECMP
background cohort (paper Fig. 5); and a port run resumed from a JAX state
whose LB state is nested (mixed)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import arcane_paper as jpresets
from repro.core import make_lb as j_make_lb
from repro.netsim import engine as jengine
from repro.netsim import failures as jfail
from repro.netsim import workloads as jwl
from repro_torch.configs import arcane_paper as tpresets
from repro_torch.core import make_lb as t_make_lb
from repro_torch.netsim import engine as tengine
from repro_torch.netsim import failures as tfail
from repro_torch.netsim import interop
from repro_torch.netsim import workloads as twl
from test_torch_lb_engine import check_zoo_lb
from test_torch_netsim import FAIL, _scenario, assert_states_equal, jax_state_to_numpy

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores


@pytest.mark.parametrize("lbn", ["adaptive_roce", "prime", "seqbalance", "flowlet_table"])
def test_zoo_engine_tick_by_tick_matches_reference_more(lbn):
    check_zoo_lb(lbn)


def test_mixed_engine_tick_by_tick_matches_reference():
    _, bg = twl.permutation_with_background(32, 48, 0.25, seed=3)
    check_zoo_lb("mixed", fg="reps", bg="ecmp", bg_conns=tuple(int(i) for i in np.nonzero(bg)[0]))


def test_port_resumes_from_a_jax_zoo_state():
    """interop with a nested LB state: start the port from the JAX state of
    a mixed(REPS + PLB) run at tick 150 (``lb_like`` gives the structure)
    and step once; every leaf equal."""
    ups, _ = _scenario("mixed")
    kw = dict(fg="reps", bg="plb", bg_conns=(2, 7, 11, 30), evs_size=256)
    jcfg = jpresets.FATTREE_32_CI.replace(arrivals_backend="jnp", kernels_backend="jnp")
    jsim = jengine.Simulator(jcfg, jwl.permutation(32, 48, seed=5), j_make_lb("mixed", **kw),
                             failures=jfail.link_down(ups, *FAIL))
    tsim = tengine.Simulator(tpresets.FATTREE_32_CI, twl.permutation(32, 48, seed=5),
                             t_make_lb("mixed", **kw), failures=tfail.link_down(ups, *FAIL),
                             device="cpu")
    js, _ = jsim.run(150)
    like = tsim.init_state().lb_state
    ts = interop.sim_state_from_numpy(jax_state_to_numpy(js), device="cpu", lb_like=like)
    assert_states_equal(jax_state_to_numpy(js), interop.sim_state_to_numpy(ts), "round trip")
    js2, _ = jax.jit(jsim.tick_fn)(js, jnp.int32(150))
    ts2, _ = tsim.tick_fn(ts, 150)
    assert_states_equal(jax_state_to_numpy(js2), interop.sim_state_to_numpy(ts2), "tick 150")
