"""The port's ``FleetRunner`` against the JAX ``FleetRunner``: the three
tests of tests/test_fleet.py mirrored on the port, each port fleet row held
against the JAX fleet's row on every ``SimState`` leaf and on the
``delivered`` / ``watch_qlen`` traces (tolerance 0), on the CPU (every
kernel site runs its plain version).  Then the port's own: a one-row fleet
is the ``Simulator``, ``run(n, states)`` numbers its ticks from 0 as the
reference does, and the arguments the port refuses raise.  The telemetry
path is held in tests/test_torch_telemetry.py."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.arcane_paper import FATTREE_32_CI as J_CFG
from repro.core import make_lb as j_make_lb
from repro.netsim import FleetRunner as JFleet
from repro.netsim import Topology as JTopology
from repro.netsim import failures as jfail
from repro.netsim import metrics as jmetrics
from repro.netsim import workloads as jwl
from repro_torch.configs.arcane_paper import FATTREE_32_CI as T_CFG
from repro_torch.core import make_lb as t_make_lb
from repro_torch.netsim import FleetRunner as TFleet
from repro_torch.netsim import Simulator, Topology as TTopology, failures as tfail, interop
from repro_torch.netsim import workloads as twl
from test_torch_netsim import assert_states_equal, jax_state_to_numpy

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

SEEDS = [0, 3, 11]


def both_fleets(lbn: str, kw: dict, workload, seeds, failures_of=None, **cfg_kw):
    """The same fleet in both packages (the port's on the CPU), on
    FATTREE_32_CI with ``cfg_kw`` replaced."""
    fs = failures_of or (lambda m: None)
    jf = JFleet(J_CFG.replace(**cfg_kw), workload(jwl), j_make_lb(lbn, **kw), failures=fs(jfail),
                seeds=seeds)
    tf = TFleet(T_CFG.replace(**cfg_kw), workload(twl), t_make_lb(lbn, **kw),
                failures=fs(tfail), seeds=seeds, device="cpu")
    return jf, tf


def assert_rows_equal(jf, jstates, tf, tstates, where: str) -> None:
    """Every SimState leaf of every row, port against JAX, bit for bit."""
    assert tf.n_runs == jf.n_runs
    for i in range(jf.n_runs):
        js = jax.tree_util.tree_map(lambda x, i=i: x[i], jstates)
        assert_states_equal(jax_state_to_numpy(js),
                            interop.sim_state_to_numpy(tf.state_at(tstates, i)),
                            f"{where}, row {i} (seed {jf.seeds[i]})")


def assert_traces_equal(jtr, ttr, fields=("delivered", "watch_qlen")) -> None:
    for f in fields:
        a, b = np.asarray(getattr(jtr, f)), getattr(ttr, f).numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, (f, a.shape, b.shape)
        np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("lbn", ["reps", "ops", "plb"])
def test_fleet_matches_jax_fleet_per_seed(lbn):
    """tests/test_fleet.py::test_fleet_matches_serial_per_seed on the port:
    FATTREE_32_CI, a permutation of 48-packet messages, seeds 0, 3, 11, 700
    ticks; each row equals the JAX fleet's row, traces included."""
    kw = dict(evs_size=J_CFG.evs_size)
    jf, tf = both_fleets(lbn, kw, lambda m: m.permutation(32, 48, seed=1), SEEDS)
    jstates, jtr = jf.run(700)
    tstates, ttr = tf.run(700)
    assert_rows_equal(jf, jstates, tf, tstates, lbn)
    assert_traces_equal(jtr, ttr)
    assert ttr.delivered.shape == (700, 3) and ttr.watch_qlen.shape[:2] == (700, 3)


def test_fleet_matches_jax_fleet_under_failures():
    """tests/test_fleet.py::test_fleet_matches_serial_under_failures on the
    port: REPS (freezing timeout 600) with ToR-0's first two uplinks down
    from tick 150 on, 1200 ticks; every leaf of every row equals JAX's."""
    ups = [int(q) for q in JTopology.build(J_CFG).t0_up_queues(0)[:2]]
    kw = dict(evs_size=J_CFG.evs_size, freezing_timeout=600)
    jf, tf = both_fleets("reps", kw, lambda m: m.permutation(32, 48, seed=3), SEEDS,
                         lambda m: m.link_down(ups, 150, 2**30))
    jstates, jtr = jf.run(1200)
    tstates, ttr = tf.run(1200)
    assert_rows_equal(jf, jstates, tf, tstates, "reps under failures")
    assert_traces_equal(jtr, ttr, ("delivered", "watch_qlen", "drops", "timeouts"))


def test_fleet_summaries_match_jax_fleet():
    """tests/test_fleet.py::test_fleet_summaries_shape on the port: one
    RunSummary per seed, each equal to the JAX fleet's, every connection
    completed in every row."""
    jf, tf = both_fleets("reps", dict(evs_size=256), lambda m: m.permutation(32, 32, seed=4),
                         [5, 9])
    jstates, _ = jf.run(600)
    tstates, _ = tf.run(600)
    js, ts = jf.summaries(jstates), tf.summaries(tstates)
    assert len(ts) == 2
    assert [dataclasses.asdict(s) for s in ts] == [dataclasses.asdict(s) for s in js]
    assert ts[0].completed == ts[1].completed == tf.sim.wl.n_conns
    assert jmetrics.summarize(jf.sim, jax.tree_util.tree_map(lambda x: x[1], jstates)) == js[1]


def test_fleet_resumes_numbering_ticks_from_zero_as_the_reference():
    """``run(n, states)`` starts again at tick 0, in the reference and in
    the port: a resumed fleet equals JAX's resumed fleet, leaf for leaf."""
    kw = dict(evs_size=J_CFG.evs_size, freezing_timeout=200)
    jf, tf = both_fleets("reps", kw, lambda m: m.permutation(32, 48, seed=2), [1, 7])
    jstates, _ = jf.run(250)
    tstates, _ = tf.run(250)
    jstates, jtr = jf.run(120, jstates)
    tstates, ttr = tf.run(120, tstates)
    assert_rows_equal(jf, jstates, tf, tstates, "resumed")
    assert_traces_equal(jtr, ttr)


def test_one_row_fleet_is_the_simulator():
    """B = 1: the fleet's one row is ``Simulator.run``, state and trace."""
    cfg, wl = T_CFG, twl.permutation(32, 48, seed=5)
    ups = [int(q) for q in TTopology.build(cfg).t0_up_queues(0)[:2]]
    lb = lambda: t_make_lb("mptcp", evs_size=cfg.evs_size)
    fs = tfail.link_down(ups, 40, 300)
    fleet = TFleet(cfg, wl, lb(), failures=fs, seeds=[4], device="cpu")
    states, traces = fleet.run(500)
    st, tr = Simulator(cfg, wl, lb(), failures=fs, seed=4, device="cpu").run(500)
    a, b = interop.sim_state_to_numpy(fleet.state_at(states, 0)), interop.sim_state_to_numpy(st)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k
    for f in tr._fields:
        assert torch.equal(getattr(traces, f)[:, 0], getattr(tr, f)), f


def test_fleet_telemetry_and_backends_raise():
    with pytest.raises(ValueError, match="device picks"):
        TFleet(T_CFG, twl.permutation(32, 8, seed=0), t_make_lb("ops", evs_size=256),
               kernels_backend="pallas", device="cpu")
    with pytest.raises(ValueError, match="at least one seed"):
        TFleet(T_CFG, twl.permutation(32, 8, seed=0), t_make_lb("ops", evs_size=256),
               seeds=[], device="cpu")
