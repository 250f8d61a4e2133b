"""The port's scale mode (``SimConfig(conn_sharding=True)``: the sparse
active set and the lifetime-sized packet table) against the reference's.

The model is the reference's tests/test_scale_mode.py: 16 hosts, 4 per
ToR, 4 uplinks, RTO 120 ticks, ``permutation(16, 24, seed=3)``, REPS, seed
7.  On the CPU (the kernels' plain versions) the port's sparse engine
equals JAX's sparse engine after every tick on every leaf, ``as_idx`` and
``as_count`` included (tolerance 0), with and without a binding
``active_slots`` cap; the set tracks exactly the non-FREE slots; a
quiescent run is a bit-exact fixed point with an empty set; sparse equals
dense in the port; the packed REPS state is <= 25 B/conn at 10**5
connections; the int32 audits hold at 10**6 connections (where dense
mode's rule asks for a 2**28-slot table) and raise past them; and a run
whose random draws come in short chunks equals one drawn in long chunks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_lb as j_make_lb
from repro.netsim import engine as jengine
from repro.netsim import failures as jfail
from repro.netsim import workloads as jwl
from repro.netsim.config import SimConfig as JConfig
from repro_torch.core import make_lb as t_make_lb
from repro_torch.netsim import engine as tengine
from repro_torch.netsim import failures as tfail
from repro_torch.netsim import interop
from repro_torch.netsim import workloads as twl
from repro_torch.netsim.config import SimConfig as TConfig, checked_auto_pkt_slots
from test_torch_netsim import assert_states_equal, jax_state_to_numpy

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

BASE = dict(n_hosts=16, hosts_per_tor=4, uplinks_per_tor=4, rto_ticks=120, conn_sharding=True)


def _sims(failures=True, **cfg_kw):
    """The reference test's scenario in both packages (with, by default, one
    ToR-0 uplink down over ticks 20-150, so that RTOs fire mid-run)."""
    kw = dict(BASE, **cfg_kw)
    fs = (lambda m: m.link_down([0], 20, 150)) if failures else (lambda m: None)
    jsim = jengine.Simulator(JConfig(arrivals_backend="jnp", kernels_backend="jnp", **kw),
                             jwl.permutation(16, msg_pkts=24, seed=3),
                             j_make_lb("reps", evs_size=65536), failures=fs(jfail), seed=7)
    tsim = tengine.Simulator(TConfig(**kw), twl.permutation(16, msg_pkts=24, seed=3),
                             t_make_lb("reps", evs_size=65536), failures=fs(tfail), seed=7,
                             device="cpu")
    assert (tsim.NP, tsim.A, tsim.MAX_EV, tsim.MAX_FREE) == (jsim.NP, jsim.A, jsim.MAX_EV,
                                                             jsim.MAX_FREE)
    return jsim, tsim


def _tick_by_tick(jsim, tsim, ticks):
    tick = jax.jit(jsim.tick_fn)
    js, ts = jsim.init_state(), tsim.init_state()
    assert_states_equal(jax_state_to_numpy(js), interop.sim_state_to_numpy(ts), "init")
    draws = tsim.tick_draws(tsim.base_key, 0, ticks)
    for t in range(ticks):
        js, jtr = tick(js, jnp.int32(t))
        ts, ttr = tsim.tick_fn(ts, t, draws.row(t))
        assert_states_equal(jax_state_to_numpy(js), interop.sim_state_to_numpy(ts), f"tick {t}")
        for a, b in zip(jtr, ttr):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    return js, ts


def test_sparse_engine_tick_by_tick_matches_reference():
    """Every leaf, as_idx and as_count included, after every one of 320
    ticks; the RTO, the capacity gate and the active-set maintenance all
    run (timeouts fire, the set grows and drains)."""
    jsim, tsim = _sims()
    assert tsim.A == tsim.NP == 4096  # the connection rule is the smaller here
    js, ts = _tick_by_tick(jsim, tsim, 320)
    st = np.asarray(js.s_stats)
    assert st[jengine.ST_TIMEOUTS] > 0 and st[jengine.ST_DROPS_FAIL] > 0


def test_binding_active_slots_matches_reference_with_alloc_fails():
    """``active_slots`` below the live slots: the overflow shows as counted
    alloc failures, exactly as in JAX, tick by tick."""
    jsim, tsim = _sims(active_slots=48)
    assert tsim.A == 48 < tsim.NP
    js, ts = _tick_by_tick(jsim, tsim, 200)
    assert int(np.asarray(js.s_stats)[jengine.ST_ALLOC_FAIL]) > 0
    assert int(ts.as_count) <= 48


def test_quiescence_is_a_fixed_point_with_an_empty_set():
    _, tsim = _sims(failures=False)
    s1, _ = tsim.run(550)
    assert bool(s1.c_done.all()), "the workload must finish by t=550"
    assert int(s1.as_count) == 0 and int(s1.fl_count) == tsim.NP
    assert bool((s1.as_idx == tsim.NP).all())
    s2, _ = tsim.run(50, s1)
    assert_states_equal(interop.sim_state_to_numpy(s1), interop.sim_state_to_numpy(s2),
                        "post-quiescent ticks")


def test_active_set_tracks_non_free_slots_mid_flight():
    _, tsim = _sims(failures=False)
    st, _ = tsim.run(40)
    as_idx = st.as_idx.numpy()
    live = as_idx[as_idx < tsim.NP]
    assert len(live) > 0 and (np.diff(live) > 0).all()
    nonfree = np.nonzero(st.pkt[tengine.PS, : tsim.NP].numpy() != tengine.FREE)[0]
    assert np.array_equal(live, nonfree)
    assert int(st.as_count) == len(live) == tsim.NP - int(st.fl_count)


@pytest.mark.parametrize("failures", [False, True])
def test_sparse_equals_dense_in_the_port(failures):
    """With A == NP every leaf but as_idx / as_count equals dense mode."""
    _, sparse = _sims(failures=failures)
    _, dense = _sims(failures=failures, conn_sharding=False)
    assert sparse.NP == dense.NP == sparse.A and dense.A == 0
    a, _ = sparse.run(300)
    b, _ = dense.run(300)
    a, b = interop.sim_state_to_numpy(a), interop.sim_state_to_numpy(b)
    assert b["as_idx"].shape == (0,) and a["as_idx"].shape == (sparse.A,)
    for k in ("as_idx", "as_count"):
        a.pop(k), b.pop(k)
    assert_states_equal(a, b, "sparse vs dense")


def test_footprint_1e5_conns_under_25_bytes():
    from repro_torch.bench.common import Rows
    from repro_torch.bench.table1_footprint import measure_scale

    rows = Rows(device="cpu")
    assert measure_scale(100_000, rows, device="cpu") <= 25.0
    assert any(r["name"] == "scale/footprint_conns100000" for r in rows.records)


def test_int32_audits_at_and_past_1e6_conns():
    from repro_torch.bench.scale_smoke import scale_cfg, scale_workload

    assert checked_auto_pkt_slots(1024, 170, 128) < 2**31
    assert checked_auto_pkt_slots(1024, 170, 128, pin=4096) == 4096
    with pytest.raises(ValueError, match="int32") as e:
        checked_auto_pkt_slots(2**26, 170, 128)
    assert "n_conns" in str(e.value)
    with pytest.raises(ValueError, match="int32"):
        checked_auto_pkt_slots(1024, 170, 128, pin=2**40)
    cfg = scale_cfg()
    wl = scale_workload(10**6, cfg.n_hosts)
    lb = t_make_lb("reps", evs_size=cfg.evs_size)
    # dense mode's rule at 10**6 conns: a 2**28-slot table (as the reference's
    # rule gives), 1024 x the scale mode's lifetime-sized one
    from repro.netsim.config import checked_auto_pkt_slots as j_checked

    assert checked_auto_pkt_slots(10**6, 170, 128) == j_checked(10**6, 170, 128) == 2**28
    sim = tengine.Simulator(cfg, wl, lb, device="cpu")  # scale mode: the audit passes
    assert sim.NP == sim.A == 262144
    # past the widest per-tick id: (NC + 1) * (MAX_EV + 1) > INT32_MAX
    big = TConfig(n_hosts=1024, hosts_per_tor=16, uplinks_per_tor=16, conn_sharding=True)
    with pytest.raises(ValueError, match="overflows int32"):
        tengine.Simulator(big, scale_workload(2_100_000, 1024), lb, device="cpu")


def test_chunked_draws_equal_one_long_chunk(monkeypatch):
    """The draws keyed by tick: a run drawn 3 ticks at a time (a small
    DRAW_ELEMS) equals the one drawn 256 at a time, on every leaf and trace
    field, through run and through a FleetRunner."""
    from repro_torch.netsim import FleetRunner

    _, tsim = _sims()
    assert tsim.draw_chunk(1) == tengine.DRAW_CHUNK
    a, ta = tsim.run(260)
    fleet = FleetRunner(TConfig(**BASE), twl.permutation(16, msg_pkts=24, seed=3),
                        t_make_lb("reps", evs_size=65536),
                        failures=tfail.link_down([0], 20, 150), seeds=(7, 8), device="cpu")
    fa, _ = fleet.run_summary(260)
    per_tick = tsim.wl.n_conns * (tsim.cfg.feedback_rounds + 2)
    monkeypatch.setattr(tengine, "DRAW_ELEMS", 3 * per_tick)
    assert tsim.draw_chunk(1) == 3 and tsim.draw_chunk(2) == 1
    b, tb = tsim.run(260)
    fb, _ = fleet.run_summary(260)
    assert_states_equal(interop.sim_state_to_numpy(a), interop.sim_state_to_numpy(b), "run")
    for x, y in zip(ta, tb):
        assert torch.equal(x, y)
    for i in range(2):
        assert_states_equal(interop.sim_state_to_numpy(fleet.state_at(fa, i)),
                            interop.sim_state_to_numpy(fleet.state_at(fb, i)), f"fleet row {i}")
