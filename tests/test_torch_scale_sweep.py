"""The port's sweep engine in scale mode and on generated fabrics, against
the reference's on the CPU (the kernels' plain versions), bit for bit.

* ``SweepEngine(conn_sharding=True, conn_devices=1)`` over the three cases
  of the reference's tests/test_scale_mode.py (a failure schedule, a row
  frozen at a shorter horizon, an adaptive bucket): the plan and every row
  (every SimState leaf, as_idx and as_count included; traces; telemetry)
  equal JAX's ``SweepEngine`` with ``conn_devices=1``; ``conn_devices=2``
  raises.
* Generated fabrics: REPS and adaptive RoCE on small ``rail`` and ``mesh``
  fabrics equal JAX tick by tick (every leaf after every tick), and go
  through the packer to the same plan and rows; the port's clos3 run equals
  its arithmetic 3-tier run.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_lb as j_make_lb
from repro.netsim import engine as jengine
from repro.netsim import workloads as jwl
from repro.netsim.config import SimConfig as JConfig
from repro_torch.core import make_lb as t_make_lb
from repro_torch.netsim import engine as tengine
from repro_torch.netsim import Topology, interop
from repro_torch.netsim import workloads as twl
from repro_torch.netsim.config import SimConfig as TConfig
from sweep_parity import case, engines, run_both
from test_torch_netsim import assert_states_equal, jax_state_to_numpy

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

SCALE = dict(n_hosts=16, hosts_per_tor=4, uplinks_per_tor=4, rto_ticks=120,
             conn_sharding=True)


def _scale_cases(m):
    fs = m.net.FailureSchedule(queue=np.array([16, 17], np.int32),
                               start=np.array([50, 80], np.int32),
                               end=np.array([150, 200], np.int32),
                               kind=np.array([0, 1], np.int32), param=np.array([0, 0], np.int32))
    wl = m.net.workloads
    return [
        # merges with b, which becomes the bucket's frozen-horizon row
        case(m, "a/reps", wl.permutation(16, 24, seed=3), "reps", 400, fs=fs, seeds=(0, 1)),
        case(m, "b/ecmp", wl.permutation(16, 16, seed=5), "ecmp", 300, seeds=(7,)),
        # switch-adaptive routing is a static property: a second bucket
        case(m, "c/adaptive", wl.permutation(16, 12, seed=9), "adaptive_roce", 250, seeds=(1,)),
    ]


@pytest.mark.parametrize("collect", ["full", "summary"])
def test_scale_sweep_matches_reference(collect):
    je, te = engines(_scale_cases, cfg_kw=SCALE, conn_devices=1)
    assert len(te.plan.buckets) >= 2 and te.plan.describe() == je.plan.describe()
    _, tres = run_both(je, te, collect=collect)
    st = tres.state_for("a/reps", 1)
    assert st.as_idx.shape == (te.buckets[0].sim.A,)
    for b in te.buckets:  # every row's active set: ascending, exactly the live slots
        NP = b.sim.NP
        for r in range(b.n_rows):
            idx = b.final_state.as_idx[r].numpy()
            live = np.nonzero(b.final_state.pkt[r, tengine.PS, :NP].numpy() != tengine.FREE)[0]
            assert np.array_equal(idx[idx < NP], live)
            assert int(b.final_state.as_count[r]) + int(b.final_state.fl_count[r]) == NP


def test_conn_devices_beyond_one_raise():
    """``conn_devices`` beyond the ranks up raises the reference's
    ValueError (here no process group: one rank), and so does a config
    that has not opted in to scale mode; conn-sharded runs over ranks are
    held in tests/test_torch_conn_axis.py."""
    import repro_torch.netsim as tnet

    cases = _scale_cases(types.SimpleNamespace(net=tnet, cfg=TConfig(**SCALE)))
    with pytest.raises(ValueError, match="conn_devices=2 exceeds the 1 visible devices"):
        tnet.SweepEngine(TConfig(**SCALE), cases, conn_devices=2, device="cpu")
    with pytest.raises(ValueError, match="conn_sharding"):
        tnet.SweepEngine(TConfig(**dict(SCALE, conn_sharding=False)), cases, conn_devices=2,
                         device="cpu")


FABRIC_CFG = dict(n_hosts=16, hosts_per_tor=4, uplinks_per_tor=4, rto_ticks=120, evs_size=256)


@pytest.mark.parametrize("fabric,lbn,sparse", [
    ("rail:tors=4,hosts=4,rails=4", "reps", False),
    ("rail:tors=4,hosts=4,rails=4", "adaptive_roce", True),
    ("mesh:tors=4,hosts=4,planes=2", "reps", True),
    ("mesh:tors=4,hosts=4,planes=2", "adaptive_roce", False),
])
def test_generated_fabric_tick_by_tick_matches_reference(fabric, lbn, sparse):
    """A ToR-0 up link down over ticks 30-200 (past the RTO), a
    permutation: every leaf after every tick equals JAX's."""
    kw = dict(FABRIC_CFG, fabric=fabric, conn_sharding=sparse)
    q = int(Topology.build(TConfig(**kw)).t0_up_queues(0)[0])
    down = lambda m: m.FailureSchedule(*(np.array([v], np.int32) for v in (q, 30, 200, 0)))
    jsim = jengine.Simulator(JConfig(arrivals_backend="jnp", kernels_backend="jnp", **kw),
                             jwl.permutation(16, 24, seed=3), j_make_lb(lbn, evs_size=256),
                             failures=down(jengine), seed=7)
    tsim = tengine.Simulator(TConfig(**kw), twl.permutation(16, 24, seed=3),
                             t_make_lb(lbn, evs_size=256), failures=down(tengine), seed=7,
                             device="cpu")
    assert (tsim.NQ, tsim.NP, tsim.A) == (jsim.NQ, jsim.NP, jsim.A)
    tick = jax.jit(jsim.tick_fn)
    js, ts = jsim.init_state(), tsim.init_state()
    draws = tsim.tick_draws(tsim.base_key, 0, 260)
    for t in range(260):
        js, jtr = tick(js, jnp.int32(t))
        ts, ttr = tsim.tick_fn(ts, t, draws.row(t))
        assert_states_equal(jax_state_to_numpy(js), interop.sim_state_to_numpy(ts), f"tick {t}")
        for a, b in zip(jtr, ttr):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    stats = np.asarray(js.s_stats)
    assert stats[jengine.ST_DELIVERED] > 0


def test_generated_fabric_sweep_matches_reference():
    """Cells on a rail fabric (REPS, OPS; scale mode) and their plan through
    the packer: the same plan and rows as JAX's."""
    def cases(m):
        wl = m.net.workloads
        return [case(m, "rail/reps", wl.permutation(16, 24, seed=3), "reps", 300, seeds=(0, 2)),
                case(m, "rail/ops", wl.permutation(16, 24, seed=3), "ops", 250)]

    kw = dict(FABRIC_CFG, fabric="rail:tors=4,hosts=4,rails=4", conn_sharding=True)
    je, te = engines(cases, cfg_kw=kw)
    assert te.plan.describe() == je.plan.describe()
    run_both(je, te, collect="summary")


def test_clos3_equals_arithmetic_three_tier():
    """The reference's tests/test_topogen.py pin, in the port: a run on the
    generated clos3 tables equals the arithmetic 3-tier fat tree of the same
    shape on every leaf and trace field."""
    base = dict(n_hosts=16, hosts_per_tor=2, rto_ticks=120, evs_size=256, tors_per_pod=2,
                aggs_per_pod=2, agg_uplinks=2, tiers=3)
    out = []
    for fabric in ("", "clos3:pods=4,tors=2,hosts=2,aggs=2,up=2"):
        sim = tengine.Simulator(TConfig(fabric=fabric, **base), twl.permutation(16, 12, seed=2),
                                t_make_lb("reps", evs_size=256), seed=5, device="cpu")
        out.append(sim.run(300))
    (sa, ta), (sb, tb) = out
    assert_states_equal(interop.sim_state_to_numpy(sa), interop.sim_state_to_numpy(sb), "clos3")
    for x, y in zip(ta, tb):
        assert torch.equal(x, y)
    assert int(sa.s_stats[tengine.ST_DELIVERED]) > 0
