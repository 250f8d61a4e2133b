"""The sweep's flight recorder (``SweepEngine.run(trace=...)``, the chunk
primitives' ``trace=``, ``SweepResult.flight_for``) against the reference's
on the CPU, bit for bit: tests/test_tracer.py's grids (two shape buckets,
a failure), each row's decoded ring equal to JAX's, tracing invisible on
every state and telemetry carry, the ring invariant to the chunk tiling,
and the recovery span equal to the RecoveryTracker's.  The frozen row and
the chunk primitives are in tests/test_torch_tracer_sweep_chunks.py."""
import numpy as np
import pytest
import torch

import repro.netsim.tracer as jtracer
import repro_torch.netsim.tracer as ttracer
from sweep_parity import J, T, assert_results_equal, case, engines
from test_torch_netsim import assert_states_equal
from repro_torch.netsim import interop

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

SPEC = dict(ring=4096, marker_every=128)
FOREVER = 2**30


def spec(m):
    return (ttracer if m is T else jtracer).TraceSpec(**SPEC)


def fail_grid(m):
    topo = m.net.Topology.build(m.cfg)
    fs = m.net.failures.link_down(list(topo.t0_up_queues(0)[:2]), 100, FOREVER)
    wl = m.net.workloads.permutation(32, 64, seed=3)
    return [
        case(m, "perm/reps", wl, "reps", 300, seeds=(0, 5)),
        case(m, "fail/reps", wl, "reps", 500, fs=fs, freezing_timeout=300),
        case(m, "incast/plb", m.net.workloads.incast(16, 4, 96), "plb", 400),
    ]


def decode_equal(a, b, ctx=""):
    assert a["cursor"] == b["cursor"], (ctx, a["cursor"], b["cursor"])
    for k in ("seq", "tick", "code", "value"):
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=f"{ctx}:{k}")
    for k in ("first_drop_tick", "first_redeliver_tick", "lost"):
        assert a[k] == b[k], (ctx, k, a[k], b[k])


def test_sweep_trace_matches_reference_and_is_invisible():
    """Trace-on sweeps equal JAX's trace-on sweeps on every row's state,
    telemetry and decoded ring; the port's trace-off sweep equals its
    trace-on sweep; a different chunking gives the same rings."""
    je, te = engines(fail_grid, packer={"merge": False})
    assert len(te.buckets) >= 2
    jres = je.run(collect="summary", chunk=250, trace=spec(J))
    tres = te.run(collect="summary", chunk=250, trace=spec(T))
    assert_results_equal(je, jres, te, tres, "summary", "traced")
    for c in je.cases:
        for i in range(len(c.seeds)):
            decode_equal(tres.flight_for(c.name, i), jres.flight_for(c.name, i), c.name)
            assert tres.flight_for(c.name, i)["cursor"] > 0
    _, te_off = engines(fail_grid, packer={"merge": False})
    off = te_off.run(collect="summary", chunk=250)
    for bo, bn in zip(off.buckets, tres.buckets):
        assert_states_equal(interop.sim_state_to_numpy(bo.final_state),
                            interop.sim_state_to_numpy(bn.final_state), "on/off")
        np.testing.assert_array_equal(bo.telemetry, bn.telemetry)
        assert bo.trace_rows is None and bn.trace_rows is not None
    _, te2 = engines(fail_grid, packer={"merge": False})
    res2 = te2.run(collect="summary", chunk=97, trace=spec(T))
    for c in te.cases:
        decode_equal(tres.flight_for(c.name), res2.flight_for(c.name), c.name)


def test_recovery_span_matches_recovery_tracker():
    def cases(m):
        topo = m.net.Topology.build(m.cfg)
        fs = m.net.failures.link_down(list(topo.t0_up_queues(0)[:2]), 100, FOREVER)
        return [case(m, "f/reps", m.net.workloads.permutation(32, 64, seed=3), "reps", 700,
                     fs=fs, freezing_timeout=300)]

    _, te = engines(cases)
    res = te.run(collect="summary", trace=spec(T))
    rec = res.telemetry_for("f/reps")["recovery"]
    ev = res.flight_for("f/reps")
    assert rec["first_drop_tick"] >= 100 and rec["recovery_ticks"] > 0
    assert ev["first_drop_tick"] == rec["first_drop_tick"]
    assert ev["first_redeliver_tick"] == rec["first_redeliver_tick"]
    codes = list(ev["code"])
    assert codes.count(ttracer.FAIL_ACTIVE) == 1 and codes.count(ttracer.FAIL_FIRST_DROP) == 1
    fa = codes.index(ttracer.FAIL_ACTIVE)
    assert int(ev["tick"][fa]) == 100 and int(ev["value"][fa]) == 2
    ri = codes.index(ttracer.FAIL_REROUTED)
    assert int(ev["value"][ri]) == rec["recovery_ticks"]
    assert int(ev["tick"][ri]) == rec["first_redeliver_tick"]


def test_trace_requires_summary_mode():
    _, te = engines(lambda m: [case(m, "x", m.net.workloads.permutation(32, 24, seed=0), "ops",
                                    100)])
    with pytest.raises(ValueError, match="summary"):
        te.run(collect="none", trace=spec(T))
    with pytest.raises(ValueError, match="summary"):
        te.bucket_carry(te.buckets[0], "full", None, spec(T))
    with pytest.raises(ValueError, match="flight-recorder"):
        te.run(collect="summary").flight_for("x")
