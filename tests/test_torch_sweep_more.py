"""More of tests/test_sweep.py on the port's ``SweepEngine``, against the
reference's on the CPU (bit for bit, as tests/test_torch_sweep.py): the
AI-collective workloads with their conservation checks, the collect
contract (the same ValueErrors; NotImplementedError for what is not
ported), failure-schedule edge cases, and split groups with padded rows,
gray loss and adaptive routing.  tests/test_torch_sweep_chunks.py
holds the per-row horizons and the chunk primitives."""
import numpy as np
import pytest

from repro_torch.netsim import SweepEngine, TelemetrySpec, WindowedSeries
from sweep_parity import T, case, engines, run_both


def test_collectives_conservation_and_sweep_parity():
    """alltoall / ring_allreduce / butterfly_allreduce over several shape
    buckets: equal to the reference, and at quiescence every message is
    delivered, no packet slot leaks and injected == delivered + drops
    where no timeout fired."""
    ticks = 400

    def wls(m):
        w = m.net.workloads
        return {"ring": w.ring_allreduce(8, 32), "butterfly": w.butterfly_allreduce(8, 32),
                "alltoall": w.alltoall(8, 4, window=2)}

    je, te = engines(lambda m: [case(m, f"coll/{k}", wl, "reps", ticks)
                                for k, wl in wls(m).items()], packer=dict(merge=False))
    assert len(te.buckets) >= 2
    _, tres = run_both(je, te, collect="none")
    sums = tres.summaries()
    for k, wl in wls(T).items():
        name = f"coll/{k}"
        sw, s = tres.state_for(name), sums[name][0]
        assert s.completed == wl.n_conns, k
        np.testing.assert_array_equal(sw.c_delivered[: wl.n_conns].numpy(), wl.msg_pkts)
        assert int(sw.fl_count) == te.serial_sim(name).NP and not sw.c_inflight.any(), k
        drops = s.drops_cong + s.drops_fail
        assert s.injected >= s.delivered
        if s.timeouts == 0:
            assert s.injected == s.delivered + drops, k


def test_sweep_collect_contract():
    """The reference's ValueErrors for an unknown mode, full traces with
    early exit and a telemetry spec outside summary mode; a custom spec
    without the RunSummary channels runs and ``summaries()`` falls back to
    the state path (equal to the reference's); ``flight_for`` of a run
    without ``trace=`` raises the reference's ValueError and a traced run
    decodes; what is not ported raises NotImplementedError: conn-sharding,
    a row mesh."""
    def cases(m):
        return [case(m, "x", m.net.workloads.permutation(32, 32, seed=4), "ops", 100)]

    je, te = engines(cases)
    for kw, match in ((dict(collect="full", early_exit=True), "summary"),
                      (dict(collect="traces"), "collect"),
                      (dict(collect="none", telemetry=TelemetrySpec.default()), "summary"),
                      (dict(collect="none", trace=object()), "summary")):
        with pytest.raises(ValueError, match=match):
            te.run(**kw)
    _, tres = run_both(je, te, collect="summary")
    spec = TelemetrySpec(channels=(WindowedSeries(),))
    res = te.run(collect="summary", telemetry=spec)
    assert "windows" in res.telemetry_for("x")
    assert res.summaries()["x"][0].n_conns == 32  # the state path
    with pytest.raises(ValueError, match="flight-recorder"):
        tres.flight_for("x")
    from repro_torch.netsim import TraceSpec

    assert te.run(collect="summary", trace=TraceSpec()).flight_for("x")["cursor"] > 0
    with pytest.raises(ValueError, match="telemetry"):
        SweepEngine(T.cfg, cases(T), device="cpu").run(collect="none").telemetry_for("x")
    with pytest.raises(KeyError):
        tres.state_for("nope")
    for kw in (dict(conn_devices=2), dict(devices=2)):
        with pytest.raises(NotImplementedError):
            SweepEngine(T.cfg, cases(T), device="cpu", **kw)
    with pytest.raises(ValueError, match="device picks"):
        SweepEngine(T.cfg, cases(T), device="cpu", kernels_backend="pallas")
    SweepEngine(T.cfg, cases(T), device="cpu", devices=1)  # the one device


def test_failure_edge_cases_sweep_vs_reference():
    """An empty schedule, an event past the horizon, overlapping down and
    degraded windows on one queue, and every uplink of a ToR failing one
    after another: equal to the reference row for row."""
    def cases(m):
        topo, f = m.net.Topology.build(m.cfg), m.net.failures
        q0, q1 = int(topo.t0_up_queues(0)[0]), int(topo.t0_up_queues(1)[0])
        wl = m.net.workloads.permutation(32, 48, seed=2)
        FS = m.net.FailureSchedule
        past = FS.concat(f.link_down([q0], 100, 250), f.link_down([q1], 5000, f.FOREVER))
        overlap = FS.concat(f.link_down([q0], 100, 300), f.link_degraded([q0], 200, 450))
        incr = f.incremental_uplink_failures(m.cfg, 0, m.cfg.uplinks_per_tor, 60, 40)
        return [case(m, "e/none", wl, "ops", 500), case(m, "e/past", wl, "ops", 500, fs=past),
                case(m, "e/overlap", wl, "ops", 500, fs=overlap),
                case(m, "e/incr", wl, "reps", 500, fs=incr, freezing_timeout=250)]

    je, te = engines(cases)
    _, tres = run_both(je, te, collect="none")
    s = tres.summaries()["e/incr"][0]
    assert s.drops_fail > 0 or s.completed < 32


def test_split_buckets_pad_rows_gray_loss_and_adaptive():
    """Groups split into sub-buckets that share one program and pad their
    rows (repeating row 0) to a shared count, a gray-loss window (the rows'
    own gray draws), and adaptive RoCE in a bucket of its own (in-network
    routing is static): equal to the reference's sweep, with traces."""
    def cases(m):
        ups = [int(q) for q in m.net.Topology.build(m.cfg).t0_up_queues(0)[:3]]
        f = m.net.failures
        gray = m.net.FailureSchedule.concat(f.gray_loss([ups[0]], 20, 260, 0.3),
                                            f.link_down([ups[1]], 60, f.FOREVER))
        wl = m.net.workloads.permutation(32, 24, seed=8)
        return [case(m, "g/reps", wl, "reps", 300, fs=gray, seeds=(0, 1, 2), freezing_timeout=150),
                case(m, "g/ops", wl, "ops", 300, fs=gray, seeds=(4,)),
                case(m, "g/ecmp", wl, "ecmp", 300, fs=gray),
                case(m, "g/adaptive", wl, "adaptive_roce", 300, fs=gray)]

    je, te = engines(cases, packer=dict(max_rows_per_bucket=3))
    groups = [b.plan.group for b in te.buckets]
    assert len(set(groups)) < len(groups), te.plan.describe()  # a split group
    assert any(b.plan.pad_rows for b in te.buckets), te.plan.describe()
    assert any(b.lb.switch_adaptive for b in te.buckets)
    run_both(je, te, collect="full", chunk=120)
