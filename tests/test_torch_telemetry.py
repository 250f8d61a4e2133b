"""The port's telemetry (``repro_torch.netsim.telemetry``,
``FleetRunner.run_summary``, ``metrics.summarize_sketch``) against the JAX
package on the CPU, where every histogram's ``seg_sum`` runs its plain
version.

* The carry: for REPS and OPS, with and without a failure schedule, with
  the default spec, a spec with cohorts and one with an explicit stride,
  each row of the port's ``run_summary`` carry equals the JAX
  ``FleetRunner.run_summary`` row bit for bit, and so do the finalized
  channels and the sketch-built ``RunSummary`` rows.
* ``summarize_sketch`` on the same finalized channels gives JAX's rows.
* The non-sweep tests of tests/test_telemetry.py on the port: percentiles
  within one bin, wide sums past int32, unit bins exact, fleet summary
  against ``summaries``, the recovery tracker, cohort partition and
  validation, an empty sketch giving NaN, both ``stream_rows`` tests; and
  tests/test_soak.py's chunked resume of ``run_summary``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # container image has no hypothesis; shim keeps tests live
    from _hypothesis_fallback import given, settings, st

from repro.configs.arcane_paper import FATTREE_32_CI as J_CFG
from repro.core import make_lb as j_make_lb
from repro.netsim import FleetRunner as JFleet
from repro.netsim import TelemetrySpec as JSpec
from repro.netsim import Topology as JTopology
from repro.netsim import failures as jfail
from repro.netsim import metrics as jmetrics
from repro.netsim import telemetry as jtel
from repro.netsim import workloads as jwl
from repro_torch.configs.arcane_paper import FATTREE_32_CI as T_CFG
from repro_torch.core import make_lb as t_make_lb
from repro_torch.netsim import FleetRunner as TFleet
from repro_torch.netsim import (
    Histogram, Probe, RunningScalars, Simulator, TelemetrySpec, Topology, failures as tfail,
    interop, metrics as tmetrics, sketch_bin_index, sketch_percentile, us_to_ticks,
    workloads as twl,
)
from repro_torch.netsim import telemetry as ttel
from repro_torch.netsim.engine import N_STATS

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

CFG = T_CFG
FOREVER = 2**30


def assert_same(a, b, where=""):
    """Finalized channel values, port (``a``) against JAX (``b``): equal
    ints, floats (NaN equals NaN) and arrays (values and dtype)."""
    if isinstance(b, dict):
        assert a.keys() == b.keys(), where
        for k in b:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(b, float):
        assert isinstance(a, float) and (a == b or (np.isnan(a) and np.isnan(b))), (where, a, b)
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def summary_dict(s):
    return {k: ("nan" if isinstance(v, float) and np.isnan(v) else v)
            for k, v in dataclasses.asdict(s).items()}


# ---------------------------------------------------------------------------
# The carry against JAX's FleetRunner.run_summary.
# ---------------------------------------------------------------------------

def _fg_bg(mod):
    wl, bg = mod.permutation_with_background(32, 24, 0.25, seed=4)
    return wl, {"fg": tuple(int(i) for i in np.nonzero(~bg)[0]),
                "bg": tuple(int(i) for i in np.nonzero(bg)[0])}


CASES = {
    # lb, workload, failures, spec, ticks, seeds
    "reps/failures/default": (
        "reps", lambda m: m.permutation(32, 128, seed=2),
        lambda m, ups: m.link_down(ups[:2], 80, FOREVER),
        lambda S, cohorts: S.default(), 400, (0, 3)),
    "ops/no-failures/cohorts": (
        "ops", lambda m: _fg_bg(m)[0], None,
        lambda S, cohorts: S.default().with_cohorts(cohorts), 360, (1, 2)),
    "reps/no-failures/stride": (
        "reps", lambda m: m.permutation(32, 48, seed=1), None,
        lambda S, cohorts: S.default(stride=37), 400, (0, 5)),
    "ops/failures/cohorts+stride": (
        "ops", lambda m: _fg_bg(m)[0],
        lambda m, ups: m.FailureSchedule.concat(m.link_down(ups[:2], 10, 300),
                                                m.link_degraded([ups[3]], 5, 200)),
        lambda S, cohorts: S.default(stride=50).with_cohorts(cohorts, fct_bins=16), 420, (4,)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_run_summary_carry_matches_jax_row_by_row(case):
    lbn, wl_of, fs_of, spec_of, ticks, seeds = CASES[case]
    ups = [int(q) for q in JTopology.build(J_CFG).t0_up_queues(0)]
    kw = dict(evs_size=J_CFG.evs_size)
    if lbn == "reps":
        kw["freezing_timeout"] = 300
    cohorts = _fg_bg(twl)[1]
    jf = JFleet(J_CFG, wl_of(jwl), j_make_lb(lbn, **kw),
                failures=fs_of(jfail, ups) if fs_of else None, seeds=seeds)
    tf = TFleet(T_CFG, wl_of(twl), t_make_lb(lbn, **kw),
                failures=fs_of(tfail, ups) if fs_of else None, seeds=seeds, device="cpu")
    jst, jt = jf.run_summary(ticks, spec_of(JSpec, cohorts))
    tst, tt = tf.run_summary(ticks, spec_of(TelemetrySpec, cohorts))
    assert tt.tel.dtype == np.int32 and tt.tel.shape == np.asarray(jt.tel).shape
    assert tt.nbytes_per_run == jt.nbytes_per_run
    for i in range(len(seeds)):
        np.testing.assert_array_equal(tt.tel[i], np.asarray(jt.tel[i]), err_msg=f"{case} row {i}")
        assert_same(tt.result(i), jt.result(i), f"{case} row {i}")
    assert [summary_dict(s) for s in tt.summaries()] == [summary_dict(s) for s in jt.summaries()]
    # the states the summary path leaves are the plain path's
    np.testing.assert_array_equal(tst.s_stats.numpy(), np.asarray(jst.s_stats))
    if fs_of:
        assert int(tst.s_stats[:, 1].min()) > 0, "the failure must drop packets"


def test_summarize_sketch_rows_match_jax():
    """The same finalized channels give JAX's ``RunSummary`` (completions,
    an empty sketch's NaNs, counters), and a spec without the summary
    channels raises in both."""
    rs = np.random.RandomState(7)
    edges = np.geomspace(1.0, 900.0, 33).astype(np.float32).astype(np.float64)
    for completed in (0, 1, 57):
        counts = np.zeros(32, np.int64)
        if completed:
            np.add.at(counts, rs.randint(0, 32, size=completed), 1)
        totals = rs.randint(0, 5000, size=N_STATS)
        tel = {
            "counters": dict({n: int(totals[j]) for j, n in enumerate(ttel.STAT_NAMES)},
                             totals=totals),
            "scalars": {"fct_count": completed, "done_tick_max": 700 if completed else -1,
                        "mean_fct_ticks": 301.25 if completed else float("nan")},
            "fct_hist": {"counts": counts, "edges": edges, "zeros": 0},
        }
        a = tmetrics.summarize_sketch(tel, "cell", "reps", 57)
        b = jmetrics.summarize_sketch(tel, "cell", "reps", 57)
        assert summary_dict(a) == summary_dict(b)
    with pytest.raises(ValueError, match="fct_hist"):
        tmetrics.summarize_sketch({"counters": {}, "scalars": {}}, "x", "reps", 1)


# ---------------------------------------------------------------------------
# Mirrors of tests/test_telemetry.py (the non-sweep tests).
# ---------------------------------------------------------------------------

VALUES = st.lists(st.integers(1, 5000), min_size=1, max_size=400)


@settings(max_examples=60, deadline=None)
@given(VALUES, st.integers(4, 96), st.integers(0, 1), st.integers(0, 300), st.integers(0, 3))
def test_sketch_percentiles_within_one_bin(values, n_bins, log_spacing, zeros, q_i):
    """Histogram percentiles of random traces are within the width of the
    exact value's bin of the exact percentile (zeros reconstructed as the
    qlen channel does), and equal JAX's ``sketch_percentile``."""
    q = [50.0, 90.0, 99.0, 99.9][q_i]
    vals = np.asarray(values, np.int64)
    hi = max(int(vals.max()) + 1, 2)
    space = np.geomspace if log_spacing else np.linspace
    edges64 = space(1.0, hi, n_bins + 1).astype(np.float32).astype(np.float64)
    counts = np.zeros((n_bins,), np.int64)
    for v in vals:
        counts[sketch_bin_index(edges64, v)] += 1
    est = sketch_percentile(counts, edges64, q, zeros=zeros)
    assert est == jtel.sketch_percentile(counts, edges64, q, zeros=zeros)
    exact = float(np.percentile(np.concatenate([np.zeros((zeros,), np.int64), vals]), q,
                                method="higher"))
    if exact == 0.0:
        assert est == 0.0
        return
    b = sketch_bin_index(edges64, exact)
    assert abs(est - exact) <= edges64[b + 1] - edges64[b] + 1e-9, (est, exact)


def _probe(B, nq, nc, q_len, now=0):
    z = lambda *s: torch.zeros(s, dtype=torch.int32)
    return Probe(now=now, q_len=q_len, served=z(B, nq), watch_qlen=q_len, watch_served=z(B, nq),
                 stats_delta=z(B, N_STATS), done_now=torch.zeros((B, nc), dtype=torch.bool),
                 fct=z(B, nc))


def _channel_views(ch, built, B):
    """One channel's fields as ``(B, *shape)`` views of a fresh carry."""
    off, views = 0, {}
    slots = ch.slots(built)
    size = sum(int(np.prod(s)) if s else 1 for s in slots.values())
    flat = torch.zeros((B, size), dtype=torch.int32)
    init = ch.init(built)
    for field, shape in slots.items():
        n = int(np.prod(shape)) if shape else 1
        flat[:, off:off + n] = torch.as_tensor(np.asarray(init[field]).reshape(-1))
        views[field] = flat[:, off:off + n].view(B, *shape)
        off += n
    return flat, views


def test_running_scalar_wide_sums_past_int32():
    """The (hi, lo) split sums stay exact past 2^31 (4e8 per tick for 8
    ticks), and a histogram's lo word at the carry threshold rolls into hi
    without losing a count; the carry is int32 throughout."""
    class FakeSim:
        NQ = 4
        device = torch.device("cpu")

        class cfg:
            queue_capacity = 48

        class wl:
            n_conns = 2

    ch = RunningScalars()
    built = ch.build(FakeSim(), 8)
    flat, v = _channel_views(ch, built, 2)
    probe = _probe(2, 4, 2, torch.full((2, 4), 10**8, dtype=torch.int32))
    for _ in range(8):
        ch.update(built, v, probe)
    assert flat.dtype == torch.int32
    row = {k: x[1].numpy() for k, x in v.items()}
    assert ttel._wide_total(row["qlen_sum_hi"], row["qlen_sum_lo"]) == 8 * 4 * 10**8
    assert ch.finalize(built, row, horizon=8)["mean_qlen"] == 10**8

    h = Histogram(source="qlen", n_bins=8, spacing="linear")
    hb = h.build(FakeSim(), 100)
    hflat, hv = _channel_views(h, hb, 1)
    hv["counts_lo"].fill_((1 << ttel.SUM_SHIFT) - 2)
    before = h.finalize(hb, {k: x[0].numpy().copy() for k, x in hv.items()}, 0)["counts"]
    h.update(hb, hv, _probe(1, 4, 2, torch.full((1, 4), 10, dtype=torch.int32)))
    assert int(hv["counts_lo"].max()) < (1 << ttel.SUM_SHIFT)
    after = h.finalize(hb, {k: x[0].numpy() for k, x in hv.items()}, 0)["counts"]
    assert (after - before).sum() == 4  # all 4 observations kept


def test_sketch_percentile_unit_bins_exact():
    """Unit-width linear bins make sketch percentiles exact on integers."""
    rng = np.random.default_rng(0)
    vals = rng.integers(1, 48, size=500)
    edges = np.arange(1.0, 49.0)
    counts = np.zeros((47,), np.int64)
    for v in vals:
        counts[sketch_bin_index(edges, v)] += 1
    for q in (50, 90, 99):
        assert sketch_percentile(counts, edges, q) == float(np.percentile(vals, q,
                                                                           method="higher")), q


def test_fleet_summary_bit_parity_and_counters():
    """run_summary's sketch summaries equal the state summaries on every
    exact field, per seed; the counters telescope to ``s_stats``; the
    scalars equal the final state's FCTs; the windows' deliveries add up."""
    wl = twl.permutation(32, 48, seed=1)
    fleet = TFleet(CFG, wl, t_make_lb("reps", evs_size=CFG.evs_size), seeds=(0, 3, 7),
                   device="cpu")
    states, tel = fleet.run_summary(600)
    ref, sketch = fleet.summaries(states), tel.summaries()
    exact = ("completed", "runtime_ticks", "mean_fct_ticks", "drops_cong", "drops_fail",
             "timeouts", "delivered", "injected", "ecn_marks", "unprocessed_events",
             "alloc_fails")
    for i in range(fleet.n_runs):
        r = tel.result(i)
        for f in exact:
            assert getattr(ref[i], f) == getattr(sketch[i], f), (i, f)
        edges = r["fct_hist"]["edges"]
        assert abs(sketch_bin_index(edges, ref[i].p99_fct_ticks)
                   - sketch_bin_index(edges, sketch[i].p99_fct_ticks)) <= 1
        st_i = fleet.state_at(states, i)
        np.testing.assert_array_equal(st_i.s_stats.numpy(), r["counters"]["totals"])
        done, done_tick = st_i.c_done.numpy(), st_i.c_done_tick.numpy()
        fct = (done_tick - wl.start)[done]
        s = r["scalars"]
        assert s["fct_min"] == (int(fct.min()) if len(fct) else -1)
        assert s["fct_max"] == (int(fct.max()) if len(fct) else -1)
        assert s["fct_sum"] == int(fct.sum())
    r0 = tel.result(0)
    assert r0["windows"]["delivered"].sum() == sketch[0].delivered
    assert r0["windows"]["util"].shape == r0["windows"]["mean_qlen"].shape


def test_recovery_tracker_failure_latency():
    """Permanent uplink failures: the tracker pins the first failure drop in
    the failure window and a successful delivery shortly after it."""
    topo = Topology.build(CFG)
    fail_start = 100
    fs = tfail.link_down(list(topo.t0_up_queues(0)[:2]), fail_start, tfail.FOREVER)
    fleet = TFleet(CFG, twl.permutation(32, 256, seed=2),
                   t_make_lb("reps", evs_size=CFG.evs_size, freezing_timeout=300),
                   failures=fs, device="cpu")
    _, tel = fleet.run_summary(500)
    rec, s = tel.result(0)["recovery"], tel.summaries()[0]
    assert s.drops_fail > 0, "scenario must produce failure drops"
    assert rec["first_drop_tick"] >= fail_start
    assert rec["first_redeliver_tick"] > rec["first_drop_tick"]
    assert 0 < rec["recovery_ticks"] <= us_to_ticks(100), rec
    assert rec["recovery_us"] < 100.0


def test_cohort_masks_partition_fct_sketches():
    """``with_cohorts`` channels partition the global ones exactly, and each
    cohort's FCT sum equals the final state's FCTs of its conn ids."""
    wl, cohorts = _fg_bg(twl)
    spec = TelemetrySpec.default().with_cohorts(cohorts)
    fleet = TFleet(CFG, wl, t_make_lb("reps", evs_size=CFG.evs_size), device="cpu")
    states, res = fleet.run_summary(360, spec)
    tel = res.result(0)
    total = int(tel["fct_hist"]["counts"].sum())
    fg_n, bg_n = (int(tel[f"fct_hist_{c}"]["counts"].sum()) for c in ("fg", "bg"))
    assert total == wl.n_conns, "baseline grid must complete"
    assert (fg_n, bg_n) == (len(cohorts["fg"]), len(cohorts["bg"]))
    assert tel["scalars_fg"]["fct_count"] == fg_n and tel["scalars_bg"]["fct_count"] == bg_n
    assert tel["scalars_fg"]["fct_sum"] + tel["scalars_bg"]["fct_sum"] == tel["scalars"]["fct_sum"]
    fct = states.c_done_tick[0].numpy() - wl.start
    for c in ("fg", "bg"):
        assert tel[f"scalars_{c}"]["fct_sum"] == int(fct[list(cohorts[c])].sum())
        assert tel[f"scalars_{c}"]["fct_max"] <= tel["scalars"]["fct_max"]


def test_sketch_percentile_empty_is_nan_never_zero():
    edges = np.linspace(1.0, 10.0, 5)
    assert np.isnan(sketch_percentile(np.zeros((4,), np.int64), edges, 99.0))
    assert sketch_percentile(np.zeros((4,), np.int64), edges, 99.0, zeros=7) == 0.0
    for q, kw, msg in ((101.0, {}, "q must be"), (-0.5, {}, "q must be"),
                       (50.0, {"zeros": -1}, "zeros")):
        with pytest.raises(ValueError, match=msg):
            sketch_percentile(np.ones((4,), np.int64), edges, q, **kw)
    with pytest.raises(ValueError, match="non-negative"):
        sketch_percentile(np.asarray([3, -1, 2]), edges, 50.0)
    assert sketch_percentile(np.asarray([1, 0, 0, 0]), edges, 0.0) == edges[0]
    assert sketch_percentile(np.asarray([0, 0, 0, 1]), edges, 100.0) == edges[3]


def _stream_chunks(ticks, stride, cut_sets):
    """One run in chunks at every boundary of ``cut_sets`` (``run_summary``
    resumed at each), and for each cut set the ``stream_rows`` emissions of
    its own tiling, drained from the carry at its boundaries."""
    fleet = TFleet(CFG, twl.permutation(32, 24, seed=1), t_make_lb("reps", evs_size=CFG.evs_size),
                   device="cpu")
    spec = TelemetrySpec.default(stride=stride)
    states, tel, t0, at = None, None, 0, {}
    for t1 in sorted({t for cuts in cut_sets for t in cuts}):
        states, res = fleet.run_summary(t1 - t0, spec, states=states, tel=tel, t0=t0,
                                        horizon=ticks)
        tel = at[t1] = res.tel
        t0 = t1
    prog = res.prog
    emitted = [[prog.stream_rows(at[t1][0], t0, t1) for t0, t1 in zip([0] + cuts[:-1], cuts)]
               for cuts in cut_sets]
    return prog, tel[0], emitted


def test_stream_rows_tiling_concatenates_to_one_shot():
    """Any chunk tiling of [0, ticks) emits adjacent window ranges whose
    concatenation equals the one-shot decode."""
    ticks, stride = 360, 24
    cut_sets = ([360], [120, 240, 360], [97, 247, 360], [1, 359, 360])
    prog, flat, emitted = _stream_chunks(ticks, stride, cut_sets)
    one = prog.stream_rows(flat, 0, ticks)
    assert set(one) == {"windows"}
    for cuts, em in zip(cut_sets, emitted):
        ranges = [e["windows"] for e in em if e]
        lo = 0
        for r in ranges:
            assert r["lo"] == lo, cuts
            lo = r["hi"]
        assert lo == one["windows"]["hi"] == ticks // stride
        for k in ("util", "qlen_sum", "stats"):
            np.testing.assert_array_equal(np.concatenate([r[k] for r in ranges]),
                                          one["windows"][k], err_msg=f"{cuts}:{k}")


def test_stream_rows_partial_last_window_completes_at_horizon():
    """A horizon that is not a stride multiple flushes the partial last
    window once t1 reaches it, and never before."""
    ticks, stride = 350, 24  # 15 windows, the last one [336, 350)
    prog, flat, (emitted,) = _stream_chunks(ticks, stride, ([340, 350],))
    first, second = emitted[0]["windows"], emitted[1]["windows"]
    assert first["hi"] == 340 // 24
    assert second["lo"] == first["hi"]
    assert second["hi"] == -(-ticks // stride)
    one = prog.stream_rows(flat, 0, ticks)["windows"]
    np.testing.assert_array_equal(np.concatenate([first["util"], second["util"]]), one["util"])


def test_cohort_mask_validation():
    """Out-of-range cohort ids are rejected at program build, and
    ``conn_filter`` composes only with the FCT source; duplicate keys and an
    empty spec raise."""
    sim = Simulator(CFG, twl.permutation(32, 8, seed=0), t_make_lb("reps"), device="cpu")
    with pytest.raises(ValueError, match="conn"):
        TelemetrySpec(channels=(RunningScalars(name="s_x", conn_filter=(99,)),)).build(sim, 100)
    with pytest.raises(ValueError, match="fct"):
        TelemetrySpec(channels=(Histogram(source="qlen", name="q_x", conn_filter=(0,)),)).build(
            sim, 100)
    with pytest.raises(ValueError, match="duplicate"):
        TelemetrySpec(channels=(RunningScalars(), RunningScalars())).build(sim, 100)
    with pytest.raises(ValueError, match="empty"):
        TelemetrySpec().build(sim, 100)


# ---------------------------------------------------------------------------
# tests/test_soak.py's chunked resume of the fleet summary path.
# ---------------------------------------------------------------------------

def test_fleet_run_summary_chunked_resume_bit_exact():
    """``run_summary(100, horizon=300)`` then ``run_summary(200, states,
    tel, t0=100, horizon=300)`` equals one ``run_summary(300)``: the carry,
    every state leaf and the summaries; the given carry is left as it was.
    The one call's carry equals JAX's."""
    lb = lambda make: make("reps", evs_size=CFG.evs_size)
    wl = twl.permutation(32, 24, seed=1)
    fleet = TFleet(CFG, wl, lb(t_make_lb), seeds=(0, 1), device="cpu")
    st_g, tel_g = fleet.run_summary(300)
    st_a, tel_a = fleet.run_summary(100, horizon=300)
    kept = tel_a.tel.copy()
    st_b, tel_b = fleet.run_summary(200, states=st_a, tel=tel_a.tel, t0=100, horizon=300)
    np.testing.assert_array_equal(tel_a.tel, kept)
    np.testing.assert_array_equal(tel_g.tel, tel_b.tel)
    for i in range(fleet.n_runs):
        a, b = (interop.sim_state_to_numpy(fleet.state_at(x, i)) for x in (st_g, st_b))
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), (i, k)
    assert repr(tel_g.summaries()) == repr(tel_b.summaries())
    jfleet = JFleet(J_CFG, jwl.permutation(32, 24, seed=1), lb(j_make_lb), seeds=(0, 1))
    _, jt = jfleet.run_summary(100, horizon=300)
    np.testing.assert_array_equal(tel_a.tel, np.asarray(jt.tel))
