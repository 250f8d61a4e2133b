"""The port's sweep packer (``repro_torch.netsim.sweep.pack``), pure host
code, against the reference's: the same ``PackPlan`` (every bucket's key,
cells, group, row counts, device count and costs, and ``describe()``) on
the random grids of tests/test_sweep.py's property test, on its merge /
split cases and under its measured-cost model; and the neutral padding
helpers (``_pad_workload``, ``_host_conns``, ``_pad_watch``,
``truncate_dead`` + ``pad_to``) giving the reference's arrays.  Exact
equality throughout."""
import dataclasses
import os

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # container image has no hypothesis; shim keeps tests live
    from _hypothesis_fallback import given, settings, st

import repro.netsim.sweep as jsweep
import repro_torch.netsim.sweep as tsweep
from repro.configs.arcane_paper import FATTREE_32_CI as J_CFG
from repro.netsim import FailureSchedule as JFS
from repro.netsim import failures as jfail
from repro.netsim import workloads as jwl
from repro_torch.configs.arcane_paper import FATTREE_32_CI as T_CFG
from repro_torch.configs.arcane_paper import FATTREE_128 as T_128
from repro_torch.netsim import FailureSchedule as TFS
from repro_torch.netsim import failures as tfail
from repro_torch.netsim import workloads as twl

GRID = st.lists(
    st.tuples(
        st.integers(1, 20),  # ticks / 100
        st.booleans(),  # adaptive
        st.integers(0, 5),  # log2(nc / 8)
        st.integers(1, 8),  # log2 msg
        st.integers(0, 6),  # log2 f
        st.integers(0, 4),  # log2 w
        st.integers(1, 5),  # rows (seeds)
        st.integers(0, 7),  # nc_exact = nc - this (shrink-to-fit below the pow2)
    ),
    min_size=1,
    max_size=24,
)
PACKER_SPEC = st.tuples(
    st.integers(4, 64),  # max_rows_per_bucket
    st.integers(0, 3),  # waste budget index
    st.booleans(),  # merge on/off
)
BUDGETS = [0.0, 0.1, 0.25, 1.0]


def shapes_for(mod, grid):
    return [
        mod.CellShape(name=f"c{i}", ticks=100 * t, adaptive=ad, nc=8 << k_nc, msg=2 << k_msg,
                      f=1 << k_f, w=1 << k_w, rows=rows, nc_exact=(8 << k_nc) - d)
        for i, (t, ad, k_nc, k_msg, k_f, k_w, rows, d) in enumerate(grid)
    ]


def plan_fields(plan) -> tuple:
    """A PackPlan as plain data (its classes differ between the packages)."""
    return (
        tuple(dataclasses.astuple(b) for b in plan.buckets),
        plan.n_devices,
        dataclasses.astuple(plan.packer),
        plan.merge_waste,
        tuple(sorted(plan.group_merge_waste().items())),
        tuple(b.est_cost for b in plan.buckets),
        tuple(b.device_rows for b in plan.buckets),
        plan.describe(),
    )


def both_plans(grid_shapes, packer_kw, n_devices, measured=None, cfgs=(J_CFG, T_CFG)):
    jp = jsweep.pack(cfgs[0], shapes_for(jsweep, grid_shapes), jsweep.PackerConfig(**packer_kw),
                     n_devices, measured_costs=measured)
    tp = tsweep.pack(cfgs[1], shapes_for(tsweep, grid_shapes), tsweep.PackerConfig(**packer_kw),
                     n_devices, measured_costs=measured)
    return jp, tp


@settings(max_examples=80, deadline=None)
@given(GRID, PACKER_SPEC, st.integers(0, 2))
def test_pack_equals_reference_on_random_grids(grid, packer_spec, ndev_log2):
    """tests/test_sweep.py::test_packer_plan_properties's grids (with
    shrink-to-fit conn counts below the pow2 grid): the port's plan is the
    reference's, field for field, at 1, 2 and 4 devices."""
    max_rows, b_i, merge = packer_spec
    kw = dict(max_rows_per_bucket=max_rows, waste_budget=BUDGETS[b_i], merge=merge)
    jp, tp = both_plans(grid, kw, 2**ndev_log2)
    assert plan_fields(tp) == plan_fields(jp)
    assert tsweep.pack(T_CFG, shapes_for(tsweep, grid), tsweep.PackerConfig(**kw),
                       2**ndev_log2) == tp  # deterministic


@pytest.mark.parametrize("case", ["failure_axis", "nc_mismatch", "measured_flip",
                                  "measured_keep", "measured_harvest"])
def test_pack_merge_and_measured_cases_equal_reference(case):
    """The merge / split cases of test_packer_merges_failure_axis_... and
    the measured-cost cases of test_packer_measured_costs_replan_... :
    the same plan in both packages."""
    kw, measured = {}, None
    if case == "failure_axis":
        grid = [(10, False, 3, 7, k, 4, 1, 0) for k in (3, 4, 5)]
    elif case == "nc_mismatch":
        grid = [(40, False, 3, 7, 0, 4, 3, 0), (40, False, 0, 6, 0, 4, 3, 0)]
    else:
        grid = [(10, False, 2, 6, 0, 4, 2, 0), (10, False, 3, 6, 0, 4, 2, 4)]
        measured = {
            "measured_flip": {(False, 32, 128, 1, 16): 500.0, (False, 64, 128, 1, 16): 500.0},
            "measured_keep": {(False, 32, 128, 1, 16): 100.0, (False, 64, 128, 1, 16): 1000.0},
            "measured_harvest": {(False, 64, 128, 1, 16): 800.0},
        }[case]
    jp, tp = both_plans(grid, kw, 1, measured)
    assert plan_fields(tp) == plan_fields(jp)
    if case == "failure_axis":
        assert len(tp.buckets) == 1 and tp.buckets[0].key[4] == 32
    if case in ("nc_mismatch", "measured_keep"):
        assert len(tp.buckets) == 2
    if case == "measured_flip":
        assert len(tp.buckets) == 1


def test_cost_model_and_measured_harvest_equal_reference():
    """``est_row_tick_cost`` at the paper's and the CI fabric, and
    ``measured_costs_from_bench`` on hand-made rows (malformed ones
    skipped) and on the reference's committed BENCH file."""
    for jc, tc in ((J_CFG, T_CFG), (jsweep_cfg_128(), T_128)):
        for nc, msg, f, w in ((8, 2, 1, 1), (128, 4096, 2, 16), (480, 8, 4, 8)):
            assert tsweep.est_row_tick_cost(tc, nc, msg, f, w) == \
                jsweep.est_row_tick_cost(jc, nc, msg, f, w)
    rows = {
        "figX/bucket/g0.0": {"bucket_key": [1000, 0, 60, 128, 1, 16],
                             "measured_row_tick_us": 700.0},
        "figX/bucket/g0.1": {"bucket_key": [1000, 0, 64, 128, 1, 16],
                             "measured_row_tick_us": 900.0},
        "figX/sweep_total": {"ticks_per_sec": 1.0},
        "figY/bucket/bad": {"bucket_key": [1, 2], "measured_row_tick_us": 1},
        "figY/bucket/null": {"bucket_key": [1000, 0, None, 128, 1, 16],
                             "measured_row_tick_us": 5.0},
        "figY/bucket/str": {"bucket_key": "oops", "measured_row_tick_us": "fast"},
    }
    assert tsweep.measured_costs_from_bench(rows) == jsweep.measured_costs_from_bench(rows)
    bench = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "BENCH_netsim.json")
    got = tsweep.measured_costs_from_bench(bench)
    assert got and got == jsweep.measured_costs_from_bench(bench)
    assert tsweep.measured_costs_from_bench("/nonexistent/path.json") == {}


def jsweep_cfg_128():
    from repro.configs.arcane_paper import FATTREE_128

    return FATTREE_128


def _workloads(m):
    return {
        "permutation": m.permutation(32, 48, seed=1),
        "incast": m.incast(32, 5, 48),
        "ring": m.ring_allreduce(8, 32),
        "alltoall": m.alltoall(8, 4, window=2),
        "websearch": m.websearch_trace(32, 0.6, 300, seed=2, max_pkts=512),
    }


@pytest.mark.parametrize("name", ["permutation", "incast", "ring", "alltoall", "websearch"])
def test_padding_helpers_equal_reference(name):
    """A workload padded to the next powers of two (inert conns on the
    least-loaded hosts, start ``NEVER_TICK``), its host -> conn table, a
    watch list padded with its last queue: the reference's arrays."""
    jw, tw = _workloads(jwl)[name], _workloads(twl)[name]
    assert tsweep.NEVER_TICK == jsweep.NEVER_TICK
    for nc in sorted({tw.n_conns, tsweep._pow2(tw.n_conns), tsweep._pow2(tw.n_conns) * 2}):
        jp, tp = jsweep._pad_workload(jw, nc, 32), tsweep._pad_workload(tw, nc, 32)
        for f in ("src", "dst", "msg_pkts", "start", "dep"):
            a, b = getattr(tp, f), getattr(jp, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (nc, f)
        cph = int(np.bincount(tp.src, minlength=32).max())
        for extra in (0, 2):
            np.testing.assert_array_equal(tsweep._host_conns(tp, 32, cph + extra),
                                          jsweep._host_conns(jp, 32, cph + extra))
    watch = np.asarray([40, 41, 45], np.int32)
    for w in (3, 4, 16):
        a, b = tsweep._pad_watch(watch, w), jsweep._pad_watch(watch, w)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    np.testing.assert_array_equal(tsweep._pad_watch(np.zeros(0, np.int32), 2),
                                  jsweep._pad_watch(np.zeros(0, np.int32), 2))


@pytest.mark.parametrize("horizon", [0, 120, 600, 5000])
def test_truncate_dead_and_pad_to_equal_reference(horizon):
    """Live failure rows (a permanent one, windows before and past the
    horizon, overlapping kinds, gray loss, inert pads) truncated at the
    horizon and padded to the next power of two: the reference's rows."""
    def sched(m, fail):
        return m.concat(
            fail.link_down([1], 50, fail.FOREVER),
            fail.link_down([2], 1000, 2000),
            fail.link_degraded([3], 100, 700),
            fail.gray_loss([4], 10, 350, 0.3),
            fail.link_down([5], 100, 400),
        ).pad_to(8)
    js, ts = sched(JFS, jfail), sched(TFS, tfail)
    jl, tl = jfail.truncate_dead(js, horizon), tfail.truncate_dead(ts, horizon)
    size = tsweep._pow2(max(len(tl), 1))
    jp, tp = jl.pad_to(size), tl.pad_to(size)
    for f in ("queue", "start", "end", "kind", "param"):
        for a, b in ((getattr(tl, f), getattr(jl, f)), (getattr(tp, f), getattr(jp, f))):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("bad", ["no_cells", "duplicate_names", "no_devices"])
def test_pack_rejects_bad_input(bad):
    """Where the reference asserts (no cells, a name twice, no device), the
    port raises ``ValueError``."""
    shapes = shapes_for(tsweep, [(10, False, 0, 1, 0, 0, 1, 0)] * 2)
    if bad == "no_cells":
        shapes, n_devices = [], 1
    elif bad == "duplicate_names":
        shapes, n_devices = [shapes[0], shapes[0]], 1
    else:
        n_devices = 0
    with pytest.raises(ValueError):
        tsweep.pack(T_CFG, shapes, tsweep.PackerConfig(), n_devices)
