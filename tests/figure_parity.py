"""Shared helpers of the port's figure tests: the reference's figure
modules and the port's (``repro_torch.bench``), their cell lists compared
field by field, and a figure's shrunk smoke grid run through both sweep
engines as the benchmark harness runs it (``collect="none"``, quiescence
early exit), every row compared bit for bit."""
import dataclasses
import importlib

import numpy as np

import benchmarks.common as jcommon
from repro.configs.arcane_paper import FATTREE_32_CI as J_CFG
from repro.netsim import SweepEngine as JEngine
from repro_torch.bench import common as tcommon
from repro_torch.configs.arcane_paper import FATTREE_32_CI as T_CFG
from repro_torch.netsim import SweepEngine as TEngine
from sweep_parity import assert_results_equal
from test_torch_sweep_pack import plan_fields

FIGURES = {
    "fig02": "fig02_symmetric", "fig03": "fig03_asym_micro", "fig04": "fig04_asym_macro",
    "fig05": "fig05_background", "fig06": "fig06_failures_micro",
    "fig07": "fig07_failures_macro", "fig08": "fig08_extreme",
}


def modules(fig: str):
    """(the reference's figure module, the port's)."""
    name = FIGURES[fig]
    return (importlib.import_module(f"benchmarks.{name}"),
            importlib.import_module(f"repro_torch.bench.{name}"))


def _arrays_equal(a, b, where):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), where


def assert_cases_equal(tcases, jcases):
    """Names, horizons, LB names and kwargs, seeds, and the workload,
    failure and watch arrays of every cell."""
    assert [c.name for c in tcases] == [c.name for c in jcases]
    for t, j in zip(tcases, jcases):
        w = t.name
        assert (t.ticks, t.lb, t.lb_kwargs, t.seeds) == (j.ticks, j.lb, j.lb_kwargs, j.seeds), w
        for f in ("src", "dst", "msg_pkts", "start", "dep"):
            _arrays_equal(getattr(t.workload, f), getattr(j.workload, f), f"{w}: workload.{f}")
        assert t.workload.name == j.workload.name, w
        assert (t.failures is None) == (j.failures is None), w
        if j.failures is not None:
            for f in ("queue", "start", "end", "kind", "param"):
                _arrays_equal(getattr(t.failures, f), getattr(j.failures, f), f"{w}: failures.{f}")
        assert (t.watch_queues is None) == (j.watch_queues is None), w
        if j.watch_queues is not None:
            _arrays_equal(t.watch_queues, j.watch_queues, f"{w}: watch")


def both_cases(fig, smoke, full, monkeypatch):
    """The figure's cells in both packages, at CI or paper scale (the
    reference reads its scale from ``benchmarks.common.FULL``)."""
    jmod, tmod = modules(fig)
    monkeypatch.setattr(jcommon, "FULL", full)
    jcfg, tcfg = jcommon.ci_cfg(), tcommon.ci_cfg(full)
    jd, td = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
    for backend in ("arrivals_backend", "kernels_backend"):
        jd.pop(backend), td.pop(backend)
    assert td == jd
    return jmod.cases(jcfg, smoke=smoke), tmod.cases(tcfg, smoke=smoke, full=full)


def shrink(cases, factor=16, floor=300):
    """tests/test_figure_parity.py's ``_shrink``: horizons scaled down
    (their heterogeneity kept), the seed axis pinned to seed 0."""
    return [dataclasses.replace(c, ticks=max(floor, c.ticks // factor), seeds=(0,))
            for c in cases]


def shrunk_grid_parity(fig, max_buckets=4):
    """The figure's smoke cells at FATTREE_32_CI, shrunk, through both
    engines (``collect="none"``, early exit): the same plan and rows."""
    jmod, tmod = modules(fig)
    je = JEngine(J_CFG, shrink(jmod.cases(J_CFG, smoke=True)))
    te = TEngine(T_CFG, shrink(tmod.cases(T_CFG, smoke=True, full=False)), device="cpu")
    assert plan_fields(te.plan) == plan_fields(je.plan)
    assert len(te.buckets) <= max_buckets, te.plan.describe()
    jres = je.run(collect="none", early_exit=True)
    tres = te.run(collect="none", early_exit=True)
    assert_results_equal(je, jres, te, tres, "none", fig)
    return te, tres
