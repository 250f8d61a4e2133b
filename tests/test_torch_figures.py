"""The port's figure grids (``repro_torch.bench``) against the reference's
``benchmarks/`` modules: every grid figure's cell list (fig02-fig08, smoke
and whole, at CI and at paper scale) equals the reference's field by
field, and the shrunk smoke grids of tests/test_figure_parity.py (fig03,
fig05, fig06 here; fig04, fig07, fig08 in
tests/test_torch_figures_macro.py) give the reference's plan and rows bit
for bit, run as the harness runs them.  Then ``figure_grid``'s rows and
``python -m repro_torch.bench.run``'s BENCH file."""
import dataclasses
import json

import pytest

from figure_parity import FIGURES, assert_cases_equal, both_cases, shrunk_grid_parity


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("fig", sorted(FIGURES))
def test_figure_cases_equal_reference(fig, smoke, full, monkeypatch):
    jcases, tcases = both_cases(fig, smoke, full, monkeypatch)
    assert_cases_equal(tcases, jcases)


def test_fig03_shrunk_grid_equals_reference():
    te, tres = shrunk_grid_parity("fig03")
    assert len(te.buckets) == 1


def test_fig05_shrunk_grid_equals_reference():
    te, _ = shrunk_grid_parity("fig05")
    assert len(te.buckets) == 1


def test_fig06_shrunk_grid_equals_reference():
    te, _ = shrunk_grid_parity("fig06")
    assert len(te.buckets) == 1


def test_figure_grid_rows_and_bench_file(tmp_path, monkeypatch):
    """``figure_grid`` emits a row per cell, one per bucket (its plan key,
    measured ticks/s and row-tick µs) and the sweep total;
    ``repro_torch.bench.run`` merges a figure's rows into its own BENCH
    file, replacing that figure's earlier rows and keeping the others'."""
    from repro_torch.bench import run
    from repro_torch.bench.common import Rows, ci_cfg, figure_grid
    from repro_torch.bench.fig06_failures_micro import cases, fmt
    from repro_torch.configs.arcane_paper import FATTREE_32_CI

    rows = Rows(device="cpu")
    cs = [dataclasses.replace(c, ticks=300) for c in cases(FATTREE_32_CI, full=False)]
    eng, res = figure_grid(rows, "fig06", FATTREE_32_CI, cs, fmt=fmt, collect="summary",
                           device="cpu")
    names = [r["name"] for r in rows.records]
    assert names == ["fig06/ops", "fig06/reps", "fig06/bucket/g0.0", "fig06/sweep_total"]
    b = rows.records[2]
    assert b["bucket_key"] == list(eng.plan.buckets[0].key) and b["measured_row_tick_us"] > 0
    assert rows.records[0]["derived"].endswith(f"/{cs[0].workload.n_conns}")
    out = tmp_path / "BENCH_torch.json"
    out.write_text(json.dumps({"meta": {"modules": ["fig99"]},
                               "rows": {"fig99/x": {"us_per_call": 1.0},
                                        "fig03/stale": {"us_per_call": 2.0}}}))
    monkeypatch.setenv("BENCH_SEEDS", "1")
    assert ci_cfg(False).n_hosts == 64
    assert run.main(["--only", "fig03", "--smoke", "--device", "cpu", "--collect", "none",
                     "--out", str(out)]) == 0
    data = json.loads(out.read_text())
    assert "fig99/x" in data["rows"] and "fig03/stale" not in data["rows"]
    assert {"fig03/ops", "fig03/reps", "fig03/sweep_total"} <= data["rows"].keys()
    assert data["rows"]["fig03/reps"]["device"] == "cpu"
    assert data["meta"]["modules"] == ["fig03_asym_micro", "fig99"]
