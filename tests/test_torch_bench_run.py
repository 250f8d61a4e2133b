"""The port's bench runner (``python -m repro_torch.bench.run``) and its
flight-recorder option on the CPU: a shrunk fig06 ``--smoke`` grid through
the CLI with ``--trace 64`` against the reference's ``run_sweep`` under
BENCH_TRACE=64 (rows, carries, summaries and rings equal) and against the
CLI's untraced run (``derived`` equal, ``trace`` stamps 0 and 64);
``--trace -1`` rejected; the merged file's ``meta`` (``"mixed"`` where the
rows differ, ``sweep_totals``); a module that raises (its ``ERROR=`` row,
``meta.failed``, the other modules' rows written, exit code 1)."""
import json
import types

import pytest
import torch

import benchmarks.common as jcommon
from figure_parity import T_CFG, modules, shrink
from sweep_parity import assert_results_equal
from test_torch_netsim import assert_states_equal
from test_torch_telemetry import assert_same, summary_dict
from repro_torch.bench import common as tcommon
from repro_torch.bench import run
from repro_torch.netsim import interop

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

def cli(argv, monkeypatch):
    """``run.main(argv)`` with the environment it sets restored afterwards
    (set here to the defaults, so that the monkeypatch undoes the run's)."""
    monkeypatch.setenv("BENCH_SEEDS", "1")
    monkeypatch.setenv("BENCH_TRACE", "0")
    return run.main(argv)


def test_traced_cli_grid_equals_reference_and_untraced(tmp_path, monkeypatch):
    """``--only fig06 --smoke`` with its cells shrunk to 300 ticks (inside
    the first failure window, 150-800), untraced and with ``--trace 64``,
    against the reference's ``run_sweep`` under BENCH_TRACE=64."""
    jmod, tmod = modules("fig06")
    cases, run_sweep, runs = tmod.cases, tcommon.run_sweep, []
    monkeypatch.setattr(tmod, "cases", lambda cfg, smoke=None, full=None: shrink(
        cases(cfg, smoke, full), factor=32))
    monkeypatch.setattr(tcommon, "run_sweep",
                        lambda *a, **kw: runs.append(run_sweep(*a, **kw)) or runs[-1])
    plain, traced = tmp_path / "plain.json", tmp_path / "traced.json"
    argv = ["--only", "fig06", "--smoke", "--device", "cpu"]
    assert cli(argv + ["--out", str(plain)], monkeypatch) == 0
    assert cli(argv + ["--trace", "64", "--out", str(traced)], monkeypatch) == 0
    (ue, ures), (te, tres) = runs
    jcfg = jcommon.ci_cfg()
    jcases = shrink(jmod.cases(jcfg, smoke=True), factor=32)
    monkeypatch.setattr(jcommon, "TRACE", 64)
    je, jres = jcommon.run_sweep(jcfg, jcases, collect="summary")
    assert_results_equal(je, jres, te, tres, "summary", "fig06 traced")
    for c in jcases:
        flight = tres.flight_for(c.name)
        assert flight["cursor"] > 0 and flight["first_drop_tick"] >= 150, c.name  # the failure
        assert_same(flight, jres.flight_for(c.name), c.name)

    a, b = json.loads(plain.read_text()), json.loads(traced.read_text())
    jrows = jcommon.Rows()
    jcommon.sweep_rows(jrows, jres, fmt=tmod.fmt, collect="summary")
    assert [r["trace"] for r in jrows.records] == [64, 64]
    for name, _, derived in jrows.rows:
        assert a["rows"][name]["derived"] == b["rows"][name]["derived"] == derived, name
    assert a["rows"].keys() == b["rows"].keys() and len(a["rows"]) == 4
    for name in a["rows"]:
        assert a["rows"][name]["derived"] == b["rows"][name]["derived"], name
        assert (a["rows"][name]["trace"], b["rows"][name]["trace"]) == (0, 64), name
    assert (a["meta"]["trace"], b["meta"]["trace"]) == (0, 64)
    for meta in (a["meta"], b["meta"]):
        assert meta["sweep_totals"] == ["fig06/sweep_total"] and meta["failed"] == []
        assert (meta["full_scale"], meta["smoke"], meta["seeds"], meta["collect"]) == (
            False, True, 1, "summary")

    for c in jcases:  # the recorder only observes
        for source in ("state", "sketch"):
            assert ([summary_dict(s) for s in ures.summaries(source)[c.name]]
                    == [summary_dict(s) for s in tres.summaries(source)[c.name]]), c.name
        assert_same(ures.telemetry_for(c.name), tres.telemetry_for(c.name), c.name)
        assert_states_equal(interop.sim_state_to_numpy(tres.state_for(c.name)),
                            interop.sim_state_to_numpy(ures.state_for(c.name)), c.name)
    with pytest.raises(ValueError, match="no flight-recorder events"):
        ures.flight_for(jcases[0].name)


def test_merged_meta_reads_mixed(tmp_path, monkeypatch, capsys):
    def fig03(rows, **kw):
        rows.add("fig03/reps", 2.0, "runtime=2")
        rows.add("fig03/sweep_total", 2.0, "cells=1")

    def fig01(rows, **kw):
        rows.add("fig01/tornado/reps", 1.0, "runtime=1")

    monkeypatch.setattr("repro_torch.bench.fig03_asym_micro.main", fig03)
    monkeypatch.setattr("repro_torch.bench.fig01_tornado_micro.main", fig01)
    out = tmp_path / "bench.json"
    assert cli(["--only", "fig03", "--smoke", "--device", "cpu", "--out", str(out)],
               monkeypatch) == 0
    first = json.loads(out.read_text())
    assert cli(["--only", "fig01", "--trace", "64", "--device", "cpu", "--out", str(out)],
               monkeypatch) == 0
    merged = json.loads(out.read_text())
    assert merged["meta"]["trace"] == "mixed" and merged["meta"]["smoke"] == "mixed"
    assert merged["meta"]["seeds"] == 1 and merged["meta"]["collect"] == "summary"
    assert merged["meta"]["sweep_totals"] == ["fig03/sweep_total"]
    assert merged["meta"]["modules"] == ["fig01_tornado_micro", "fig03_asym_micro"]
    assert merged["rows"]["fig01/tornado/reps"]["trace"] == 64
    assert merged["rows"]["fig03/reps"] == first["rows"]["fig03/reps"]

    # a figure run again replaces all of its rows
    assert cli(["--only", "fig01", "--device", "cpu", "--out", str(out)], monkeypatch) == 0
    again = json.loads(out.read_text())
    assert again["rows"]["fig01/tornado/reps"]["trace"] == 0
    assert again["meta"]["trace"] == 0 and again["meta"]["smoke"] == "mixed"

    # a row without a stamp (a file from before the stamp) is a value of its own
    again["rows"]["fig03/reps"].pop("trace")
    out.write_text(json.dumps(again))
    assert cli(["--only", "fig01", "--device", "cpu", "--out", str(out)], monkeypatch) == 0
    assert json.loads(out.read_text())["meta"]["trace"] == "mixed"


def test_cli_rejects_negative_trace(monkeypatch, capsys):
    with pytest.raises(SystemExit) as e:
        cli(["--only", "fig03", "--trace", "-1", "--device", "cpu"], monkeypatch)
    assert e.value.code == 2 and "--trace must be >= 0" in capsys.readouterr().err
    monkeypatch.setenv("BENCH_TRACE", "-3")
    with pytest.raises(SystemExit):
        run.main(["--only", "fig03", "--device", "cpu"])


def test_failed_module_row_meta_and_exit_code(tmp_path, monkeypatch, capsys):
    def broken(rows, **kw):
        rows.add("fig01/partial", 1.0, "x")  # a failed module leaves no rows
        raise ValueError("boom")

    def fig03(rows, **kw):
        rows.add("fig03/reps", 2.0, "runtime=2")
        rows.add("fig03/sweep_total", 2.0, "cells=1")

    monkeypatch.setattr("repro_torch.bench.fig01_tornado_micro.main", broken)
    monkeypatch.setattr("repro_torch.bench.fig03_asym_micro.main", fig03)
    out = tmp_path / "bench.json"
    rc = cli(["--only", "fig01,fig03", "--trace", "8", "--device", "cpu", "--out", str(out)],
             monkeypatch)
    printed = capsys.readouterr().out.splitlines()
    assert rc == 1
    assert "fig01_tornado_micro,0,ERROR=ValueError('boom')" in printed
    assert "fig03/reps,2,runtime=2" in printed and "# total_wall_s=" in printed[-2]
    bench = json.loads(out.read_text())
    assert bench["meta"]["failed"] == ["fig01_tornado_micro"]
    assert sorted(bench["rows"]) == ["fig03/reps", "fig03/sweep_total"]
    assert bench["meta"]["trace"] == 8 and bench["meta"]["sweep_totals"] == ["fig03/sweep_total"]


def test_run_sweep_keeps_an_explicit_spec(monkeypatch):
    seen = {}

    class Engine:
        def __init__(self, *a, **kw):
            pass

        def run(self, **kw):
            seen.update(kw)
            return types.SimpleNamespace()

    monkeypatch.setattr(tcommon, "SweepEngine", Engine)
    monkeypatch.setenv("BENCH_TRACE", "16")
    tcommon.run_sweep(T_CFG, [], collect="summary", device="cpu")
    assert seen["trace"].ring == 16
    for collect in ("none", "full"):  # the recorder rides the summary carry
        tcommon.run_sweep(T_CFG, [], collect=collect, device="cpu")
        assert seen["trace"] is None
    spec = tcommon.TraceSpec(ring=4)
    tcommon.run_sweep(T_CFG, [], collect="summary", device="cpu", trace=spec)
    assert seen["trace"] is spec
    monkeypatch.delenv("BENCH_TRACE")
    tcommon.run_sweep(T_CFG, [], collect="summary", device="cpu")
    assert seen["trace"] is None
