"""The port's single-simulator figure scripts (``repro_torch.bench``:
fig01, fig09, fig11, fig12, fig15, fig18, fig19) and its arena against the
reference's ``benchmarks/`` modules: every cell's config, workload, LB,
horizon, failures and watch list equal the reference's field by field, at
CI and at paper scale, with the same row names; the arena's cell list too,
its LB columns in registry order.  Then fig01, fig09 and fig11 run their
picked cells at horizons cut past each figure's first event, bit-equal to
JAX (rows, summaries, final states, watched traces); fig12, fig18 and
fig19 in tests/test_torch_figures_runs.py, fig15 and its hook in
tests/test_torch_fig15_hook.py, the arena grid in tests/test_torch_arena.py
and the soak dashboard in tests/test_torch_soak_dashboard.py."""
import pytest

from figure_parity import assert_cases_equal
from figure_runs import RUN_ONE_FIGURES, assert_calls_equal, assert_runs_equal, run_main


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("fig", sorted(RUN_ONE_FIGURES))
def test_figure_cells_equal_reference(fig, full, monkeypatch):
    jcalls, jrows = run_main(fig, False, monkeypatch, full=full)
    tcalls, trows = run_main(fig, True, monkeypatch, full=full)
    assert_calls_equal(tcalls, jcalls)
    assert [r[0] for r in trows] == [r[0] for r in jrows]
    assert [r[2] for r in trows] == [r[2] for r in jrows]  # the stand-ins' rows


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("smoke", [True, False])
def test_arena_cases_equal_reference(smoke, full, monkeypatch):
    import benchmarks.arena as jarena
    import benchmarks.common as jcommon
    from repro.core.load_balancers import REGISTRY as JREG
    from repro_torch.bench import arena as tarena
    from repro_torch.bench import common as tcommon

    monkeypatch.setattr(jcommon, "FULL", full)
    monkeypatch.setattr(jarena, "msg", jcommon.msg)
    jcases = jarena.cases(jcommon.ci_cfg(), smoke=smoke)
    tcases = tarena.cases(tcommon.ci_cfg(full), smoke=smoke, full=full)
    assert_cases_equal(tcases, jcases)
    assert tarena.ARENA_LBS == jarena.ARENA_LBS == [n for n in JREG if n != "mixed"]
    assert "mixed" not in tarena.ARENA_LBS


def test_fig01_runs_equal_reference(monkeypatch):
    """REPS for 400 ticks: queues build at once; two 200-tick windows."""
    assert_runs_equal("fig01", monkeypatch, select=(1,), horizon=400)


def test_fig09_runs_equal_reference(monkeypatch):
    """REPS under the half-rate uplink and past fig 10's link failure at
    tick 800."""
    assert_runs_equal("fig09", monkeypatch, select=(1, 3), horizon=850)


def test_fig11_runs_equal_reference(monkeypatch):
    """REPS at 16:1 coalescing, symmetric and under the half-rate uplink."""
    assert_runs_equal("fig11", monkeypatch, select=(9, 11), horizon=300)
