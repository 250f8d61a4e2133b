"""fig12, fig18 and fig19 of the port (``repro_torch.bench``) at horizons cut
past each figure's first event, bit-equal to the reference's modules run
the same way (rows, summaries, final states); the cell definitions of
every single-simulator figure are held in tests/test_torch_figures_more.py."""
from figure_runs import assert_runs_equal


def test_fig12_runs_equal_reference(monkeypatch):
    """REPS at 32 EVs, and under the EQDS-like and the delay-based CC."""
    assert_runs_equal("fig12", monkeypatch, select=(1, 9, 11), horizon=300)


def test_fig18_runs_equal_reference(monkeypatch):
    """ECMP and REPS on the 3-tier fabric."""
    assert_runs_equal("fig18", monkeypatch, select=(0, 2), horizon=300)


def test_fig19_runs_equal_reference(monkeypatch):
    """REPS past the first two uplink failures (ticks 200 and 700)."""
    assert_runs_equal("fig19", monkeypatch, select=(1,), horizon=750)
