"""The shrunk smoke grids of tests/test_figure_parity.py's macro figures
(fig04, fig07, fig08) through the port's and the reference's sweep
engines: the same plan, and every row bit for bit (the bucket limits of
the reference's test hold too)."""
from figure_parity import shrunk_grid_parity


def test_fig04_shrunk_grid_equals_reference():
    """Two workloads x three LBs over degraded uplinks: one SwitchLB of
    three variants."""
    te, _ = shrunk_grid_parity("fig04")
    assert te.plan.n_groups <= 2


def test_fig07_shrunk_grid_equals_reference():
    """Permutation and ring-AllReduce blocks: different conn counts and
    horizons."""
    shrunk_grid_parity("fig07")


def test_fig08_shrunk_grid_equals_reference():
    """The failure-fraction axis fuses into one bucket."""
    te, _ = shrunk_grid_parity("fig08")
    assert len(te.buckets) == 1 and te.plan.merge_waste <= 0.05
