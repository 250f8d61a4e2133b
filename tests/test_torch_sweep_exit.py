"""The quiescence early exit of the port's ``SweepEngine`` against the
reference's on the CPU (bit for bit, as tests/test_torch_sweep.py): both
engines stop at the same chunk with equal rows, in ``collect="none"`` and
in summary mode on a horizon-merged bucket of three variants."""
import numpy as np

from sweep_parity import FOREVER, case, engines, run_both


def test_sweep_early_exit_is_fixed_point():
    """Quiescence early exit (250-tick chunks) stops both engines at the
    same chunk, well before the 2000-tick horizon, with equal rows."""
    def cases(m):
        wl = m.net.workloads.permutation(32, 48, seed=1)
        return [case(m, "p/ecmp", wl, "ecmp", 2000), case(m, "p/plb", wl, "plb", 2000)]

    je, te = engines(cases)
    _, tres = run_both(je, te, collect="none", early_exit=True, chunk=250)
    assert tres.buckets[0].ticks_run < 2000


def test_sweep_summary_early_exit_three_variants_horizon_merged():
    """Summary mode with early exit (default chunk) on a horizon-merged
    bucket of three variants and two seeds under a failure: the telemetry
    carries, finalized channels (at each cell's own horizon) and sketch
    summaries equal the reference's, and so does ``ticks_run``."""
    def cases(m):
        ups = list(m.net.Topology.build(m.cfg).t0_up_queues(0)[:2])
        fs = m.net.failures.link_down(ups, 60, FOREVER)
        wl = m.net.workloads.permutation(32, 32, seed=4)
        return [case(m, "s/ecmp", wl, "ecmp", 900, fs=fs),
                case(m, "s/ops", wl, "ops", 520, fs=fs),
                case(m, "s/reps", wl, "reps", 900, fs=fs, seeds=(0, 3), freezing_timeout=200)]

    je, te = engines(cases)
    assert len(te.buckets) == 1 and te.buckets[0].program.masked
    _, tres = run_both(je, te, collect="summary", early_exit=True)
    assert tres.buckets[0].ticks_run < 900
    assert np.isfinite(tres.summaries("sketch")["s/reps"][1].mean_fct_ticks)
