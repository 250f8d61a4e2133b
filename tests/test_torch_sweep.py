"""The port's ``SweepEngine`` against the reference's on the CPU: the
mirrors of tests/test_sweep.py's sweep tests, each grid run through both
engines with the same arguments and every cell and seed compared bit for
bit (every SimState leaf, the SwitchLB's branch index and inactive
variants' slots included; traces, telemetry carries, finalized channels,
summaries and the plan) — across shape buckets, a horizon-merged
bucket, multi-seed rows and padded failure schedules.  The early exit is
in tests/test_torch_sweep_exit.py, the rest in tests/test_torch_sweep_more.py
and tests/test_torch_sweep_chunks.py."""

from sweep_parity import FOREVER, case, engines, run_both


def test_sweep_parity_across_buckets_and_lbs():
    """test_sweep.py's first test: two shape buckets (NC 32, and an incast
    padded to 8), three LB variants behind one SwitchLB, full traces in
    200-tick chunks."""
    def cases(m):
        wl_p, wl_i = m.net.workloads.permutation(32, 48, seed=1), m.net.workloads.incast(32, 5, 48)
        return [case(m, "perm/ecmp", wl_p, "ecmp", 500), case(m, "perm/ops", wl_p, "ops", 500),
                case(m, "perm/reps", wl_p, "reps", 500), case(m, "incast/reps", wl_i, "reps", 500)]

    je, te = engines(cases, packer=dict(merge=False))
    assert len(te.buckets) >= 2
    _, tres = run_both(je, te, collect="full", chunk=200)
    sums = tres.summaries()
    assert sums["perm/ecmp"][0].lb == "ecmp" and sums["incast/reps"][0].n_conns == 5


def test_sweep_parity_failures_and_seeds():
    """Padded failure schedules and a multi-seed row axis (REPS under seeds
    0 and 5 beside OPS), freezing within the run; ``collect="none"``."""
    def cases(m):
        ups = list(m.net.Topology.build(m.cfg).t0_up_queues(0)[:2])
        fs = m.net.failures.link_down(ups, 100, 400)
        wl = m.net.workloads.permutation(32, 48, seed=3)
        return [case(m, "f/ops", wl, "ops", 600, fs=fs),
                case(m, "f/reps", wl, "reps", 600, fs=fs, seeds=(0, 5), freezing_timeout=300)]

    je, te = engines(cases)
    _, tres = run_both(je, te, collect="none")
    bidx, variants = tres.state_for("f/reps", 1).lb_state
    assert int(bidx) == 1 and len(variants) == 2


def test_sweep_parity_new_contenders():
    """The arena contenders (prime / seqbalance / flowlet_table) behind one
    SwitchLB: two shape buckets, one horizon-merged row (300 ticks in a 700
    bucket) and a permanent failure schedule."""
    def cases(m):
        ups = list(m.net.Topology.build(m.cfg).t0_up_queues(0)[:2])
        fs = m.net.failures.link_down(ups, 100, FOREVER)
        wl_p, wl_i = m.net.workloads.permutation(32, 48, seed=1), m.net.workloads.incast(32, 5, 48)
        return [case(m, "n/prime", wl_p, "prime", 600),
                case(m, "n/seqbalance", wl_p, "seqbalance", 600),
                case(m, "n/flowlet_table", wl_p, "flowlet_table", 600),
                case(m, "n/short/prime", wl_p, "prime", 300),
                case(m, "n/fail/prime", wl_p, "prime", 700, fs=fs),
                case(m, "n/fail/seqbalance", wl_p, "seqbalance", 700, fs=fs),
                case(m, "n/fail/flowlet_table", wl_p, "flowlet_table", 700, fs=fs),
                case(m, "n/incast/seqbalance", wl_i, "seqbalance", 400)]

    je, te = engines(cases)
    assert len(te.buckets) >= 2 and any(b.program.masked for b in te.buckets)
    run_both(je, te, collect="none")
