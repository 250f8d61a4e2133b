"""The chaos checker's teeth, port against JAX on the CPU (mirrors of
tests/test_chaos.py): the known-bad fixture (ecmp under a permanent
half-fabric outage) violates with ``{"completion"}`` exactly at 640 ticks,
its REPS control passes at the full 1280, and a tight recovery bound fires
(its scenarios cut to 480 ticks, past the fault window and one RTO).  Each
run's violation list, record and digest equal JAX's."""
import dataclasses

import pytest

from chaos_parity import campaigns, run_both
from repro.netsim import chaos as jchaos


def test_known_bad_fixture_violates_and_reps_does_not():
    jc, tc = campaigns(seed=1, msg_pkts=None, small=False)
    violations, _ = run_both(jc, tc, jchaos.known_bad_scenario(ticks=640, chunk=160))
    assert violations, "ecmp under half-fabric outage must violate"
    assert {v.invariant for v in violations} == {"completion"}
    # the control needs the full fixture horizon: REPS rides out up to two
    # 400-tick RTO rounds before every retransmit lands on the live half
    good = dataclasses.replace(jchaos.known_bad_scenario(), name="chaos/control/reps", lb="reps")
    assert run_both(jc, tc, good)[0] == []


@pytest.mark.parametrize("fault, bound, fires", [
    ("link_down", 1, False),  # tests/test_chaos.py's case: nothing drops there
    ("spine_down", 0, True),  # 81 failure drops, redelivered one tick later
])
def test_invariants_recovery_bound_fires_on_tight_budget(fault, bound, fires):
    """A genuine recovery past an artificially tight bound is reported, and a
    window that drops nothing stays silent, in the port as in JAX."""
    jc, tc = campaigns(seed=2, small=False, invariants=jchaos.ChaosInvariants(
        no_progress_window=10**9, recovery_bound_ticks=bound, require_completion=False))
    s = dataclasses.replace(
        jc.generate(0), resume_check=False, name="chaos/tightrec", ticks=480,
        faults=(jchaos.ChaosFault(fault, tor=0, spine=0, start=8, end=200),),
    )
    violations, record = run_both(jc, tc, s)
    assert [v.invariant for v in violations] == (["recovery"] if fires else [])
    if fires:
        assert record["summaries"][s.name][0]["drops_fail"] > 0
