"""The rest of a seed-11 campaign's first cycle, port against JAX on the
CPU: ``generate(1)`` (a degraded link injected live at tick 160 through
``SoakRunner.inject``), ``generate(2)`` (link flapping and a degraded
link), ``generate(3)`` (gray loss at 0.2424) and ``generate(4)`` (a spine
down), each run to its 1280-tick horizon at tests/test_chaos.py's 24-packet
messages: the violation lists, the records field by field and the record
digests equal JAX's, and REPS survives every one.  ``generate(0)``, with
its kill/resume check, is in tests/test_torch_chaos.py."""
import pytest

from chaos_parity import campaigns, run_both


@pytest.mark.parametrize("index, archetypes", [
    (1, ["link_degraded"]),
    (2, ["link_flapping", "link_degraded"]),
    (3, ["gray_loss"]),
    (4, ["spine_down"]),
])
def test_generated_scenario_equals_reference(index, archetypes):
    jc, tc = campaigns()
    s = jc.generate(index)
    assert [f.archetype for f in s.faults] == archetypes and not s.resume_check
    violations, record = run_both(jc, tc, s)
    assert violations == []
    assert record["summaries"][s.name][0]["completed"] == 32
    if index == 1:
        assert s.faults[0].inject_at == 160  # the live-injection path
