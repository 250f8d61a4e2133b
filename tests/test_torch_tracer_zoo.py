"""The flight recorder's events for the rest of the load-balancer zoo,
``mixed`` and ``SwitchLB`` (the first variant's branch), tick by tick
against the reference on the CPU, bit for bit: see
tests/test_torch_tracer.py, whose scenario and helper this uses."""
import pytest

from test_torch_tracer import check_lb

LBS = [
    ("mixed", {"fg": "reps", "bg": "plb", "bg_conns": (1, 3, 5, 8)}),
    ("switch:plb+reps", {}),
    ("switch:reps+ops", {}),
    ("flowlet", {}),
    ("mptcp", {}),
    ("prime", {}),
    ("seqbalance", {}),
    ("flowlet_table", {}),
]


@pytest.mark.parametrize("lbn,kw", LBS, ids=[n for n, _ in LBS])
def test_tick_events_and_ring_match_reference(lbn, kw):
    check_lb(lbn, kw, ticks=320 if lbn == "flowlet" else 460)  # past the 400-tick RTO
