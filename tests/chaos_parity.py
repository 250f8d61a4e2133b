"""Shared helpers of the port's chaos tests: the same campaign in both
packages (tests/test_chaos.py's ``_small_campaign`` and its variants), the
port's on the CPU, and the comparisons that hold a scenario's outcome equal
to JAX's: the violation lists as dicts, then the record field by field
(each value's type and repr, so that an int against a float or a NaN names
its field), then the record digests."""
import numpy as np
import torch

from repro.netsim import chaos as jchaos
from repro_torch.netsim import chaos as tchaos

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores


def campaigns(seed=11, msg_pkts=24, small=True, **kw):
    """``(JAX campaign, port campaign)`` at the same settings; ``small`` is
    ``_small_campaign``'s budget and one-scenario cap."""
    if small:
        kw = dict(budget_s=1.0, min_scenarios=1, max_scenarios=1, **kw)
    j = jchaos.ChaosCampaign(seed=seed, **kw)
    tkw = dict(kw)
    if "invariants" in tkw:
        tkw["invariants"] = tchaos.ChaosInvariants(**vars(tkw["invariants"]))
    t = tchaos.ChaosCampaign(seed=seed, device="cpu", **tkw)
    if msg_pkts is not None:
        j.MSG_PKTS = t.MSG_PKTS = msg_pkts
    return j, t


def to_port(scenario) -> "tchaos.ChaosScenario":
    """A JAX ``ChaosScenario`` as the port's, through its JSON dict."""
    return tchaos.ChaosScenario.from_dict(scenario.to_dict())


def _same_value(a, b, where):
    assert type(a) is type(b), f"{where}: {type(a).__name__} != {type(b).__name__}"
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same_value(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same_value(x, y, f"{where}[{i}]")
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), where
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


def assert_outcome_equal(jout, tout, where=""):
    """``(violations, record)`` of both packages: violation dicts, the
    record field by field, then the digest."""
    (jv, jrec), (tv, trec) = jout, tout
    assert [v.to_dict() for v in tv] == [v.to_dict() for v in jv], where
    _same_value(jrec, trec, f"{where} record")
    assert tchaos.record_digest(trec) == jchaos.record_digest(jrec), where


def run_both(jc, tc, scenario):
    """One JAX scenario run by both campaigns, outcomes held equal; returns
    the port's ``(violations, record)``."""
    tout = tc.run_scenario(to_port(scenario))
    assert_outcome_equal(jc.run_scenario(scenario), tout, scenario.name)
    return tout
