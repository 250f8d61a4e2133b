"""Shared helpers of the port's sweep tests: the same cells built in both
packages, both ``SweepEngine``s run with the same arguments (the port's on
the CPU), and every result compared bit for bit."""
import dataclasses
import types

import numpy as np
import torch

import repro.netsim as jnet
import repro_torch.netsim as tnet
from repro.configs.arcane_paper import FATTREE_32_CI as J_CFG
from repro_torch.configs.arcane_paper import FATTREE_32_CI as T_CFG
from repro_torch.netsim import interop
from test_torch_netsim import assert_states_equal, jax_state_to_numpy
from test_torch_telemetry import assert_same, summary_dict
from test_torch_sweep_pack import plan_fields

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

J = types.SimpleNamespace(net=jnet, cfg=J_CFG)
T = types.SimpleNamespace(net=tnet, cfg=T_CFG)
FOREVER = 2**30


def case(m, name, wl, lb, ticks, fs=None, seeds=(0,), **lb_kwargs):
    lb_kwargs.setdefault("evs_size", m.cfg.evs_size)
    return m.net.SweepCase(name=name, workload=wl, lb=lb, ticks=ticks, lb_kwargs=lb_kwargs,
                           failures=fs, seeds=tuple(seeds))


def engines(cases_of, packer=None, cfg_kw=None, **kw):
    """``cases_of(m)`` in both packages, as two SweepEngines (the port's on
    the CPU), with the same packer and engine arguments (and FATTREE_32_CI
    with ``cfg_kw`` replaced, when given)."""
    pk = lambda m: None if packer is None else m.net.PackerConfig(**packer)
    cfg_kw = cfg_kw or {}
    je = jnet.SweepEngine(J_CFG.replace(**cfg_kw), cases_of(J), packer=pk(J), **kw)
    te = tnet.SweepEngine(T_CFG.replace(**cfg_kw), cases_of(T), packer=pk(T), device="cpu", **kw)
    assert plan_fields(te.plan) == plan_fields(je.plan)
    return je, te


def assert_results_equal(je, jres, te, tres, collect="none", where=""):
    """Every cell and seed of the two sweeps: every SimState leaf (the
    SwitchLB's branch index and every variant's slot included), the trace
    (``collect="full"``), the telemetry carry and its finalized channels
    (``"summary"``), the summaries from the state and, when collected,
    from the sketches; and each bucket's ``ticks_run``."""
    assert [b.ticks_run for b in tres.buckets] == [b.ticks_run for b in jres.buckets], where
    for c in je.cases:
        for si in range(len(c.seeds)):
            w = f"{where} {c.name} seed {si}"
            assert_states_equal(jax_state_to_numpy(jres.state_for(c.name, si)),
                                interop.sim_state_to_numpy(tres.state_for(c.name, si)), w)
            if collect == "full":
                jt, tt = jres.trace_for(c.name, si), tres.trace_for(c.name, si)
                for f in jt._fields:
                    a, b = np.asarray(getattr(jt, f)), getattr(tt, f).numpy()
                    assert a.shape == b.shape and a.dtype == b.dtype, (w, f)
                    np.testing.assert_array_equal(b, a, err_msg=f"{w}: trace {f}")
            if collect == "summary":
                jb, jc = jres._find(c.name)
                tb, tc = tres._find(c.name)
                np.testing.assert_array_equal(tb.telemetry[tc.rows[si]],
                                              np.asarray(jb.telemetry[jc.rows[si]]), err_msg=w)
                assert_same(tres.telemetry_for(c.name, si), jres.telemetry_for(c.name, si), w)
    sources = ("state", "sketch", "auto") if collect == "summary" else ("state", "auto")
    for source in sources:
        js, ts = jres.summaries(source), tres.summaries(source)
        assert ts.keys() == js.keys()
        for k in js:
            assert [summary_dict(s) for s in ts[k]] == [summary_dict(s) for s in js[k]], (
                where, source, k)


def run_both(je, te, **run_kw):
    jres, tres = je.run(**run_kw), te.run(**run_kw)
    assert_results_equal(je, jres, te, tres, run_kw.get("collect", "none"), str(run_kw))
    return jres, tres


def replace_ticks(cases, **ticks):
    return [dataclasses.replace(c, ticks=ticks.get(c.name, c.ticks)) for c in cases]
