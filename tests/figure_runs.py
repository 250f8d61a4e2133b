"""Shared helpers of the port's tests of the figure scripts that run one
``Simulator`` per cell (fig01, fig09, fig11, fig12, fig15, fig18, fig19):
each module's ``main`` in both packages with its ``run_one`` replaced by a
recorder.  Every call's arguments are kept (the cell definitions, compared
field by field); the calls picked run for real at a cut horizon, the
others get a stand-in result, so that a test runs only the cells it
compares."""
import dataclasses
import importlib
import types

import numpy as np
import torch

import benchmarks.common as jcommon
from repro_torch.bench import common as tcommon
from repro_torch.netsim import interop
from test_torch_netsim import assert_states_equal, jax_state_to_numpy

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

RUN_ONE_FIGURES = {
    "fig01": "fig01_tornado_micro", "fig09": "fig09_fpga_analogue",
    "fig11": "fig11_ack_coalescing", "fig12": "fig12_evs_cc",
    "fig15": "fig15_forced_freezing", "fig18": "fig18_three_tier",
    "fig19": "fig19_incremental",
}


def modules(fig: str):
    """(the reference's figure module, the port's)."""
    name = RUN_ONE_FIGURES[fig]
    return (importlib.import_module(f"benchmarks.{name}"),
            importlib.import_module(f"repro_torch.bench.{name}"))


def _stand_in(wl, ticks, watch, port):
    """A result that every figure's row formatting accepts."""
    w = 1 if watch is None else len(watch)
    ones = (lambda *s: torch.ones(s, dtype=torch.int32)) if port else (
        lambda *s: np.ones(s, np.int32))
    tr = types.SimpleNamespace(watch_qlen=ones(ticks, w), watch_served=ones(ticks, w))
    st = types.SimpleNamespace(c_done_tick=np.zeros(wl.n_conns, np.int32))
    s = types.SimpleNamespace(runtime_ticks=1, completed=0, n_conns=wl.n_conns, drops_cong=0,
                              drops_fail=0, timeouts=0, ecn_marks=0)
    return None, st, tr, s, 0.0


def run_main(fig, port, monkeypatch, full=False, select=(), horizon=None):
    """``main`` of one package's module; returns ``(calls, rows)``: each
    ``run_one`` call's arguments (``out`` holds the real result of the
    picked ones) and the emitted rows."""
    jmod, tmod = modules(fig)
    mod = tmod if port else jmod
    real = mod.run_one
    calls = []

    def recorder(cfg, wl, lb, ticks, failures=None, watch=None, seed=0, device=None):
        call = dict(cfg=cfg, wl=wl, lb=lb, ticks=ticks, failures=failures, watch=watch,
                    seed=seed)
        calls.append(call)
        if len(calls) - 1 not in select:
            return _stand_in(wl, ticks, watch, port)
        dev = {"device": "cpu"} if port else {}
        call["out"] = real(cfg, wl, lb, min(ticks, horizon), failures, watch, seed, **dev)
        return call["out"]

    monkeypatch.setattr(mod, "run_one", recorder)
    if port:
        rows = mod.main(tcommon.Rows(device="cpu"), full=full, device="cpu")
    else:
        monkeypatch.setattr(jcommon, "FULL", full)
        if hasattr(mod, "FULL"):
            monkeypatch.setattr(mod, "FULL", full)
        rows = mod.main(jcommon.Rows())
    return calls, rows.rows


def _cfg_dict(cfg):
    d = dataclasses.asdict(cfg)
    for backend in ("arrivals_backend", "kernels_backend"):
        d.pop(backend, None)
    return d


def _lb_dict(lb):
    cfg = getattr(lb, "cfg", None)
    return {
        "class": type(lb).__name__, "name": lb.name, "evs_size": lb.evs_size,
        "cfg": None if cfg is None else (
            cfg._asdict() if hasattr(cfg, "_asdict") else dataclasses.asdict(cfg)),
        **{k: getattr(lb, k) for k in ("enable_freezing", "force_at", "freezing_timeout",
                                       "gap_ticks") if hasattr(lb, k)},
    }


def _arr(x):
    return None if x is None else np.asarray(x)


def assert_calls_equal(tcalls, jcalls):
    """Every cell's config, workload, LB, horizon, failures, watch list and
    seed, field by field."""
    assert len(tcalls) == len(jcalls)
    for i, (t, j) in enumerate(zip(tcalls, jcalls)):
        assert _cfg_dict(t["cfg"]) == _cfg_dict(j["cfg"]), i
        for f in ("src", "dst", "msg_pkts", "start", "dep"):
            a, b = getattr(t["wl"], f), np.asarray(getattr(j["wl"], f))
            assert a.dtype == b.dtype and np.array_equal(a, b), (i, f)
        assert t["wl"].name == j["wl"].name, i
        assert _lb_dict(t["lb"]) == _lb_dict(j["lb"]), i
        assert (t["ticks"], t["seed"]) == (j["ticks"], j["seed"]), i
        assert (t["failures"] is None) == (j["failures"] is None), i
        if j["failures"] is not None:
            for f in ("queue", "start", "end", "kind", "param"):
                assert np.array_equal(_arr(getattr(t["failures"], f)),
                                      _arr(getattr(j["failures"], f))), (i, f)
        assert (t["watch"] is None) == (j["watch"] is None), i
        if j["watch"] is not None:
            assert np.array_equal(_arr(t["watch"]), _arr(j["watch"])), i


def assert_runs_equal(fig, monkeypatch, select, horizon):
    """The picked cells of one figure at the cut horizon: the same rows,
    summaries, final states and (fig01) watched traces as JAX's."""
    jcalls, jrows = run_main(fig, False, monkeypatch, select=select, horizon=horizon)
    tcalls, trows = run_main(fig, True, monkeypatch, select=select, horizon=horizon)
    assert_calls_equal(tcalls, jcalls)
    assert [r[0] for r in trows] == [r[0] for r in jrows]
    for i in select:
        assert trows[i][2] == jrows[i][2], (fig, i, trows[i][2], jrows[i][2])
        _, jst, jtr, js, _ = jcalls[i]["out"]
        _, tst, ttr, ts, _ = tcalls[i]["out"]
        assert dataclasses.asdict(ts).keys() == dataclasses.asdict(js).keys()
        assert repr(dataclasses.asdict(ts)) == repr(dataclasses.asdict(js)), (fig, i)
        assert_states_equal(jax_state_to_numpy(jst), interop.sim_state_to_numpy(tst),
                            f"{fig} cell {i}")
        for f in ("watch_qlen", "watch_served", "delivered", "drops"):
            assert np.array_equal(getattr(ttr, f).numpy(), np.asarray(getattr(jtr, f))), f
    return trows
