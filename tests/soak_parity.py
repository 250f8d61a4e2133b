"""Shared helpers of the port's soak tests: tests/test_soak.py's grid
(FATTREE_32_CI, 360 ticks, chunk 120, three cells in two buckets, one
horizon-merged frozen row) built in both packages, and the canonical bits
of a finished run (summaries, telemetry carries, final states)."""
import types

import jax
import numpy as np
import torch

import repro.netsim as jnet
import repro_torch.netsim as tnet
from repro.configs.arcane_paper import FATTREE_32_CI as J_CFG
from repro_torch.configs.arcane_paper import FATTREE_32_CI as T_CFG
from repro_torch.netsim import interop
from repro_torch.tree import tree_map
from test_torch_netsim import assert_states_equal, jax_state_to_numpy
from test_torch_telemetry import summary_dict

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

J = types.SimpleNamespace(net=jnet, cfg=J_CFG)
T = types.SimpleNamespace(net=tnet, cfg=T_CFG)
TICKS = 360  # grid horizon; chunk 120 -> boundaries at 120, 240
CHUNK = 120
SLOTS = 8  # injection headroom (and plan identity with the static grids)


def grid(m, extra_failures=None):
    wl = m.net.workloads
    return [
        m.net.SweepCase(name="a", workload=wl.permutation(32, 24, seed=1), lb="reps",
                        ticks=TICKS, lb_kwargs={"evs_size": m.cfg.evs_size},
                        failures=extra_failures, seeds=(0, 1)),
        m.net.SweepCase(name="b", workload=wl.permutation(32, 24, seed=2), lb="ops", ticks=300,
                        failures=extra_failures, seeds=(0,)),
        m.net.SweepCase(name="c", workload=wl.incast(32, 5, 24), lb="reps", ticks=TICKS,
                        lb_kwargs={"evs_size": m.cfg.evs_size}, failures=extra_failures,
                        seeds=(0,)),
    ]


def engine(m, extra_failures=None, **kw):
    dev = {"device": "cpu"} if m is T else {}
    return m.net.SweepEngine(m.cfg, grid(m, extra_failures), devices=None,
                             min_failure_slots=SLOTS, **dev, **kw)


def bits(res, m=T):
    """Canonical numpy view of every cell row's result: summaries (every
    field), telemetry carries, final states by leaf name."""
    out = {"summaries": {k: [summary_dict(s) for s in v]
                         for k, v in sorted(res.summaries().items())}}
    for bi, b in enumerate(res.buckets):
        for r in range(b.n_rows):
            if m is T:
                out[f"b{bi}_r{r}_state"] = interop.sim_state_to_numpy(
                    tree_map(lambda x: x[r], b.final_state))
            else:
                out[f"b{bi}_r{r}_state"] = jax_state_to_numpy(
                    jax.tree_util.tree_map(lambda x: x[r], b.final_state))
        if b.telemetry is not None:
            out[f"b{bi}_tel"] = np.asarray(b.telemetry)
    return out


def assert_bits_equal(got, want, where=""):
    assert got.keys() == want.keys(), where
    assert got["summaries"] == want["summaries"], where
    for k in want:
        if k.endswith("_state"):
            assert_states_equal(want[k], got[k], f"{where} {k}")
        elif k.endswith("_tel"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{where} {k}")
