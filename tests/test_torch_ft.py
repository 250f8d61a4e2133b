"""The port's fault-tolerance module (repro_torch.ft) against the
reference's (repro.ft) on the CPU: the four tests of tests/test_ft.py
mirrored on the port, and, for the three reps_channels_bench scenarios and
test_reps_channels_freeze_and_recover's sequence, every ReduceReport field
and every REPS scheduler state leaf equal to JAX's (tolerance 0)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.ft import ChannelSim as JChannelSim
from repro.ft import ChannelSimConfig as JChannelSimConfig
from repro.ft import OpsChannelScheduler as JOps
from repro.ft import RepsChannelScheduler as JReps
from repro.ft import run_cross_pod_reduce as j_reduce
from repro_torch.bench import reps_channels_bench as tbench
from repro_torch.core.reps import FIELDS
from repro_torch.ft import (
    ChannelSim,
    ChannelSimConfig,
    LatencyECN,
    OpsChannelScheduler,
    RepsChannelScheduler,
    StepWatchdog,
    run_cross_pod_reduce,
)

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

SCENARIOS = [name for name, _ in tbench.SCENARIOS]


def _state(sched) -> dict:
    return {f: np.asarray(getattr(sched.state, f)) for f in FIELDS}


def _same_state(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for f in want:
        assert got[f].dtype == want[f].dtype and got[f].shape == want[f].shape, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def _jax_scenario(name: str, scheduler: str):
    """The reference bench's cell (benchmarks/reps_channels_bench.py)."""
    sim = JChannelSim(JChannelSimConfig(n_channels=16), seed=0)
    dict(tbench.SCENARIOS)[name](sim)
    sched = JOps(16, seed=0) if scheduler == "ops" else JReps(16, seed=0)
    return j_reduce(sched, sim, n_chunks_total=256, chunks_per_round=32), sched


@pytest.fixture(scope="module")
def jax_cells():
    return {(n, s): _jax_scenario(n, s) for n in SCENARIOS for s in ("ops", "reps")}


def _freeze_and_recover(reduce, sched, sim):
    """test_reps_channels_freeze_and_recover's sequence: the three reports
    and the scheduler's state and freezing flag after each phase."""
    out = []
    for phase in ("warm", "fail", "heal"):
        if phase == "fail":
            sim.set_failed(range(8))
        if phase == "heal":
            sim.set_failed(range(8), failed=False)
        rep = reduce(sched, sim, 128 if phase == "heal" else 64, 16)
        out.append((dataclasses.asdict(rep), _state(sched), sched.is_freezing))
    return out


@pytest.mark.parametrize("scheduler", ["ops", "reps"])
@pytest.mark.parametrize("name", SCENARIOS)
def test_bench_scenario_matches_reference(jax_cells, name, scheduler):
    want, jsched = jax_cells[(name, scheduler)]
    got, tsched, _ = tbench.run_scenario(name, scheduler, device="cpu")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert type(got.total_latency_us) is float and type(got.rounds) is int
    if scheduler == "reps":
        _same_state(_state(tsched), _state(jsched))
        assert tsched.round_idx == jsched.round_idx
        np.testing.assert_array_equal(tsched.key.numpy(),
                                      np.asarray(jsched.key).astype(np.int64))


def test_freeze_and_recover_sequence_matches_reference():
    want = _freeze_and_recover(j_reduce, JReps(16, seed=1, freezing_timeout_rounds=2),
                               JChannelSim(JChannelSimConfig(n_channels=16), seed=1))
    got = _freeze_and_recover(
        run_cross_pod_reduce,
        RepsChannelScheduler(16, seed=1, freezing_timeout_rounds=2, device="cpu"),
        ChannelSim(ChannelSimConfig(n_channels=16), seed=1))
    for (g_rep, g_state, g_frz), (w_rep, w_state, w_frz) in zip(got, want):
        assert g_rep == w_rep
        _same_state(g_state, w_state)
        assert g_frz == w_frz


def test_scheduler_needs_a_device_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RepsChannelScheduler(16)


# --- tests/test_ft.py, mirrored on the port ---------------------------------
def test_reps_channels_avoid_failures():
    cfg = ChannelSimConfig(n_channels=16)
    results = {}
    for name, mk in [
        ("ops", lambda: OpsChannelScheduler(16, seed=0)),
        ("reps", lambda: RepsChannelScheduler(16, seed=0, device="cpu")),
    ]:
        sim = ChannelSim(cfg, seed=0)
        sim.set_failed(range(6))
        results[name] = run_cross_pod_reduce(mk(), sim, 256, 32)
    assert results["reps"].timeouts < results["ops"].timeouts / 3
    assert results["reps"].total_latency_us < results["ops"].total_latency_us


def test_reps_channels_freeze_and_recover():
    sched = RepsChannelScheduler(16, seed=1, freezing_timeout_rounds=2, device="cpu")
    sim = ChannelSim(ChannelSimConfig(n_channels=16), seed=1)
    run_cross_pod_reduce(sched, sim, 64, 16)
    assert not sched.is_freezing
    sim.set_failed(range(8))
    run_cross_pod_reduce(sched, sim, 64, 16)
    sim.set_failed(range(8), failed=False)
    rep = run_cross_pod_reduce(sched, sim, 128, 16)
    assert rep.timeouts == 0


def test_latency_ecn_marks_outliers():
    m = LatencyECN(factor=1.5)
    lat = np.array([100.0] * 20 + [500.0, 100.0, 100.0])
    marks = m.mark(lat)
    assert marks[20] and not marks[:20].any()


def test_step_watchdog():
    w = StepWatchdog(factor=3.0, trigger_after=2)
    for _ in range(10):
        assert not w.observe(1.0)
    assert not w.observe(10.0)  # first slow step
    assert w.observe(10.0)  # second consecutive -> trigger
