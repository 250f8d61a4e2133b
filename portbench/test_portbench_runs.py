"""The harness's whole run on the CPU at a tiny size: the port's timed path
agrees with the plain reference, the last line has the contract's keys,
and the control and each fault that a cell can have come out as not
correct.  (The look for a card lives in ``run.py`` and is skipped here.)"""
from __future__ import annotations

import json
import time
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.control import control_program

BENCH = json.loads((Path(__file__).resolve().parents[1] / "BENCHMARK.json").read_text())
# a 32-host fat tree with short links, so that ACKs, congestion updates and
# a failure window all fall inside a few dozen ticks
FABRIC = dict(n_hosts=32, hosts_per_tor=8, uplinks_per_tor=8, tiers=2, evs_size=256,
              queue_capacity=48, init_cwnd_pkts=40, max_cwnd_pkts=80, rto_ticks=60,
              max_msg_pkts=512, hop_latency_ticks=2, ack_delay_ticks=4, nack_delay_ticks=4)
TRAFFIC = {"pattern": "permutation", "msg_pkts": 24,
           "failures": [{"tor": 0, "uplink": 0, "start": 4, "end": 30}],
           "lbs": [{"name": "ops"}, {"name": "reps", "kwargs": {"freezing_timeout": 20}}],
           "seeds_per_lb": 2, "horizon": 400, "collect": "summary"}
RUN = {"chunk": 16, "warmup_chunks": 1, "sample_rows": 4, "trace_ticks": 8}
SEED = 2**31 + 77  # seeds run past 32 signed bits


def _cell(**traffic):
    grid = harness.load_cell("fig06_ft128.rows3072", BENCH)  # the metrics of the fig06 cell
    return harness.Cell("tiny", FABRIC, dict(TRAFFIC, **traffic), RUN,
                        grid.end_to_end, grid.per_layer)


def _run(program=harness.SweepProgram, seconds=0.2, traced=False, **traffic):
    torch.set_num_threads(1)
    run = harness.run_cell(_cell(**traffic), SEED, seconds, traced, "cpu", time.perf_counter(),
                           program=program, log=lambda m: None)
    return run, harness.result(run)


def test_port_agrees_with_reference_across_batches():
    # the horizon ends each batch at the window's first chunk, so the next
    # batch starts inside the window and the finished one is compared too
    run, out = _run(horizon=32)
    # the finished batch's rows, and the open batch's if it ran a chunk
    assert run.batches_done >= 1 and run.attempted in (4, 8)
    assert out["correct"] is True and out["failed"] == 0
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(out["metrics"]) == {"row_ticks_per_s", "setup_s"}  # no card: no peak memory
    assert all(v == {"value": 0, "limit": 0} for v in out["checks"].values())
    traced_run, traced = _run(traced=True)
    assert traced["correct"] is True and "init_rows_s" in traced["metrics"]
    assert set(traced["device"]) >= {"busy_s", "window_s"} and "breakdown" in traced


class _Frozen(harness.SweepProgram):
    def step(self, carry, t0, n):  # a step that returns its state unchanged
        return carry


class _HalfRows(harness.SweepProgram):
    def step(self, carry, t0, n):  # half of the batch left out
        new = super().step(carry, t0, n)
        keep = torch.arange(len(self.row_of)) < len(self.row_of) // 2
        from repro_torch.tree import tree_map
        pick = lambda a, b: torch.where(keep.view(-1, *[1] * (a.dim() - 1)), a, b)
        return (tree_map(pick, new[0], carry[0]), new[1])


class _Altered(harness.SweepProgram):
    def step(self, carry, t0, n):  # an answer altered where it is produced
        st, tel = super().step(carry, t0, n)
        from repro_torch.netsim.engine import ST_DELIVERED
        stats = st.s_stats.clone()
        stats[:, ST_DELIVERED] += 1
        return st.replace(s_stats=stats), tel


@pytest.mark.parametrize("program", [_Frozen, _HalfRows, _Altered,
                                     control_program(torch.bfloat16)],
                         ids=["unchanged", "half_rows", "altered", "control_bf16"])
def test_faults_and_control_are_not_correct(program):
    run, out = _run(program)
    assert out["correct"] is False and out["failed"] > 0
    assert sum(v["value"] for v in out["checks"].values()) > 0
