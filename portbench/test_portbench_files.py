"""The benchmark's files: every cell, configuration, traffic mix and metric
is found by name and loads; byte counts match the kernel table's figures;
nothing under ``portbench/`` imports JAX, the JAX package or the JAX-era
benchmarks."""
from __future__ import annotations

import ast
import json
from pathlib import Path

import pytest

import numpy as np

from portbench import check, harness, roofline

HERE = Path(__file__).resolve().parent
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def test_every_cell_config_and_metric_is_found_by_name():
    for cfg in BENCH["configs"]:
        data = json.loads((HERE.parent / cfg["file"]).read_text())
        assert data["fabric"]["n_hosts"] > 0 and data["source"]
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"], BENCH)
        assert cell.traffic["lbs"] and cell.run["chunk"] > 0
        assert cell.end_to_end and cell.per_layer
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.reader(m["name"]))


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_no_reference_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    if "reference" in path.relative_to(HERE).parts:  # the reference imports nothing of the program
        assert "repro_torch" not in tops and "portbench" not in tops


def test_byte_counts_match_the_kernel_table():
    i32 = lambda *s: (s, tuple(1 for _ in s), 4)
    b8 = lambda *s: (s, tuple(1 for _ in s), 1)
    # seg_sum's feedback call: seg K = 128, four int32 fields and one bool, S = 387
    assert roofline.seg_sum_bytes(i32(128), [i32(128)] * 4 + [b8(128)], 387) == 10_428
    # reps_tick at N = 128 connections, R = 2 ACK rounds, every event class
    for n, want in ((128, 18_432), (10**5, 14_400_000), (10**6, 144_000_000)):
        state = [((n, 8), (8, 1), 4), ((n, 8), (8, 1), 1)] + [i32(n)] * 4 + [b8(n), i32(n)]
        events = [b8(n), i32(n), b8(n)] * 2 + [b8(n), b8(n), i32(n)]
        outs = state + [i32(n)]
        assert roofline.reps_tick_bytes(state + events, outs) == want
    # a broadcast (stride-0) row axis is read once
    assert roofline.tensor_bytes((64, 128), (0, 1), 4) == 512
    assert roofline.roofline_pct(3_350_000, 1e-6) == pytest.approx(100.0)
    assert roofline.roofline_pct(0, 1.0) is None


def test_only_the_sentinel_slots_are_left_out():
    want = {"qbuf": np.zeros((2, 5, 3), np.int32), "pkt": np.zeros((2, 4, 9), np.int32),
            "c_cwnd": np.ones((2, 6), np.float32)}
    diff = lambda got: check.diff_rows(check.without_sentinels(got),
                                       check.without_sentinels(want)).tolist()
    sink = {k: v.copy() for k, v in want.items()}
    sink["qbuf"][0, 4, 1] = 7  # the sentinel queue's buffer
    sink["pkt"][1, 2, 8] = 7  # the packet table's sentinel column
    assert diff(sink) == [0, 0]
    real = {k: v.copy() for k, v in want.items()}
    real["qbuf"][0, 3, 1] = 7  # the last real queue
    real["pkt"][1, 2, 7] = 7  # the last real packet slot
    real["c_cwnd"][1, 5] = -0.0  # floats by their bits
    assert diff(real) == [1, 2]
