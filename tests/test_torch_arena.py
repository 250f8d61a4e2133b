"""The port's arena (``repro_torch.bench.arena``) against the reference's
``benchmarks/arena.py``: the failure block cut to 300 ticks (past the
uplink failures at tick 150) and to four contenders (ECMP, REPS, Prime and
adaptive RoCE, which packs into a bucket of its own) goes through both
``figure_grid``s with the arena's sketch columns (``derive_res``): the same
plan and the same rows.  The arena's cell lists, every contender, are held
in tests/test_torch_figures_more.py; every LB's rows against JAX's in the
sweep and tracer tests."""
import dataclasses

import torch

import benchmarks.arena as jarena
import benchmarks.common as jcommon
from repro_torch.bench import arena as tarena
from repro_torch.bench import common as tcommon

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores


LBS = ("ecmp", "reps", "prime", "adaptive_roce")


def _failure_block(cases):
    return [dataclasses.replace(c, ticks=300, seeds=(0,)) for c in cases
            if c.name.startswith("arena/failure/") and c.name.split("/")[2] in LBS]


def test_arena_failure_block_rows_equal_reference():
    jcfg, tcfg = jcommon.ci_cfg(), tcommon.ci_cfg(False)
    jcases = _failure_block(jarena.cases(jcfg, smoke=True))
    tcases = _failure_block(tarena.cases(tcfg, smoke=True, full=False))
    assert len(tcases) == len(LBS)
    jrows, trows = jcommon.Rows(), tcommon.Rows(device="cpu")
    jcommon.figure_grid(jrows, "arena", jcfg, jcases, derive_res=jarena._derive,
                        collect="summary")
    tcommon.figure_grid(trows, "arena", tcfg, tcases, derive_res=tarena.derive,
                        collect="summary", device="cpu")
    names = [r[0] for r in trows.rows]
    assert names == [r[0] for r in jrows.rows]
    for (name, _, want), (_, _, got) in zip(jrows.rows, trows.rows):
        if "/bucket/" in name or name.endswith("sweep_total"):
            want, got = want.split(";ticks_run")[0], got.split(";ticks_run")[0]
        assert got == want, name
    # the failures bite: fewer than all connections finish by tick 300
    assert all("completed=64/64" not in r[2] for r in trows.rows if "/failure/" in r[0])
