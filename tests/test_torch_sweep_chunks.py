"""Per-row horizons and the chunk primitives of the port's
``SweepEngine`` (tests/test_sweep.py's horizon-merge test against the
reference's engine, bit for bit on the CPU), and ``bucket_carry`` /
``run_chunk`` / ``finalize_bucket`` in two chunkings against one ``run``."""
import numpy as np
import pytest
import torch

from repro_torch.netsim import interop
from repro_torch.netsim.engine import tree_map
from sweep_parity import FOREVER, case, engines, run_both


def test_horizon_merge_never_resurrects_failures():
    """A short cell with a permanent failure fused into a longer bucket
    freezes at its own horizon: equal to the reference's row, in one chunk
    and with early exit in 100-tick chunks; and equal to the serial run
    stopped there."""
    def cases(m):
        ups = list(m.net.Topology.build(m.cfg).t0_up_queues(0)[:2])
        fs = m.net.failures.link_down(ups, 50, FOREVER)
        wl = m.net.workloads.permutation(32, 48, seed=1)
        return [case(m, "short/ops", wl, "ops", 300, fs=fs), case(m, "long/reps", wl, "reps", 900)]

    je, te = engines(cases, packer=dict(waste_budget=2.0))
    assert len(te.buckets) == 1 and te.buckets[0].program.masked
    _, tres = run_both(je, te, collect="none")
    run_both(je, te, collect="none", early_exit=True, chunk=100)
    st, _ = te.serial_sim("short/ops").run(300)
    a, b = interop.sim_state_to_numpy(st), interop.sim_state_to_numpy(tres.state_for("short/ops"))
    for k in a:
        if not k.startswith("lb_state"):
            assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("collect", ["none", "summary"])
def test_chunk_primitives_any_chunking_equals_one_run(collect):
    """``bucket_carry`` + ``run_chunk`` in two chunkings (uneven windows,
    one boundary on a row's horizon, one inside a draw chunk) equal one
    ``run``; the states passed to ``run_chunk`` are left unchanged."""
    def cases(m):
        ups = list(m.net.Topology.build(m.cfg).t0_up_queues(0)[:2])
        fs = m.net.failures.link_down(ups, 80, 500)
        wl = m.net.workloads.permutation(32, 40, seed=6)
        return [case(m, "c/ops", wl, "ops", 410, fs=fs), case(m, "c/reps", wl, "reps", 700, fs=fs,
                                                              seeds=(0, 2), freezing_timeout=150)]

    _, te = engines(cases, packer=dict(waste_budget=2.0))
    bucket = te.buckets[0]
    assert bucket.program.masked
    tres = te.run(collect=collect)  # equal to the reference's: tests/test_torch_sweep.py
    for cuts in ((0, 130, 410, 700), (0, 300, 301, 555, 700)):
        carry = te.bucket_carry(bucket, collect)
        for t0, t1 in zip(cuts[:-1], cuts[1:]):
            states = carry[0] if collect == "summary" else carry
            before = {k: v.copy() for k, v in interop.sim_state_to_numpy(states).items()}
            carry, _ = te.run_chunk(bucket, carry, t0, t1 - t0, collect)
            after = interop.sim_state_to_numpy(states)
            assert all(np.array_equal(before[k], after[k]) for k in before)
        te.finalize_bucket(bucket, carry, collect, 700)
        for c in te.cases:
            for si in range(len(c.seeds)):
                row = bucket.cells[[x.case.name for x in bucket.cells].index(c.name)].rows[si]
                a = interop.sim_state_to_numpy(tres.state_for(c.name, si))
                b = interop.sim_state_to_numpy(tree_map(lambda x: x[row], bucket.final_state))
                for k in a:
                    assert a[k].tobytes() == b[k].tobytes(), (cuts, c.name, k)
        if collect == "summary":
            assert torch.equal(torch.as_tensor(bucket.telemetry),
                               torch.as_tensor(tres.buckets[0].telemetry)), cuts
