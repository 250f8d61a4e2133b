"""The port on a CUDA device: each hand-written kernel against its plain
version, and short simulations on the card (ECMP-hashing, REPS, zoo and
adaptive load balancers) against the same ones on the CPU — bit for bit.  Marked ``cuda``; without a GPU every test skips with a
reason.  This file imports no JAX, so it also runs where only the port is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import FATTREE_32_CI
from repro_torch.core import make_lb
from repro_torch.kernels import ops, ref
from repro_torch.netsim import Simulator, Topology, failures, sim_state_to_numpy, workloads

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _on(dev, a):
    return torch.as_tensor(np.ascontiguousarray(a), device=dev)


def test_seg_kernels_match_plain_versions(dev):
    rs = np.random.RandomState(0)
    for F, K, S in [(5, 128, 387), (2, 300, 129), (5, 128, 20000)]:
        seg = rs.randint(-1, S + 2, size=K).astype(np.int32)
        vals = rs.randint(-3, 60, size=(F, K)).astype(np.int32)
        assert torch.equal(ops.seg_sum(_on(dev, seg), _on(dev, vals), S),
                           ref.seg_sum_ref(_on(dev, seg), _on(dev, vals), S))
    for K, S in [(128, 129), (1000, 70000), (77, 3)]:
        seg = rs.randint(-1, S + 2, size=K).astype(np.int32)
        assert torch.equal(ops.seg_rank(_on(dev, seg), S), ref.seg_rank_ref(_on(dev, seg), S))


def test_reps_and_queue_kernels_match_plain_versions(dev):
    rs = np.random.RandomState(1)
    N = 300
    state = [rs.randint(0, 65536, size=(N, 8)).astype(np.int32), rs.rand(N, 8) < 0.5,
             rs.randint(0, 8, size=N).astype(np.int32), rs.randint(0, 9, size=N).astype(np.int32),
             rs.randint(0, 3, size=N).astype(np.int32), rs.rand(N) < 0.3,
             rs.randint(0, 3000, size=N).astype(np.int32), rs.randint(0, 3, size=N).astype(np.int32)]
    events = [rs.rand(N) < 0.5, rs.randint(0, 65536, size=N).astype(np.int32), rs.rand(N) < 0.3,
              rs.rand(N) < 0.2, rs.rand(N) < 0.6, rs.randint(0, 65536, size=N).astype(np.int32)]
    args = [_on(dev, a) for a in state + events] + [1234, 32, 800]
    for x, y in zip(ops.reps_tick(*args), ref.reps_tick_ref(*args)):
        assert torch.equal(x, y)
    tgt = rs.randint(0, 20, size=512).astype(np.int32)
    qlen = rs.randint(0, 86, size=384).astype(np.int32)
    u = rs.rand(512).astype(np.float32)
    serve = _on(dev, rs.rand(384) < 0.5)
    for sv in (None, serve):
        got = ops.queue_tick(_on(dev, tgt), _on(dev, u), _on(dev, qlen), sv, 85, 17, 68)
        want = ref.queue_tick_ref(_on(dev, tgt), _on(dev, u), _on(dev, qlen), sv, 85, 17, 68)
        for x, y in zip(got, want):
            assert torch.equal(x, y)


def test_ecmp_hash_kernel_matches_plain_version(dev):
    rs = np.random.RandomState(2)
    for shape, nports in [((512,), 16), ((1000,), 13), ((3, 384), 4), ((77,), 1)]:
        flow = rs.randint(-2**31, 2**31, size=shape, dtype=np.int64).astype(np.int32)
        ev = rs.randint(0, 65536, size=shape).astype(np.int32)
        salt = (2**31 - 1 - rs.randint(0, 9000, size=shape)).astype(np.int32)
        args = [_on(dev, a) for a in (flow, ev, salt)]
        assert torch.equal(ops.ecmp_hash(*args, nports), ref.ecmp_hash_ref(*args, nports))
    with pytest.raises(ValueError, match="nports >= 1"):
        ops.ecmp_hash(*args, 0)


@pytest.mark.parametrize("lbn", ["ops", "reps", "plb", "bitmap", "mixed", "adaptive_roce"])
def test_card_run_equals_cpu_run(dev, lbn):
    cfg = FATTREE_32_CI
    ups = [int(q) for q in Topology.build(cfg).t0_up_queues(0)[:2]]
    kw = dict(evs_size=cfg.evs_size)
    if lbn == "reps":
        kw.update(freezing_timeout=200)
    if lbn == "mixed":
        kw.update(fg="reps", bg="plb", bg_conns=(1, 4, 9, 20))
    finals = []
    for d in (dev, "cpu"):
        sim = Simulator(cfg, workloads.permutation(32, 48, seed=3), make_lb(lbn, **kw),
                        failures=failures.link_down(ups, 30, 300), device=d)
        ops.reset_launch_counts()
        state, _ = sim.run(470)
        counts = ops.launch_counts()
        finals.append(sim_state_to_numpy(state))
        if d == dev:
            assert counts["seg_sum"] == 4 * 470 and counts["queue_tick"] == 470
            # the adaptive router picks by queue length and hashes nothing
            assert counts["ecmp_hash"] == (0 if lbn == "adaptive_roce" else 470)
            assert counts["reps_tick"] == (4 * 470 if lbn in ("reps", "mixed") else 0)
    for k in finals[0]:
        assert finals[0][k].tobytes() == finals[1][k].tobytes(), k
