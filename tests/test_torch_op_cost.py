"""``repro_torch.launch.op_cost`` (the per-device count of a step's aten
operations, the port's counterpart of ``repro.launch.hlo_cost``) and
``repro_torch.launch.roofline`` against the reference: the counter's
own cases (loops, DTensor's local products, the collectives' ring
factors, fake against real tensors) and the roofline's formulas.  Every
non-MoE preset's reduced train step is held against the reference's
``analyze_hlo`` by family in ``test_torch_op_cost_{gemma,mistral,
recurrent}.py`` (``tests/op_cost_parity.py``)."""
import numpy as np
import pytest
import torch

from repro.launch import roofline as j_roofline
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.launch import dryrun, op_cost, roofline
from repro_torch.launch.mesh import make_mesh, release
from repro_torch.models import build_model

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

B, S = 2, 32


def test_looped_matmul_flops_exact():
    """The reference test's scanned matmul, as the port's loop runs it."""
    w = torch.ones((8, 128, 128))
    x = torch.ones((4, 128))
    with op_cost.count() as c:
        for i in range(8):
            x = torch.tanh(x @ w[i])
        x.sum()
    assert c.flops == 8 * 2 * 4 * 128 * 128

    with op_cost.count() as c:
        y = torch.ones((2, 64))
        ws = torch.ones((5, 3, 64, 64))
        for i in range(5):
            for j in range(3):
                y = y @ ws[i, j]
    assert c.flops == 5 * 3 * 2 * 2 * 64 * 64


def test_sharded_matmul_counts_the_local_product():
    """Above DTensor, ``FlopCounterMode`` counts the global product; the
    count here is each device's local one: 1/256 of it on a 16 x 16 mesh
    with x sharded over data and w over model."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode

    mesh = make_mesh((16, 16), ("data", "model"))
    try:
        with FakeTensorMode():
            x = DTensor.from_local(torch.empty(4, 5120), mesh, [Shard(0), Replicate()],
                                   run_check=False, shape=(64, 5120), stride=(5120, 1))
            w = DTensor.from_local(torch.empty(5120, 896), mesh, [Replicate(), Shard(1)],
                                   run_check=False, shape=(5120, 14336), stride=(14336, 1))
            with op_cost.count() as c:
                x @ w
            with FlopCounterMode(display=False) as fc:
                x @ w
    finally:
        release()
    assert fc.get_total_flops() == 2 * 64 * 5120 * 14336 == 9_395_240_960
    assert c.flops == 2 * 4 * 5120 * 896 == 36_700_160 == 9_395_240_960 // 256
    assert c.coll_bytes == 0


def test_collective_ring_factors():
    """all-reduce 2 x operand, all-gather 1 x result, reduce-scatter and
    all-to-all 1 x operand (the reference's factors), from the
    collectives DTensor's redistributions dispatch; a collective with no
    factor raises."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = make_mesh((4, 2), ("data", "model"))
    n = 64 * 32 * 4  # bytes of the (64, 32) float32 tensor
    try:
        with FakeTensorMode():
            def dt(local_shape, placements):
                return DTensor.from_local(torch.empty(local_shape), mesh, placements,
                                          run_check=False, shape=(64, 32), stride=(32, 1))

            cases = {
                "all-reduce": (dt((64, 32), [Partial(), Replicate()]), [Replicate(), Replicate()],
                               2 * n),
                "all-gather": (dt((16, 32), [Shard(0), Replicate()]), [Replicate(), Replicate()],
                               n),
                "reduce-scatter": (dt((64, 32), [Partial(), Replicate()]),
                                   [Shard(0), Replicate()], n),
                "all-to-all": (dt((16, 32), [Shard(0), Replicate()]), [Shard(1), Replicate()],
                               n // 4),
            }
            for kind, (x, to, want) in cases.items():
                with op_cost.count() as c:
                    x.redistribute(mesh, to)
                assert c.coll_breakdown == {kind: want}, (kind, c.coll_breakdown)
                assert c.coll_bytes == want
            # a collective with no ring factor is an error, not a guess
            with pytest.raises(NotImplementedError, match="all_reduce_"):
                with op_cost.count():
                    torch.ops._c10d_functional.all_reduce_(torch.empty(8), "sum",
                                                           mesh.get_group(0).group_name)
    finally:
        release()


def test_roofline_equals_reference_with_its_constants(monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(roofline, name, getattr(j_roofline, name))
    rs = np.random.RandomState(0)
    for _ in range(20):
        kw = dict(flops=float(rs.randint(1, 10**15)), hbm_bytes=float(rs.randint(1, 10**13)),
                  coll_bytes=float(rs.randint(0, 10**12)), coll_breakdown={},
                  n_devices=int(rs.choice([1, 8, 256, 512])),
                  model_flops=float(rs.randint(1, 10**17)),
                  hbm_bytes_min=float(rs.randint(0, 10**12)))
        assert roofline.Roofline(**kw).row() == j_roofline.Roofline(**kw).row()


def test_card_constants_are_the_h100s():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (989e12, 3.35e12, 450e9)


def test_fake_and_real_counts_are_equal():
    """One device, no mesh: the step traced on fake tensors counts what it
    counts running on real ones (FLOPs, bytes, ops)."""
    from repro_torch import rng
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    cfg = reduced(get_config("mistral-nemo-12b"))
    model = build_model(cfg)
    fake, _, _ = dryrun.trace_step(model, ShapeConfig("t", S, B, "train"), None)
    params, opt = init_train_state(model, rng.PRNGKey(0, device="cpu"))
    rs = np.random.RandomState(1)
    batch = {k: torch.from_numpy(rs.randint(0, cfg.vocab, (B, S)).astype(np.int32))
             for k in ("tokens", "labels")}
    with op_cost.count() as real:
        make_train_step(model, TrainConfig())(params, opt, batch)
    assert (real.flops, real.bytes_accessed, real.n_ops) == (
        fake.flops, fake.bytes_accessed, fake.n_ops)
