"""``repro_torch.launch.op_cost`` (the per-device count of a step's aten
operations, the port's counterpart of ``repro.launch.hlo_cost``) and
``repro_torch.launch.roofline`` against the reference.

The reduced train step of every non-MoE preset, remat on and off, counts
the FLOPs the reference's ``analyze_hlo`` reads from XLA's optimized HLO,
less gaps each named and computed exactly: the reference's one-hot label
contraction (2·B·S·V; the port gathers the label logit), RWKV6's bonus
term (a dot in the reference, an elementwise product and sum in the port:
2·B·S·d per layer, per forward pass and once in the backward), and
Zamba2 without remat, where the reference's HLO runs the shared block's
attention score and value products once more (2·2·B·S²·H·hd per
application).  Bytes are not held to XLA's: its fused count is another
quantity."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.launch import roofline as j_roofline
from repro.launch.hlo_cost import analyze_hlo
from repro.models import build_model as j_build_model
from repro.train import TrainConfig as JTrainConfig, make_train_step as j_make_train_step
from repro.train.optimizer import init_opt_state as j_init_opt_state
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.launch import dryrun, op_cost, roofline
from repro_torch.launch.mesh import make_mesh, release
from repro_torch.models import build_model

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

NON_MOE = ["gemma-7b", "gemma3-4b", "llava-next-mistral-7b", "mistral-nemo-12b",
           "musicgen-large", "qwen1.5-4b", "rwkv6-1.6b", "zamba2-7b"]
B, S = 2, 32


def _named_gap(cfg, remat: bool) -> float:
    """What the reference's HLO counts beyond the port's ops (see the
    module docstring)."""
    gap = 2.0 * B * S * cfg.vocab  # one-hot label contraction
    if cfg.family == "ssm":
        gap += (3 if remat else 2) * 2.0 * B * S * cfg.d_model * cfg.n_layers
    if cfg.family == "hybrid" and not remat:
        groups = cfg.n_layers // cfg.shared_attn_period
        gap += 2 * 2.0 * B * S * S * cfg.n_heads * cfg.head_dim * groups
    return gap


def _reference_flops(arch: str, remat: bool) -> float:
    model = j_build_model(j_reduced(j_get_config(arch)))
    params = jax.eval_shape(lambda k: model.init_params(k), jax.random.PRNGKey(0))
    opt = jax.eval_shape(j_init_opt_state, params)
    sds = jax.ShapeDtypeStruct
    if model.cfg.frontend != "none":
        batch = {"embeds": sds((B, S, model.cfg.d_model), jnp.bfloat16),
                 "labels": sds((B, S), jnp.int32)}
    else:
        batch = {"tokens": sds((B, S), jnp.int32), "labels": sds((B, S), jnp.int32)}
    step = jax.jit(j_make_train_step(model, JTrainConfig(remat=remat)))
    return analyze_hlo(step.lower(params, opt, batch).compile().as_text()).flops


@pytest.mark.parametrize("arch", NON_MOE)
def test_train_step_flops_match_reference(arch):
    cfg = reduced(get_config(arch))
    for remat in (True, False):
        cost, _, _ = dryrun.trace_step(build_model(cfg), ShapeConfig("t", S, B, "train"), None,
                                       remat=remat)
        ref = _reference_flops(arch, remat)
        assert cost.flops == ref - _named_gap(cfg, remat), (arch, remat, cost.flops, ref)
        if not (cfg.family == "hybrid" and not remat):
            assert abs(cost.flops / ref - 1) < 1e-3, (arch, remat)


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
