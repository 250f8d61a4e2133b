"""MoE expert parallelism (``repro_torch.models.mlp``; reference
``models/mlp.py:1-10, 41-125, 127-166``).

* ``_moe_local(x, p, cfg, n_shards, shard_idx)`` on one shard of the
  experts equals the reference's on the same numpy inputs (a reduced
  phi3.5-moe layer at the preset's capacity, where assignments drop, also
  with the router's column 0 raised so that more do), and the shards'
  outputs sum to the whole layer's.
* Four gloo ranks (started once for the file by
  ``repro_torch.distrib.ranks.run_ranks``; the work is in
  ``tests/ranks_parity.py``) take the reduced phi3.5-moe's train step in
  float64 on (1, 2) and (2, 2) meshes under the baseline and fsdp rules,
  at a capacity with 0 drops (asserted): loss, aux, every gradient and one
  AdamW step equal the one-device step to 1e-9 of each leaf's largest.
  At the preset's binding capacity on the (2, 2) mesh one layer equals
  ``_moe_local`` run on each data shard, as the reference's capacity
  counts local tokens.
* A reduced MoE dry-run cell traces on a fake (2, 2) mesh: the experts'
  FLOPs per device are the closed form of the rank's experts and its
  capacity."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs as j_all_configs, reduced as j_reduced
from repro.models import mlp as j_mlp
from repro_torch.configs import ShapeConfig, all_configs, reduced
from repro_torch.distrib.ranks import run_ranks
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh, release
from repro_torch.models import build_model, mlp
from ranks_parity import MOE_ARCH, moe_ep_work
from serve_parity import rel_err

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

TOL = 1e-4  # float32, max|Δ| / max|ref| (tests/test_torch_moe.py's)


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(moe_ep_work, 4, "cpu", "gloo", timeout=600)


@pytest.mark.parametrize("raise_by", [0.0, 0.05])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_moe_local_shard_matches_reference(n_shards, raise_by):
    jcfg = j_reduced(j_all_configs()[MOE_ARCH])
    cfg = reduced(all_configs()[MOE_ARCH])
    rs = np.random.RandomState(5)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": rs.standard_normal((d, E)) / np.sqrt(d),
         "w1": rs.standard_normal((E, d, f)) / np.sqrt(d),
         "w3": rs.standard_normal((E, d, f)) / np.sqrt(d),
         "w2": rs.standard_normal((E, f, d)) / np.sqrt(f)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    p["router"][:, 0] += raise_by
    x = (rs.standard_normal((2, 64, d)) + 0.5).astype(np.float32)
    E_loc = E // n_shards
    total = 0
    for idx in range(n_shards):
        shard = {k: v if k == "router" else v[idx * E_loc:(idx + 1) * E_loc] for k, v in p.items()}
        want, want_aux = j_mlp._moe_local(jnp.asarray(x), jax.tree.map(jnp.asarray, shard), jcfg,
                                          n_shards, idx)
        got, aux = mlp._moe_local(torch.from_numpy(x), {k: torch.from_numpy(v)
                                                        for k, v in shard.items()},
                                  cfg, n_shards, idx)
        want = np.asarray(want)  # a shard no assignment reaches gives zeros, and so must the port
        assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max(), idx
        assert abs(float(aux) - float(want_aux)) <= TOL * abs(float(want_aux))
        total = total + got
    whole, _ = mlp._moe_local(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
                              cfg)
    assert rel_err(total.numpy(), whole.numpy()) <= TOL
    r = mlp.moe_routing(torch.from_numpy(x).reshape(-1, d), torch.from_numpy(p["router"]), cfg)
    # assignments drop at the preset's capacity, more with expert 0 favoured
    assert int((~r["keep"]).sum()) > (40 if raise_by else 0)


def test_train_step_on_meshes_equals_one_device(ranks):
    for out in ranks:
        assert out["checked"] == ["(2, 2) baseline", "(2, 2) fsdp", "(1, 2) baseline",
                                  "(1, 2) fsdp"]
        assert out["drops"] == 0


def test_binding_capacity_counts_local_tokens(ranks):
    for out in ranks:
        assert out["binding_drops"] > 0
        assert out["y_placements"] == ("S0", "R")


def test_moe_dry_run_cell_traces_on_a_fake_mesh():
    cfg = reduced(all_configs()[MOE_ARCH])
    B, S = 4, 64
    mesh = make_mesh((2, 2), ("data", "model"))
    try:
        cost, _, _ = dryrun.trace_step(build_model(cfg), ShapeConfig("t", S, B, "train"), mesh,
                                       rows=True, remat=False)
    finally:
        release()
    rows = {path: flops for path, _, flops, _ in cost.breakdown() if flops}
    cap = mlp.capacity(B // 2 * S, cfg)  # the rank's tokens: half the batch
    e_loc = cfg.n_experts // 2
    # the forward's three expert products (w1, w3, w2) per layer
    assert rows["mlp._moe_local/bmm"] == cfg.n_layers * 3 * 2 * e_loc * cap * cfg.d_model * cfg.d_ff
    assert cost.flops > 0 and np.isfinite(cost.flops)
