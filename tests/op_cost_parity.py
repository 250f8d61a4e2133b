"""What the ``tests/test_torch_op_cost_*.py`` files share: a reduced train
step's FLOPs as the port's ``repro_torch.launch.op_cost`` counts them,
against the reference's ``analyze_hlo`` of XLA's optimized HLO.

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
import torch

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.launch.hlo_cost import analyze_hlo
from repro.models import build_model as j_build_model
from repro.train import TrainConfig as JTrainConfig, make_train_step as j_make_train_step
from repro.train.optimizer import init_opt_state as j_init_opt_state
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.launch import dryrun
from repro_torch.models import build_model

torch.set_num_threads(1)  # the suite's parallel workers share the host's cores

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




def check_train_step_flops(arch: str) -> None:
    """Remat on and off: the port's count equals the reference's less the
    named gap, and within 1e-3 of it where no extra HLO product is named."""
    cfg = reduced(get_config(arch))
    for remat in (True, False):
        cost, _, _ = dryrun.trace_step(build_model(cfg), ShapeConfig("t", S, B, "train"), None,
                                       remat=remat)
        ref = _reference_flops(arch, remat)
        assert cost.flops == ref - _named_gap(cfg, remat), (arch, remat, cost.flops, ref)
        if not (cfg.family == "hybrid" and not remat):
            assert abs(cost.flops / ref - 1) < 1e-3, (arch, remat)
