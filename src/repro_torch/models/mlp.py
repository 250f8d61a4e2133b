"""Feed-forward layers (counterpart of ``repro.models.mlp``): the gated
dense MLP.  The expert-parallel MoE is not ported yet."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import act_fn, dense_init, split_keys


def init_mlp_params(key, cfg: ModelConfig, dtype=torch.float32):
    d, f = cfg.d_model, cfg.d_ff
    ks = split_keys(key, 3)
    return {
        "w1": dense_init(ks[0], (d, f), d, dtype),  # gate
        "w3": dense_init(ks[1], (d, f), d, dtype),  # up
        "w2": dense_init(ks[2], (f, d), f, dtype),  # down
    }


def mlp(x, p, cfg: ModelConfig):
    act = act_fn(cfg.act)
    h = act(torch.einsum("bsd,df->bsf", x, p["w1"])) * torch.einsum("bsd,df->bsf", x, p["w3"])
    return torch.einsum("bsf,fd->bsd", h, p["w2"])


def _moe_not_ported(cfg: ModelConfig):
    return NotImplementedError(
        f"{cfg.name}: the MoE layer (repro.models.mlp.moe) is not ported yet (ROADMAP item 14)")


def init_moe_params(key, cfg: ModelConfig, dtype=torch.float32):
    raise _moe_not_ported(cfg)


def moe(x, p, cfg: ModelConfig):
    raise _moe_not_ported(cfg)
