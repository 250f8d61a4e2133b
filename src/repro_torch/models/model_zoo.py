"""Unified model interface (counterpart of ``repro.models.model_zoo``):
``build_model(cfg)`` gives a ``Model`` bundling init / loss / prefill /
decode for ``--arch`` dispatch.

The port builds the transformer families (dense, audio, vlm; the stub
frontends take precomputed ``embeds``).  The MoE, RWKV (ssm) and Zamba
(hybrid) families raise ``NotImplementedError`` (ROADMAP item 14), as do
the dry-run fields (``input_specs``, ``batch_axes``, ``decode_state_spec``
/ ``decode_state_axes``), which wait for ``launch/dryrun``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

Params = Any
AUX_COEF = 0.01


def cross_entropy(logits, labels):
    """Mean next-token NLL (float32) of ``logits (B, S, V)`` at ``labels``."""
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - ll)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init_params: Callable  # (key, dtype) -> params on the key's device
    param_axes: Callable  # () -> logical-axis tree
    loss_fn: Callable  # (params, batch) -> (loss, metrics)
    prefill_fn: Callable  # (params, batch, max_len) -> (logits, cache, len)
    decode_fn: Callable  # (params, cache, tokens, cache_len) -> (logits, cache)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family in ("ssm", "hybrid") or cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet (ROADMAP item 14); "
            "the port builds the dense, audio and vlm transformers")
    return _build_transformer(cfg)


def _build_transformer(cfg: ModelConfig) -> Model:
    def loss_fn(params, batch):
        logits, aux = transformer.forward(params, cfg, batch)
        loss = cross_entropy(logits, batch["labels"])
        return loss + AUX_COEF * aux, {"xent": loss, "aux": aux}

    return Model(
        cfg=cfg,
        init_params=lambda key, dtype=torch.float32: transformer.init_params(cfg, key, dtype),
        param_axes=lambda: transformer.param_axes(cfg),
        loss_fn=loss_fn,
        prefill_fn=lambda params, batch, max_len: transformer.prefill(params, cfg, batch,
                                                                      max_len),
        decode_fn=lambda params, cache, tokens, cache_len: transformer.decode_step(
            params, cfg, cache, tokens, cache_len),
    )
