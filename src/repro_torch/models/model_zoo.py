"""Unified model interface (counterpart of ``repro.models.model_zoo``):
``build_model(cfg)`` gives a ``Model`` bundling init / loss / prefill /
decode for ``--arch`` dispatch over the four families: the transformers
(dense, MoE, audio, vlm; the stub frontends take precomputed ``embeds``),
RWKV6 (``ssm``) and Zamba2 (``hybrid``).  ``loss_fn`` is the training
loss (``train.steps.make_train_step`` differentiates it), with the
reference's activation checkpointing (``remat``, on by default).  The
dry-run fields (``input_specs``, ``batch_axes``, ``decode_state_spec`` /
``decode_state_axes``) wait for ``launch/dryrun``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import recurrent, transformer

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
    loss_fn: Callable  # (params, batch, remat=True, remat_policy=None) -> (loss, metrics)
    prefill_fn: Callable  # (params, batch, max_len) -> (logits, cache, len)
    decode_fn: Callable  # (params, cache, tokens, cache_len) -> (logits, cache)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "ssm":
        return _build_rwkv(cfg)
    if cfg.family == "hybrid":
        return _build_zamba(cfg)
    return _build_transformer(cfg)


def _build_transformer(cfg: ModelConfig) -> Model:
    def loss_fn(params, batch, remat=True, remat_policy=None):
        logits, aux = transformer.forward(params, cfg, batch, remat=remat,
                                          remat_policy=remat_policy)
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


def _build_rwkv(cfg: ModelConfig) -> Model:
    def loss_fn(params, batch, remat=True, remat_policy=None):
        logits, aux, _ = recurrent.rwkv_forward(params, cfg, batch, remat=remat)
        loss = cross_entropy(logits, batch["labels"])
        return loss, {"xent": loss, "aux": aux}

    def prefill_fn(params, batch, max_len):
        logits, _, state = recurrent.rwkv_forward(params, cfg, batch)
        S = batch["tokens"].shape[1]
        return logits[:, -1:, :], state, torch.tensor(S, dtype=torch.int32,
                                                      device=logits.device)

    def decode_fn(params, state, tokens, cache_len):
        logits, _, new_state = recurrent.rwkv_forward(params, cfg, {"tokens": tokens},
                                                      state=state)
        return logits, new_state

    return Model(
        cfg=cfg,
        init_params=lambda key, dtype=torch.float32: recurrent.rwkv_init_params(cfg, key,
                                                                                dtype),
        param_axes=lambda: recurrent.rwkv_param_axes(cfg),
        loss_fn=loss_fn,
        prefill_fn=prefill_fn,
        decode_fn=decode_fn,
    )


def _build_zamba(cfg: ModelConfig) -> Model:
    def loss_fn(params, batch, remat=True, remat_policy=None):
        logits, aux = recurrent.zamba_forward(params, cfg, batch, remat=remat)
        loss = cross_entropy(logits, batch["labels"])
        return loss, {"xent": loss, "aux": aux}

    def prefill_fn(params, batch, max_len):
        return recurrent.zamba_prefill(params, cfg, batch, min(cfg.shared_attn_window, max_len))

    def decode_fn(params, state, tokens, cache_len):
        return recurrent.zamba_decode_step(params, cfg, state, tokens, cache_len,
                                           state["k"].shape[2])

    return Model(
        cfg=cfg,
        init_params=lambda key, dtype=torch.float32: recurrent.zamba_init_params(cfg, key,
                                                                                 dtype),
        param_axes=lambda: recurrent.zamba_param_axes(cfg),
        loss_fn=loss_fn,
        prefill_fn=prefill_fn,
        decode_fn=decode_fn,
    )
