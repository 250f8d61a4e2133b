"""Unified model interface (counterpart of ``repro.models.model_zoo``):
``build_model(cfg)`` gives a ``Model`` bundling init / loss / prefill /
decode for ``--arch`` dispatch over the four families: the transformers
(dense, MoE, audio, vlm; the stub frontends take precomputed ``embeds``),
RWKV6 (``ssm``) and Zamba2 (``hybrid``).  ``loss_fn`` is the training
loss (``train.steps.make_train_step`` differentiates it), with the
reference's activation checkpointing (``remat``, on by default).  The
shape-aware fields that ``launch.dryrun`` traces a cell with are meta
tensors (shapes and dtypes, no storage) where the reference has
``ShapeDtypeStruct`` stand-ins: ``input_specs`` (a training batch),
``decode_state_spec`` (the decode state), and the logical-axis trees
``batch_axes`` / ``decode_state_axes`` that the launcher resolves to
placements.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distrib.sharding import active_mesh, einsum, shard
from repro_torch.models import recurrent, ssm, transformer
from repro_torch.tree import tree_map_with_path

Params = Any
AUX_COEF = 0.01


def cross_entropy(logits, labels):
    """Mean next-token NLL (float32) of ``logits (B, S, V)`` at ``labels``.

    Under a mesh the logits may be sharded along the vocabulary: the
    correct-class logit is then taken with the reference's one-hot
    contraction, which stays sharded and reduces with a small all-reduce,
    where a gather would all-gather the whole logits."""
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    if active_mesh() is None:
        ll = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    else:
        vocab = torch.arange(lf.shape[-1], device=labels.device)
        onehot = (labels[..., None] == vocab).float()
        ll = shard(einsum("bsv,bsv->bs", lf, onehot), "batch", "seq")  # sum the vocab's shards
    return torch.mean(logz - ll)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init_params: Callable  # (key, dtype) -> params on the key's device (transformers:
    # experts=(lo, hi) draws one shard of each MoE layer's experts)
    param_axes: Callable  # () -> logical-axis tree
    loss_fn: Callable  # (params, batch, remat=True, remat_policy=None) -> (loss, metrics)
    prefill_fn: Callable  # (params, batch, max_len) -> (logits, cache, len)
    decode_fn: Callable  # (params, cache, tokens, cache_len) -> (logits, cache)
    decode_state_spec: Callable  # (shape) -> tree of meta tensors
    decode_state_axes: Callable  # () -> logical-axis tree for the state
    input_specs: Callable  # (shape) -> batch of meta tensors
    batch_axes: Callable  # (shape) -> logical-axis tree for the batch

    def init_decode_state(self, shape: ShapeConfig, device=None):
        """The decode state of ``shape`` as zeros on ``device``."""
        return tree_map_with_path(
            lambda _, s: torch.zeros(s.shape, dtype=s.dtype, device=device),
            self.decode_state_spec(shape))


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _train_batch_specs(cfg: ModelConfig, shape: ShapeConfig):
    B, S = shape.global_batch, shape.seq_len
    if cfg.frontend in ("audio_stub", "vision_stub"):
        batch = {"embeds": _meta((B, S, cfg.d_model), torch.bfloat16),
                 "labels": _meta((B, S), torch.int32)}
        axes = {"embeds": ("batch", "seq", None), "labels": ("batch", "seq")}
    else:
        batch = {"tokens": _meta((B, S), torch.int32), "labels": _meta((B, S), torch.int32)}
        axes = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    return batch, axes


def _batch_fields(cfg: ModelConfig) -> dict:
    return {"input_specs": lambda shape: _train_batch_specs(cfg, shape)[0],
            "batch_axes": lambda shape: _train_batch_specs(cfg, shape)[1]}


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

    def decode_state_spec(shape: ShapeConfig):
        sh = (cfg.n_layers, shape.global_batch, shape.seq_len, cfg.n_kv_heads, cfg.head_dim)
        return {"k": _meta(sh, torch.bfloat16), "v": _meta(sh, torch.bfloat16)}

    def decode_state_axes():
        ax = (None, "batch", "kv_seq", "kv_heads", None)
        return {"k": ax, "v": ax}

    return Model(
        cfg=cfg,
        init_params=lambda key, dtype=torch.float32, **kw: transformer.init_params(cfg, key, dtype,
                                                                                   **kw),
        param_axes=lambda: transformer.param_axes(cfg),
        loss_fn=loss_fn,
        prefill_fn=lambda params, batch, max_len: transformer.prefill(params, cfg, batch,
                                                                      max_len),
        decode_fn=lambda params, cache, tokens, cache_len: transformer.decode_step(
            params, cfg, cache, tokens, cache_len),
        decode_state_spec=decode_state_spec,
        decode_state_axes=decode_state_axes,
        **_batch_fields(cfg),
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

    def decode_state_spec(shape: ShapeConfig):
        B, H, K = shape.global_batch, cfg.n_heads, cfg.head_dim
        return {"wkv": _meta((cfg.n_layers, B, H, K, K), torch.float32),
                "tshift1": _meta((cfg.n_layers, B, 1, cfg.d_model), torch.float32),
                "tshift2": _meta((cfg.n_layers, B, 1, cfg.d_model), torch.float32)}

    def decode_state_axes():
        return {"wkv": (None, "batch", "heads", None, None),
                "tshift1": (None, "batch", None, None),
                "tshift2": (None, "batch", None, None)}

    return Model(
        cfg=cfg,
        init_params=lambda key, dtype=torch.float32: recurrent.rwkv_init_params(cfg, key,
                                                                                dtype),
        param_axes=lambda: recurrent.rwkv_param_axes(cfg),
        loss_fn=loss_fn,
        prefill_fn=prefill_fn,
        decode_fn=decode_fn,
        decode_state_spec=decode_state_spec,
        decode_state_axes=decode_state_axes,
        **_batch_fields(cfg),
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

    def decode_state_spec(shape: ShapeConfig):
        B, window = shape.global_batch, min(cfg.shared_attn_window, shape.seq_len)
        H, P, N = cfg.n_heads, cfg.head_dim, cfg.ssm_state
        G = cfg.n_layers // cfg.shared_attn_period
        kv = (G, B, window, cfg.n_kv_heads, cfg.head_dim)
        return {"ssm": _meta((cfg.n_layers, B, H, N, P), torch.float32),
                "conv": _meta((cfg.n_layers, B, ssm.CONV_W - 1, H * P + 2 * N), torch.float32),
                "k": _meta(kv, torch.bfloat16), "v": _meta(kv, torch.bfloat16)}

    def decode_state_axes():
        return {"ssm": (None, "batch", "heads", None, None),
                "conv": (None, "batch", None, "state"),
                "k": (None, "batch", "kv_seq", "kv_heads", None),
                "v": (None, "batch", "kv_seq", "kv_heads", None)}

    return Model(
        cfg=cfg,
        init_params=lambda key, dtype=torch.float32: recurrent.zamba_init_params(cfg, key,
                                                                                 dtype),
        param_axes=lambda: recurrent.zamba_param_axes(cfg),
        loss_fn=loss_fn,
        prefill_fn=prefill_fn,
        decode_fn=decode_fn,
        decode_state_spec=decode_state_spec,
        decode_state_axes=decode_state_axes,
        **_batch_fields(cfg),
    )
