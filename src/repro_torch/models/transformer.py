"""Decoder-only transformer assembly (counterpart of
``repro.models.transformer``) for the dense, MoE, audio-stub and
vision-stub families.

Parameters are nested dicts of tensors; the layers' leaves are stacked
along a leading L axis, as the reference stacks them for its scan, and the
port loops over that axis.  The gemma3 5:1 local:global pattern is a
per-layer window (``window_schedule``).
"""
from __future__ import annotations

import functools
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distrib.sharding import einsum, lookup, shard, zeros
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (dense_init, lead_axes, remat as remat_call, rms_norm,
                                      split_keys, stack_layers, unstack_layers)

Params = dict[str, Any]


def _layer_init(key, cfg: ModelConfig, dtype, experts=None):
    ks = split_keys(key, 2)
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype, device=key.device)
    p = {"norm1": ones(), "norm2": ones(), "attn": attn.init_attn_params(ks[0], cfg, dtype)}
    if cfg.n_experts:
        p["moe"] = mlp_mod.init_moe_params(ks[1], cfg, dtype, experts=experts)
    else:
        p["mlp"] = mlp_mod.init_mlp_params(ks[1], cfg, dtype)
    return p


def init_params(cfg: ModelConfig, key, dtype=torch.float32, experts=None) -> Params:
    """The reference's parameters from ``key`` (layer i from ``ks[i]``, the
    embedding from ``ks[-3]``, the untied head from ``ks[-2]``), on the
    key's device.  ``experts=(lo, hi)``: each MoE layer holds experts
    ``lo:hi`` alone (one rank's shard, drawn without the rest)."""
    ks = split_keys(key, cfg.n_layers + 3)
    p: Params = {
        "embed": dense_init(ks[-3], (cfg.vocab, cfg.d_model), cfg.d_model, dtype),
        "layers": stack_layers(cfg.n_layers, lambda i: _layer_init(ks[i], cfg, dtype, experts)),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=key.device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(ks[-2], (cfg.d_model, cfg.vocab), cfg.d_model, dtype)
    return p


def _layer_axes(cfg: ModelConfig):
    a = {
        "norm1": ("embed",),
        "norm2": ("embed",),
        "attn": {
            "wq": ("embed", "heads", "head_dim"),
            "wk": ("embed", "kv_heads", "head_dim"),
            "wv": ("embed", "kv_heads", "head_dim"),
            "wo": ("heads", "head_dim", "embed"),
        },
    }
    if cfg.qkv_bias:
        a["attn"]["bq"] = ("heads", "head_dim")
        a["attn"]["bk"] = ("kv_heads", "head_dim")
        a["attn"]["bv"] = ("kv_heads", "head_dim")
    if cfg.n_experts:
        a["moe"] = {
            "router": ("embed", None),
            "w1": ("experts", None, "moe_fsdp"),
            "w3": ("experts", None, "moe_fsdp"),
            "w2": ("experts", "moe_fsdp", None),
        }
    else:
        a["mlp"] = {"w1": ("embed", "mlp"), "w3": ("embed", "mlp"), "w2": ("mlp", "embed")}
    return a


def param_axes(cfg: ModelConfig):
    """Logical-axis tree matching init_params' structure (layers get a
    leading None for the stacked L dim)."""
    axes = {
        "embed": ("vocab", "embed"),
        "layers": lead_axes(_layer_axes(cfg)),
        "final_norm": ("embed",),
    }
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    return axes


def window_schedule(cfg: ModelConfig, seq_len: int) -> list[int]:
    """Per-layer attention window (seq_len + 1 => effectively global): a
    list of ints, from the config alone."""
    if cfg.window_pattern is None:
        return [seq_len + 1] * cfg.n_layers
    w, period = cfg.window_pattern
    return [seq_len + 1 if (i + 1) % period == 0 else w for i in range(cfg.n_layers)]


def _scale_embed(x, cfg: ModelConfig):
    """gemma: x * sqrt(d), the float32 square root cast to x's dtype first."""
    if not cfg.embed_scale:
        return x
    return x * torch.tensor(float(np.sqrt(np.float32(cfg.d_model))), dtype=x.dtype)


def _embed_in(params, cfg: ModelConfig, batch):
    x = batch["embeds"] if "embeds" in batch else lookup(params["embed"], batch["tokens"])
    return shard(_scale_embed(x, cfg), "batch", "seq", None)


def _logits(params, cfg: ModelConfig, x):
    h = rms_norm(x, params["final_norm"], plus_one=cfg.norm_plus_one)
    head = params["lm_head"] if "lm_head" in params else params["embed"].T.to(h.dtype)
    return shard(einsum("bsd,dv->bsv", h, head), "batch", "seq", "vocab")


def _block(x, p, cfg: ModelConfig, attend):
    """One pre-norm block: ``x + attend(norm1(x))``, then the MLP or the
    MoE.  Returns (x, aux); aux is the MoE's load-balance loss, else None."""
    x = x + attend(rms_norm(x, p["norm1"], plus_one=cfg.norm_plus_one))
    h = rms_norm(x, p["norm2"], plus_one=cfg.norm_plus_one)
    if cfg.n_experts:
        m, aux = mlp_mod.moe(h, p["moe"], cfg)
        return x + m, aux
    return x + mlp_mod.mlp(h, p["mlp"], cfg), None


def _train_layer(x, p, cfg: ModelConfig, positions, window: int):
    """One layer of the training forward: (x, the MoE's aux loss or None)."""
    return _block(x, p, cfg, lambda h: attn.attention_train(h, p["attn"], cfg, positions,
                                                           window=window))


def forward(params: Params, cfg: ModelConfig, batch: dict, *, remat: bool = False,
            remat_policy: Optional[str] = None):
    """Training/eval forward.  Returns (logits, aux), aux the sum of the
    layers' MoE load-balance losses (0 for a dense model).  With ``remat``
    each layer's activations are recomputed in the backward
    (``common.remat``; ``remat_policy="dots"`` keeps the projections')."""
    x = _embed_in(params, cfg, batch)
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    windows = window_schedule(cfg, S)
    for p, window in zip(unstack_layers(params["layers"]), windows):
        layer = functools.partial(_train_layer, cfg=cfg, positions=positions, window=window)
        x, a = remat_call(layer, x, p, policy=remat_policy) if remat else layer(x, p)
        if a is not None:
            aux = aux + a
    return _logits(params, cfg, x), aux


# ---------------------------------------------------------------------------
# serving: prefill + decode with a KV cache
# ---------------------------------------------------------------------------
def prefill(params: Params, cfg: ModelConfig, batch: dict, max_len: int,
            cache_dtype=torch.bfloat16):
    """Forward over the prompt, returning (last_logits, cache, cache_len).

    The cache is (L, B, max_len, Hk, hd) for k and v, in bfloat16 whatever
    the parameters' dtype, as the reference stores it; ``cache_dtype``
    float32 keeps K/V unrounded (decode then computes what the full forward
    computes, at any depth).  cache_len is a 0-d int32 tensor."""
    x = _embed_in(params, cfg, batch)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    kv = (cfg.n_layers, B, max_len, cfg.n_kv_heads, cfg.head_dim)
    cache = {n: zeros(kv, cache_dtype, x, None, "batch", "kv_seq", "kv_heads", None)
             for n in ("k", "v")}

    layers = unstack_layers(params["layers"])
    for i, window in enumerate(window_schedule(cfg, S)):
        p = layers[i]

        def attend(h):
            q, k, v = attn._project_qkv(h, p["attn"], cfg, positions)
            q = shard(q, "batch", "seq", "heads", None)
            k = shard(k, "batch", "kv_seq", "kv_heads", None)
            v = shard(v, "batch", "kv_seq", "kv_heads", None)
            cache["k"][i, :, :S] = k
            cache["v"][i, :, :S] = v
            # resharded once per layer, heads like q's: the flash loop slices
            # K/V by chunk, which along a sharded sequence gathers each chunk
            k, v = (shard(attn._expand_kv(t, cfg.n_heads), "batch", "seq", "heads", None)
                    for t in (k, v))
            o = attn.flash_attention(q, k, v, positions, positions, window=window)
            return shard(einsum("bshk,hkd->bsd", o, p["attn"]["wo"]), "batch", "seq", None)

        x, _ = _block(x, p, cfg, attend)
    logits = _logits(params, cfg, x[:, -1:, :])
    return logits, cache, torch.tensor(S, dtype=torch.int32, device=x.device)


def decode_step(params: Params, cfg: ModelConfig, cache, tokens, cache_len):
    """One decode step. tokens: (B, 1) int (or embeds (B, 1, d));
    cache: {"k","v"}: (L, B, S, Hk, hd); cache_len: a 0-d int32 tensor.
    Returns (logits, new cache); the cache passed in is left unchanged."""
    x = tokens if tokens.ndim == 3 else lookup(params["embed"], tokens)
    x = shard(_scale_embed(x, cfg), "batch", None, None)
    S = cache["k"].shape[2]
    new = {"k": torch.empty_like(cache["k"]), "v": torch.empty_like(cache["v"])}
    layers = unstack_layers(params["layers"])
    for i, window in enumerate(window_schedule(cfg, S)):
        p = layers[i]

        def attend(h):
            ck = shard(cache["k"][i], "batch", "kv_seq", "kv_heads", None)
            cv = shard(cache["v"][i], "batch", "kv_seq", "kv_heads", None)
            ck, cv = attn.decode_kv_update(p["attn"], cfg, h, ck, cv, cache_len)
            new["k"][i], new["v"][i] = ck, cv
            a = attn.attention_decode(h, p["attn"], cfg, ck, cv, cache_len, window=window)
            return shard(a, "batch", None, None)

        x, _ = _block(x, p, cfg, attend)
    return _logits(params, cfg, x), new
