"""Recurrent-family models (counterpart of ``repro.models.recurrent``):
RWKV6 (attention-free) and Zamba2 (Mamba2 backbone + one shared attention
block applied periodically).

Both are state-based at decode: the "KV cache" is a fixed-size recurrent
state.  Zamba2's shared attention block keeps a bounded sliding KV window
(a ring buffer) so its cache is O(window), not O(context).  Parameters
are nested dicts whose layer leaves are stacked along a leading L axis,
as the reference stacks them; the port loops over that axis.
"""
from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch

from repro_torch import rng
from repro_torch.configs.base import ModelConfig
from repro_torch.distrib.sharding import einsum, lookup, shard, zeros
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import ssm
from repro_torch.models.common import (apply_rope, dense_init, lead_axes, remat as remat_call,
                                      rms_norm, split_keys, stack_layers, unstack_layers)

Params = dict[str, Any]


# ===========================================================================
# RWKV6
# ===========================================================================
def rwkv_init_params(cfg: ModelConfig, key, dtype=torch.float32) -> Params:
    ks = split_keys(key, cfg.n_layers + 3)
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype, device=key.device)

    def layer(i):
        k1, k2 = rng.split(ks[i], 2)
        return {
            "norm1": ones(),
            "norm2": ones(),
            "tmix": ssm.init_rwkv_tmix_params(k1, cfg, dtype),
            "cmix": ssm.init_rwkv_cmix_params(k2, cfg, dtype),
        }

    return {
        "embed": dense_init(ks[-3], (cfg.vocab, cfg.d_model), cfg.d_model, dtype),
        "layers": stack_layers(cfg.n_layers, layer),
        "final_norm": ones(),
        "lm_head": dense_init(ks[-2], (cfg.d_model, cfg.vocab), cfg.d_model, dtype),
    }


def rwkv_param_axes(cfg: ModelConfig):
    layer = {
        "norm1": (None,),
        "norm2": (None,),
        "tmix": {
            "mu": (None, "embed"),
            "wr": ("embed", "state"),
            "wk": ("embed", "state"),
            "wv": ("embed", "state"),
            "wg": ("embed", "state"),
            "wo": ("state", "embed"),
            "w0": ("state",),
            "wa": (None, None),
            "wb": (None, "state"),
            "u": ("heads", None),
            "ln_w": ("state",),
        },
        "cmix": {
            "mu": (None, "embed"),
            "wk": ("embed", "mlp"),
            "wv": ("mlp", "embed"),
            "wr": ("embed", None),
        },
    }
    return {
        "embed": ("vocab", "embed"),
        "layers": lead_axes(layer),
        "final_norm": ("embed",),
        "lm_head": ("embed", "vocab"),
    }


def rwkv_state_init(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None, like=None):
    """The zero decode state; placed by the decode state's logical axes
    under a mesh when ``like`` (the step's activations) is a DTensor."""
    H, K = cfg.n_heads, cfg.head_dim
    z = lambda shape, *axes: zeros(shape, dtype, device if like is None else like, *axes)
    return {
        "wkv": z((cfg.n_layers, batch, H, K, K), None, "batch", "heads", None, None),
        "tshift1": z((cfg.n_layers, batch, 1, cfg.d_model), None, "batch", None, None),
        "tshift2": z((cfg.n_layers, batch, 1, cfg.d_model), None, "batch", None, None),
    }


def _rwkv_layer(x, p, ts1, wkv0, ts2, cfg: ModelConfig):
    """One RWKV6 layer from its token-shift and WKV state: (x, (wkv, last
    token of the time mix, last token of the channel mix))."""
    h = rms_norm(x, p["norm1"])
    a, (last1, wkv1) = ssm.rwkv_tmix(h, ts1, p["tmix"], cfg, wkv0)
    x = x + a
    h = rms_norm(x, p["norm2"])
    m, last2 = ssm.rwkv_cmix(h, ts2, p["cmix"])
    return x + m, (wkv1, last1, last2)


def rwkv_forward(params: Params, cfg: ModelConfig, batch: dict, state=None,
                 remat: bool = False):
    """Returns (logits, aux=0, new_state). state=None -> zeros.  The state
    passed in is left unchanged.  With ``remat`` each layer's activations
    are recomputed in the backward."""
    x = shard(lookup(params["embed"], batch["tokens"]), "batch", "seq", None)
    B = x.shape[0]
    if state is None:
        state = rwkv_state_init(cfg, B, torch.float32, like=x)
    layer = functools.partial(_rwkv_layer, cfg=cfg)
    layers = unstack_layers(params["layers"])
    wkv, ts1, ts2 = [], [], []
    for i in range(cfg.n_layers):
        args = (x, layers[i], state["tshift1"][i], state["wkv"][i], state["tshift2"][i])
        x, (wkv1, last1, last2) = remat_call(layer, *args) if remat else layer(*args)
        wkv.append(wkv1)
        ts1.append(last1)
        ts2.append(last2)
    h = rms_norm(x, params["final_norm"])
    logits = shard(einsum("bsd,dv->bsv", h, params["lm_head"]), "batch", "seq", "vocab")
    new_state = {"wkv": torch.stack(wkv), "tshift1": torch.stack(ts1),
                 "tshift2": torch.stack(ts2)}
    return logits, torch.zeros((), dtype=torch.float32, device=x.device), new_state


# ===========================================================================
# Zamba2: mamba2 backbone + shared attention block every `period` layers
# ===========================================================================
def zamba_init_params(cfg: ModelConfig, key, dtype=torch.float32) -> Params:
    ks = split_keys(key, cfg.n_layers + 5)
    ones = lambda: torch.ones((cfg.d_model,), dtype=dtype, device=key.device)
    layers = stack_layers(cfg.n_layers, lambda i: {
        "norm": ones(), "mamba": ssm.init_mamba_params(ks[i], cfg, dtype)})
    k1, k2 = rng.split(ks[-4], 2)
    shared = {
        "norm1": ones(),
        "norm2": ones(),
        "attn": attn.init_attn_params(k1, cfg, dtype),
        "mlp": mlp_mod.init_mlp_params(k2, cfg, dtype),
    }
    return {
        "embed": dense_init(ks[-3], (cfg.vocab, cfg.d_model), cfg.d_model, dtype),
        "layers": layers,
        "shared": shared,
        "final_norm": ones(),
    }


def zamba_param_axes(cfg: ModelConfig):
    layer = {
        "norm": (None,),
        "mamba": {
            "in_x": ("embed", "state"),
            "in_z": ("embed", "state"),
            "in_bc": ("embed", None),
            "in_dt": ("embed", "heads"),
            "dt_bias": ("heads",),
            "a_log": ("heads",),
            "d_skip": ("heads",),
            "conv_w": (None, "state"),
            "out": ("state", "embed"),
        },
    }
    return {
        "embed": ("vocab", "embed"),
        "layers": lead_axes(layer),
        "shared": {
            "norm1": ("embed",),
            "norm2": ("embed",),
            "attn": {
                "wq": ("embed", "heads", "head_dim"),
                "wk": ("embed", "kv_heads", "head_dim"),
                "wv": ("embed", "kv_heads", "head_dim"),
                "wo": ("heads", "head_dim", "embed"),
            },
            "mlp": {
                "w1": ("embed", "mlp"),
                "w3": ("embed", "mlp"),
                "w2": ("mlp", "embed"),
            },
        },
        "final_norm": ("embed",),
    }


def _n_groups(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.shared_attn_period


def _groups(cfg: ModelConfig):
    """``(lo, hi, shared)`` per group of backbone layers: G groups of
    ``period`` layers, each followed by the shared block, then the
    remainder (no shared block after it)."""
    period, G = cfg.shared_attn_period, _n_groups(cfg)
    out = [(g * period, (g + 1) * period, True) for g in range(G)]
    if cfg.n_layers > G * period:
        out.append((G * period, cfg.n_layers, False))
    return out


def zamba_state_init(cfg: ModelConfig, batch: int, window: int, dtype=torch.float32,
                     device=None):
    H, P, N = cfg.n_heads, cfg.head_dim, cfg.ssm_state
    d_in = H * P
    G = _n_groups(cfg)
    kv = (G, batch, window, cfg.n_kv_heads, cfg.head_dim)
    return {
        "ssm": torch.zeros((cfg.n_layers, batch, H, N, P), dtype=dtype, device=device),
        "conv": torch.zeros((cfg.n_layers, batch, ssm.CONV_W - 1, d_in + 2 * N), dtype=dtype,
                            device=device),
        "k": torch.zeros(kv, dtype=torch.bfloat16, device=device),
        "v": torch.zeros(kv, dtype=torch.bfloat16, device=device),
    }


def _mamba_layer(x, p, conv0, s0, cfg: ModelConfig):
    """One backbone layer from its conv and SSM state: (x, (conv, SSM
    state))."""
    y, states = ssm.mamba_mixer(rms_norm(x, p["norm"]), p["mamba"], cfg, conv0, s0)
    return x + y, states


def _zero_states(x, cfg: ModelConfig):
    """A backbone layer's zero conv and SSM states for ``x``'s batch."""
    B = x.shape[0]
    H, P, N = cfg.n_heads, cfg.head_dim, cfg.ssm_state
    return (zeros((B, ssm.CONV_W - 1, H * P + 2 * N), x.dtype, x, "batch", None, "state"),
            zeros((B, H, N, P), torch.float32, x, "batch", "heads", None, None))


def _mamba_layers(x, layers, cfg: ModelConfig, lo: int, hi: int, conv=None, ssm_state=None):
    """Backbone layers lo..hi-1 of ``layers`` (``unstack_layers``) over x,
    each from its conv and SSM state (zeros where None).  Returns (x,
    [conv states], [SSM states])."""
    if conv is None:
        conv0, s0 = _zero_states(x, cfg)
    convs, ssms = [], []
    for i in range(lo, hi):
        if conv is not None:
            conv0, s0 = conv[i], ssm_state[i]
        x, (conv1, s1) = _mamba_layer(x, layers[i], conv0, s0, cfg)
        convs.append(conv1)
        ssms.append(s1)
    return x, convs, ssms


def _tied_logits(params, x):
    h = rms_norm(x, params["final_norm"])
    logits = einsum("bsd,dv->bsv", h, params["embed"].T.to(h.dtype))
    return shard(logits, "batch", "seq", "vocab")


def _shared_mlp(x, p, cfg: ModelConfig):
    return x + mlp_mod.mlp(rms_norm(x, p["norm2"]), p["mlp"], cfg)


def _shared_block_train(x, p, cfg: ModelConfig, positions):
    h = rms_norm(x, p["norm1"])
    x = x + attn.attention_train(h, p["attn"], cfg, positions, window=cfg.shared_attn_window)
    return _shared_mlp(x, p, cfg)


def zamba_forward(params: Params, cfg: ModelConfig, batch: dict, remat: bool = False):
    """Training forward (states start at zero). Returns (logits, aux).  With
    ``remat`` the activations of each backbone layer and of each
    application of the shared block are recomputed in the backward."""
    x = shard(lookup(params["embed"], batch["tokens"]), "batch", "seq", None)
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    conv0, s0 = _zero_states(x, cfg)
    mamba = functools.partial(_mamba_layer, cfg=cfg)
    shared = functools.partial(_shared_block_train, cfg=cfg, positions=positions)
    call = lambda fn, *args: remat_call(fn, *args) if remat else fn(*args)
    layers = unstack_layers(params["layers"])
    for lo, hi, has_shared in _groups(cfg):
        for i in range(lo, hi):
            x, _ = call(mamba, x, layers[i], conv0, s0)
        if has_shared:
            x = call(shared, x, params["shared"])
    return _tied_logits(params, x), torch.zeros((), dtype=torch.float32, device=x.device)


def zamba_prefill(params: Params, cfg: ModelConfig, batch: dict, window: int):
    """Forward over the prompt collecting final SSM/conv states and the
    shared-attention ring caches (the last ``window`` positions, position
    t at slot t % window). Returns (last_logits, state, cache_len)."""
    x = shard(lookup(params["embed"], batch["tokens"]), "batch", "seq", None)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    W = min(window, S)
    tail_pos = positions[-W:].long() % window
    p = params["shared"]
    convs, ssms, ks, vs = [], [], [], []
    layers = unstack_layers(params["layers"])
    for lo, hi, shared in _groups(cfg):
        x, conv1, s1 = _mamba_layers(x, layers, cfg, lo, hi)
        convs += conv1
        ssms += s1
        if shared:
            h = rms_norm(x, p["norm1"])
            q, k, v = attn._project_qkv(h, p["attn"], cfg, positions)
            q = shard(q, "batch", "seq", "heads", None)
            o = attn.flash_attention(q, k, v, positions, positions,
                                     window=cfg.shared_attn_window)
            x = x + shard(einsum("bshk,hkd->bsd", o, p["attn"]["wo"]), "batch", "seq", None)
            x = _shared_mlp(x, p, cfg)
            ring = (B, window, cfg.n_kv_heads, cfg.head_dim)
            # written whole along the window, then sharded along it (below)
            ck = zeros(ring, torch.bfloat16, x, "batch", None, "kv_heads", None)
            cv = zeros(ring, torch.bfloat16, x, "batch", None, "kv_heads", None)
            ck[:, tail_pos] = k[:, -W:].to(torch.bfloat16)
            cv[:, tail_pos] = v[:, -W:].to(torch.bfloat16)
            ks.append(shard(ck, "batch", "kv_seq", "kv_heads", None))
            vs.append(shard(cv, "batch", "kv_seq", "kv_heads", None))
    state = {"ssm": torch.stack(ssms), "conv": torch.stack(convs), "k": torch.stack(ks),
             "v": torch.stack(vs)}
    logits = _tied_logits(params, x[:, -1:, :])
    return logits, state, torch.tensor(S, dtype=torch.int32, device=x.device)


def zamba_decode_step(params: Params, cfg: ModelConfig, state, tokens, cache_len,
                      window: int):
    """One token through the hybrid stack with O(1) + O(window) state; the
    state passed in is left unchanged.  cache_len: a 0-d int32 tensor."""
    x = shard(lookup(params["embed"], tokens), "batch", None, None)  # (B,1,d)
    B = x.shape[0]
    Hq, Hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    Gq = Hq // Hk
    p = params["shared"]
    pa = p["attn"]
    pos = cache_len.reshape(1)
    slots = torch.arange(window, device=x.device)
    # ring-buffer write at cache_len % window (a masked select); RoPE uses
    # the absolute position, so overwriting old slots is consistent
    sel = (slots == cache_len % window)[None, :, None, None]
    # attend over the valid ring slots (all of them once cache_len >= window - 1)
    valid = slots <= cache_len
    sqrt_hd = float(np.sqrt(np.float32(hd)))
    convs, ssms, ks, vs = [], [], [], []
    layers = unstack_layers(params["layers"])
    for g, (lo, hi, shared) in enumerate(_groups(cfg)):
        x, conv1, s1 = _mamba_layers(x, layers, cfg, lo, hi, state["conv"], state["ssm"])
        convs += conv1
        ssms += s1
        if not shared:
            continue
        h = rms_norm(x, p["norm1"])
        k1 = einsum("bsd,dhk->bshk", h, pa["wk"])
        v1 = einsum("bsd,dhk->bshk", h, pa["wv"])
        q = einsum("bsd,dhk->bshk", h, pa["wq"])
        if cfg.rope_theta:
            k1 = apply_rope(k1, pos, cfg.rope_theta)
            q = apply_rope(q, pos, cfg.rope_theta)
        ck = shard(state["k"][g], "batch", "kv_seq", "kv_heads", None)
        cv = shard(state["v"][g], "batch", "kv_seq", "kv_heads", None)
        ck = torch.where(sel, k1.to(ck.dtype), ck)
        cv = torch.where(sel, v1.to(cv.dtype), cv)
        qf = (q.float() / sqrt_hd).reshape(B, Hk, Gq, hd)
        s = einsum("bkgh,bskh->bkgs", qf, ck.float())
        s = torch.where(valid, s, attn.NEG_INF)
        w = torch.softmax(s, dim=-1)
        o = einsum("bkgs,bskh->bkgh", w, cv.float())
        o = o.reshape(B, 1, Hq, hd).to(x.dtype)
        x = x + einsum("bshk,hkd->bsd", o, pa["wo"])
        x = _shared_mlp(x, p, cfg)
        ks.append(ck)
        vs.append(cv)
    new_state = {"ssm": torch.stack(ssms), "conv": torch.stack(convs), "k": torch.stack(ks),
                 "v": torch.stack(vs)}
    return _tied_logits(params, x), new_state
