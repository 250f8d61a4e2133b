"""GQA attention (counterpart of ``repro.models.attention``): flash-style
(KV-chunked online softmax) for train/prefill, masked attention over the
whole KV cache for decode.

Tensors are constrained to the active mesh's sharding at the reference's
places (``distrib.sharding.shard``: a no-op with no mesh).  Train/prefill
is head-parallel ("heads": q/k/v heads over the model axis) or, for the
low-head archs, sequence-parallel ("seq_model"); decode keeps the KV cache
sharded along its sequence ("kv_seq"), the softmax reducing across shards
(flash-decode).  The attention is plain PyTorch, as the reference's is
plain JAX: it reaches no Pallas kernel.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distrib.sharding import einsum, full, shard, zeros
from repro_torch.models.common import apply_rope, dense_init, split_keys

# finite: a KV chunk wholly outside a query's window scores NEG_INF
# everywhere, and its contribution is zeroed by the next chunk's correction
# factor (with -inf it would give NaN)
NEG_INF = -1e30


def init_attn_params(key, cfg: ModelConfig, dtype=torch.float32):
    d, H, Hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ks = split_keys(key, 4)
    p = {
        "wq": dense_init(ks[0], (d, H, hd), d, dtype),
        "wk": dense_init(ks[1], (d, Hk, hd), d, dtype),
        "wv": dense_init(ks[2], (d, Hk, hd), d, dtype),
        "wo": dense_init(ks[3], (H, hd, d), H * hd, dtype),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, hd), dtype=dtype, device=key.device)
        p["bk"] = torch.zeros((Hk, hd), dtype=dtype, device=key.device)
        p["bv"] = torch.zeros((Hk, hd), dtype=dtype, device=key.device)
    return p


def _scale(hd: int) -> float:
    """``1 / sqrt(float32(hd))`` rounded to float32, as the reference's."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def _project_qkv(x, p, cfg: ModelConfig, positions):
    q = einsum("bsd,dhk->bshk", x, p["wq"])
    k = einsum("bsd,dhk->bshk", x, p["wk"])
    v = einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.rope_theta:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _expand_kv(k, n_heads: int):
    """GQA: repeat KV heads to the full head count."""
    Hk = k.shape[-2]
    if Hk == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // Hk, dim=-2)


def flash_attention(
    q,  # (B, Sq, H, hd)
    k,  # (B, Skv, Hk, hd)
    v,  # (B, Skv, Hk, hd)
    q_pos,  # (Sq,) absolute positions of queries
    kv_pos,  # (Skv,)
    window: Optional[int] = None,  # sliding window (None = full causal)
    chunk: int = 1024,
):
    """KV-chunked online-softmax attention (keeps peak memory at
    (B, Sq, H, chunk) instead of (B, Sq, H, Skv)).  The last chunk is not
    padded: the reference's padding keys are masked to exactly zero
    weight, so slicing gives the same sums."""
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    qf = q.float() * _scale(hd)
    chunk = min(chunk, Skv)

    m = full((B, Sq, H), NEG_INF, torch.float32, q)  # placed like q under a mesh
    l = zeros((B, Sq, H), torch.float32, q)
    o = zeros((B, Sq, H, hd), torch.float32, q)
    qp = q_pos[None, :, None, None]
    for c0 in range(0, Skv, chunk):
        kb, vb, pb = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk], kv_pos[c0:c0 + chunk]
        s = einsum("bqhd,bchd->bqhc", qf, kb.float())
        ok = qp >= pb
        if window is not None:
            ok = ok & (qp - pb < window)
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + einsum("bqhc,bchd->bqhd", p, vb.float())
        m = m_new
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out.to(q.dtype)


def attention_train(x, p, cfg: ModelConfig, positions, window=None):
    """Full-sequence attention (training / prefill forward)."""
    q, k, v = _project_qkv(x, p, cfg, positions)
    if cfg.attn_strategy == "sequence":
        q = shard(q, "batch", "seq_model", None, None)
        k = shard(k, "batch", None, None, None)
        v = shard(v, "batch", None, None, None)
    else:
        # expand KV to full heads before the constraint, so that the whole
        # attention is head-parallel even with fewer KV heads than shards
        k = _expand_kv(k, cfg.n_heads)
        v = _expand_kv(v, cfg.n_heads)
        q = shard(q, "batch", "seq", "heads", None)
        k = shard(k, "batch", "seq", "heads", None)
        v = shard(v, "batch", "seq", "heads", None)
    out = flash_attention(q, k, v, positions, positions, window=window)
    if cfg.attn_strategy == "sequence":
        out = shard(out, "batch", "seq_model", None, None)
    else:
        out = shard(out, "batch", "seq", "heads", None)
    y = einsum("bshk,hkd->bsd", out, p["wo"])
    return shard(y, "batch", "seq", None)


def attention_decode(x, p, cfg: ModelConfig, layer_k, layer_v, cache_len, window=None):
    """One-token decode against the whole KV cache.

    x: (B, 1, d); layer_k/v: (B, S, Hk, hd) (already containing this step's
    K/V at position cache_len); cache_len: a 0-d int32 tensor.
    """
    B = x.shape[0]
    pos = cache_len.reshape(1)
    q = einsum("bsd,dhk->bshk", x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    if cfg.rope_theta:
        q = apply_rope(q, pos, cfg.rope_theta)
    H, hd = cfg.n_heads, cfg.head_dim
    S = layer_k.shape[1]
    kf = _expand_kv(layer_k, H).float()
    vf = _expand_kv(layer_v, H).float()
    qf = (q.float() * _scale(hd)).reshape(B, H, hd)
    kv_pos = torch.arange(S, device=x.device)
    s = einsum("bhd,bshd->bhs", qf, kf)
    # flash-decode: the scores keep the cache's sequence sharding, so each
    # shard attends over its own KV chunk and only the softmax reductions
    # cross shards
    s = shard(s, "batch", None, "kv_seq")
    ok = kv_pos <= cache_len
    if window is not None:
        ok = ok & (cache_len - kv_pos < window)
    s = torch.where(ok, s, NEG_INF)
    w = shard(torch.softmax(s, dim=-1), "batch", None, "kv_seq")
    out = einsum("bhs,bshd->bhd", w, vf)
    out = out.reshape(B, 1, H, hd).to(x.dtype)
    return einsum("bshk,hkd->bsd", out, p["wo"])


def decode_kv_update(p, cfg: ModelConfig, x, cache_k, cache_v, cache_len):
    """Project this token's K/V and write them at cache_len: a masked select
    over the cache's sequence axis, as the reference writes it (it returns
    new caches; the inputs are left unchanged)."""
    pos = cache_len.reshape(1)
    k = einsum("bsd,dhk->bshk", x, p["wk"])
    v = einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    if cfg.rope_theta:
        k = apply_rope(k, pos, cfg.rope_theta)
    S = cache_k.shape[1]
    sel = (torch.arange(S, device=x.device) == cache_len)[None, :, None, None]
    ck = torch.where(sel, k.to(cache_k.dtype), cache_k)
    cv = torch.where(sel, v.to(cache_v.dtype), cache_v)
    return ck, cv
