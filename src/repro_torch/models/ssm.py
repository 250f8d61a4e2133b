"""Attention-free mixers (counterpart of ``repro.models.ssm``): RWKV6
("Finch", data-dependent per-channel decay) and Mamba2-style SSD
(scalar-per-head decay), in chunked linear-attention form over a prompt
and in one-token form for decode.

Chunked form (chunk c, within-chunk cumulative log-decay logP_t):

    S_t = exp(logP_t) ⊙ S_0 + Σ_{s<=t} exp(logP_t - logP_s) ⊙ k_s^T v_s

Every exponent is a difference with t >= s, hence <= 0.  The reference
scans over the chunks; the port computes each chunk's intra-chunk terms
for all chunks at once and loops over the chunks only to carry the state
(the same per-chunk arithmetic).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distrib.sharding import einsum, shard
from repro_torch.models.common import dense_init, sigmoid, silu, softplus, split_keys

LOG_DECAY_FLOOR = -8.0  # per-step clamp; exp(-8) ~ 3e-4 per step


def _chunks(t, n: int, c: int):
    """(B, S, ...) -> (B, n, c, ...) as float32 (the einsums name the chunk
    axis x)."""
    return t.float().reshape(t.shape[0], n, c, *t.shape[2:])


def _carry(S0, decay_end, inc):
    """The state at each chunk's start and after the last:
    ``S_{j+1} = decay_end[:, j] * S_j + inc[:, j]``.  Returns
    (starts (B, n, ...), final)."""
    starts = []
    for j in range(inc.shape[1]):
        starts.append(S0)
        S0 = decay_end[:, j] * S0 + inc[:, j]
    return torch.stack(starts, dim=1), S0


# ---------------------------------------------------------------------------
# generic chunked scans
# ---------------------------------------------------------------------------
def chunked_rwkv(r, k, v, logw, u, state0, chunk: int = 16):
    """RWKV6 WKV. r,k,logw: (B,S,H,K); v: (B,S,H,V); u: (H,K);
    state0: (B,H,K,V). Returns (y (B,S,H,V), state (B,H,K,V))."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    c = min(chunk, S)
    assert S % c == 0, (S, c)
    n = S // c
    rb, kb, vb = _chunks(r, n, c), _chunks(k, n, c), _chunks(v, n, c)
    lwb = _chunks(torch.clamp(logw.float(), LOG_DECAY_FLOOR, 0.0), n, c)  # (B,n,c,H,K)
    logP = torch.cumsum(lwb, dim=2)  # inclusive
    # the state at each chunk's start: S1 = P_end * S0 + Σ_s (P_end / P_s) k_s^T v_s
    decay_to_end = torch.exp(logP[:, :, -1:] - logP)  # (B,n,c,H,K)
    inc = einsum("bxshk,bxshv->bxhkv", kb * decay_to_end, vb)
    starts, state = _carry(state0.float(), torch.exp(logP[:, :, -1])[..., None], inc)
    # inter-chunk: y_t = (r_t * P_{t-1}) S0 ; P_{t-1} = P_t / w_t
    rP = rb * torch.exp(logP - lwb)
    y = einsum("bxthk,bxhkv->bxthv", rP, starts)
    # intra-chunk, strictly causal (s < t): D = P_{t-1} / P_s
    D = torch.exp((logP - lwb)[:, :, :, None] - logP[:, :, None])  # (B,n,t,s,H,K)
    mask = (torch.arange(c, device=r.device)[:, None]
            > torch.arange(c, device=r.device)[None, :])[None, None, :, :, None, None]
    A = einsum("bxthk,bxtshk->bxths", rb, kb[:, :, None] * torch.where(mask, D, 0.0))
    y = y + einsum("bxths,bxshv->bxthv", A, vb)
    # bonus (s == t)
    y = y + (rb * (u.float() * kb)).sum(dim=-1, keepdim=True) * vb
    return y.reshape(B, S, H, V).to(r.dtype), state


def rwkv_step(r, k, v, logw, u, state):
    """Single-token recurrence. r,k,logw: (B,H,K); v: (B,H,V);
    state: (B,H,K,V)."""
    r, k, v = r.float(), k.float(), v.float()
    w = torch.exp(torch.clamp(logw.float(), LOG_DECAY_FLOOR, 0.0))
    kv = k[..., :, None] * v[..., None, :]  # (B,H,K,V)
    y = einsum("bhk,bhkv->bhv", r, state + u[None, ..., None] * kv)
    new_state = w[..., None] * state + kv
    return y, new_state


def chunked_ssd(r, k, v, loga, state0, chunk: int = 32):
    """Mamba2 SSD. r(C),k(B): (B,S,H,N); v(x): (B,S,H,P); loga: (B,S,H);
    state0: (B,H,N,P). y_t = C_t h_t (read AFTER update)."""
    B, S, H, N = r.shape
    P = v.shape[-1]
    c = min(chunk, S)
    assert S % c == 0
    n = S // c
    rb, kb, vb = _chunks(r, n, c), _chunks(k, n, c), _chunks(v, n, c)
    lab = _chunks(torch.clamp(loga.float(), LOG_DECAY_FLOOR, 0.0), n, c)  # (B,n,c,H)
    logP = torch.cumsum(lab, dim=2)
    decay_to_end = torch.exp(logP[:, :, -1:] - logP)  # (B,n,c,H)
    inc = einsum("bxshm,bxshp->bxhmp", kb * decay_to_end[..., None], vb)
    starts, state = _carry(state0.float(), torch.exp(logP[:, :, -1])[..., None, None], inc)
    y = einsum("bxthm,bxhmp->bxthp", rb * torch.exp(logP)[..., None], starts)
    # D[b,x,t,h,s] = exp(logP_t - logP_s)
    D = torch.exp(logP[..., None] - logP.transpose(2, 3)[:, :, None])
    mask = (torch.arange(c, device=r.device)[:, None]
            >= torch.arange(c, device=r.device)[None, :])[None, None, :, None, :]
    A = einsum("bxthm,bxshm->bxths", rb, kb) * torch.where(mask, D, 0.0)
    y = y + einsum("bxths,bxshp->bxthp", A, vb)
    return y.reshape(B, S, H, P).to(r.dtype), state


def ssd_step(r, k, v, loga, state):
    """r,k: (B,H,N); v: (B,H,P); loga: (B,H); state: (B,H,N,P)."""
    a = torch.exp(torch.clamp(loga.float(), LOG_DECAY_FLOOR, 0.0))
    new_state = a[..., None, None] * state + k.float()[..., :, None] * v.float()[..., None, :]
    y = einsum("bhn,bhnp->bhp", r.float(), new_state)
    return y, new_state


# ---------------------------------------------------------------------------
# RWKV6 blocks
# ---------------------------------------------------------------------------
def init_rwkv_tmix_params(key, cfg: ModelConfig, dtype=torch.float32):
    d = cfg.d_model
    H, K = cfg.n_heads, cfg.head_dim
    ks = split_keys(key, 8)
    lora = 64
    full = lambda shape, v: torch.full(shape, v, dtype=dtype, device=key.device)
    return {
        "mu": full((5, d), 0.5),  # lerp coeffs for r,k,v,g,w
        "wr": dense_init(ks[0], (d, d), d, dtype),
        "wk": dense_init(ks[1], (d, d), d, dtype),
        "wv": dense_init(ks[2], (d, d), d, dtype),
        "wg": dense_init(ks[3], (d, d), d, dtype),
        "wo": dense_init(ks[4], (d, d), d, dtype),
        "w0": full((d,), -2.0),  # base log-log decay
        "wa": dense_init(ks[5], (d, 64), d, dtype),
        "wb": dense_init(ks[6], (lora, d), lora, dtype) * 0.1,
        "u": dense_init(ks[7], (H, K), K, dtype),
        "ln_w": full((d,), 1.0),
    }


def _token_shift(x, prev):
    """prev: (B,1,d) last token of the previous segment (zeros at start)."""
    return torch.cat([prev.to(x.dtype), x[:, :-1]], dim=1)


def rwkv_tmix(x, prev_tok, p, cfg: ModelConfig, state0):
    """x: (B,S,d). Returns (y, (last_token, state))."""
    B, S, d = x.shape
    H, K = cfg.n_heads, cfg.head_dim
    xs = _token_shift(x, prev_tok)
    lerp = lambda i: x + (xs - x) * p["mu"][i]
    proj = lambda i, w: einsum("bsd,de->bse", lerp(i), p[w])
    r = proj(0, "wr").reshape(B, S, H, K)
    k = proj(1, "wk").reshape(B, S, H, K)
    v = proj(2, "wv").reshape(B, S, H, K)
    g = silu(proj(3, "wg"))
    # data-dependent decay (the Finch hallmark): low-rank dynamic log-decay
    lora = einsum("bsd,dl->bsl", torch.tanh(lerp(4)), p["wa"])
    ww = p["w0"] + einsum("bsl,le->bse", lora, p["wb"])
    logw = -torch.exp(torch.clamp(ww.float(), -10.0, 2.0))  # < 0
    logw = logw.reshape(B, S, H, K)
    r, k, v = (shard(t, "batch", "seq", "heads", None) for t in (r, k, v))
    y, state = chunked_rwkv(r, k, v, logw, p["u"], state0)
    # per-head group norm (approximated with RMS over head dims)
    yh = y.float()
    yh = yh * torch.rsqrt(torch.mean(yh * yh, dim=-1, keepdim=True) + 1e-5)
    y = (yh.reshape(B, S, d) * p["ln_w"]).to(x.dtype)
    y = einsum("bsd,de->bse", y * g, p["wo"])
    return shard(y, "batch", "seq", None), (x[:, -1:], state)


def init_rwkv_cmix_params(key, cfg: ModelConfig, dtype=torch.float32):
    d, f = cfg.d_model, cfg.d_ff
    ks = split_keys(key, 3)
    return {
        "mu": torch.full((2, d), 0.5, dtype=dtype, device=key.device),
        "wk": dense_init(ks[0], (d, f), d, dtype),
        "wv": dense_init(ks[1], (f, d), f, dtype),
        "wr": dense_init(ks[2], (d, d), d, dtype),
    }


def rwkv_cmix(x, prev_tok, p):
    xs = _token_shift(x, prev_tok)
    xk = x + (xs - x) * p["mu"][0]
    xr = x + (xs - x) * p["mu"][1]
    k = torch.square(torch.relu(einsum("bsd,df->bsf", xk, p["wk"])))
    k = shard(k, "batch", "seq", "mlp")
    kv = einsum("bsf,fd->bsd", k, p["wv"])
    r = sigmoid(einsum("bsd,de->bse", xr, p["wr"]))
    return shard(r * kv, "batch", "seq", None), x[:, -1:]


# ---------------------------------------------------------------------------
# Mamba2-style mixer (zamba2 backbone)
# ---------------------------------------------------------------------------
CONV_W = 4


def init_mamba_params(key, cfg: ModelConfig, dtype=torch.float32):
    d = cfg.d_model
    H, P = cfg.n_heads, cfg.head_dim
    N = cfg.ssm_state
    d_in = H * P
    ks = split_keys(key, 6)
    full = lambda shape, v: torch.full(shape, v, dtype=dtype, device=key.device)
    return {
        "in_x": dense_init(ks[0], (d, d_in), d, dtype),
        "in_z": dense_init(ks[1], (d, d_in), d, dtype),
        "in_bc": dense_init(ks[2], (d, 2 * N), d, dtype),
        "in_dt": dense_init(ks[3], (d, H), d, dtype),
        "dt_bias": full((H,), 0.0),
        "a_log": full((H,), 0.0),  # A = -exp(a_log)
        "d_skip": full((H,), 1.0),
        "conv_w": dense_init(ks[4], (CONV_W, d_in + 2 * N), CONV_W, dtype),
        "out": dense_init(ks[5], (d_in, d), d_in, dtype),
    }


def _causal_conv(u, w, prev):
    """Depthwise causal conv, width CONV_W. u: (B,S,C); w: (CONV_W,C);
    prev: (B, CONV_W-1, C) left context."""
    x = torch.cat([prev.to(u.dtype), u], dim=1)
    S = u.shape[1]
    out = x[:, 0:S] * w[0]
    for i in range(1, CONV_W):
        out = out + x[:, i:i + S] * w[i]
    return silu(out), x[:, -(CONV_W - 1):]


def mamba_mixer(x, p, cfg: ModelConfig, conv_prev, state0):
    """x: (B,S,d). Returns (y, (conv_state, ssm_state))."""
    B, S, d = x.shape
    H, P, N = cfg.n_heads, cfg.head_dim, cfg.ssm_state
    d_in = H * P
    xz = einsum("bsd,de->bse", x, p["in_z"])
    xi = einsum("bsd,de->bse", x, p["in_x"])
    bc = einsum("bsd,dn->bsn", x, p["in_bc"])
    dt = softplus(einsum("bsd,dh->bsh", x, p["in_dt"]) + p["dt_bias"])
    conv_out, conv_state = _causal_conv(torch.cat([xi, bc], dim=-1), p["conv_w"], conv_prev)
    xi = conv_out[..., :d_in].reshape(B, S, H, P)
    Bm = conv_out[..., d_in:d_in + N][:, :, None, :].expand(B, S, H, N)
    Cm = conv_out[..., d_in + N:][:, :, None, :].expand(B, S, H, N)
    loga = -torch.exp(p["a_log"])[None, None, :] * dt  # (B,S,H)
    v = xi * dt[..., None]  # fold dt into the input (standard SSD form)
    Cm = shard(Cm, "batch", "seq", "heads", None)
    v = shard(v, "batch", "seq", "heads", None)
    y, state = chunked_ssd(Cm, Bm, v, loga, state0)
    y = y + xi * p["d_skip"][None, None, :, None]
    y = y.reshape(B, S, d_in) * silu(xz)
    out = einsum("bse,ed->bsd", y, p["out"])
    return shard(out, "batch", "seq", None), (conv_state, state)
