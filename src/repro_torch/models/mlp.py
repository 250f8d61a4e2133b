"""Feed-forward layers (counterpart of ``repro.models.mlp``): the gated
dense MLP and the capacity-bounded MoE on one card.

The MoE is the reference's single-shard ``_moe_local``: top-k routing,
GShard-style dropping at ``cap`` assignments per expert in the flat
token-major order, a gather-based dispatch into an ``(E, cap, d)`` buffer
and a weighted combine.  The reference's expert-parallel branch (experts
sharded over a mesh axis, one psum) is multi-GPU and is not ported.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.distrib.sharding import einsum, shard
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
    h = act(einsum("bsd,df->bsf", x, p["w1"])) * einsum("bsd,df->bsf", x, p["w3"])
    h = shard(h, "batch", "seq", "mlp")
    return shard(einsum("bsf,fd->bsd", h, p["w2"]), "batch", "seq", None)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def init_moe_params(key, cfg: ModelConfig, dtype=torch.float32):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    ks = split_keys(key, 4)
    return {
        "router": dense_init(ks[0], (d, E), d, dtype),
        "w1": dense_init(ks[1], (E, d, f), d, dtype),
        "w3": dense_init(ks[2], (E, d, f), d, dtype),
        "w2": dense_init(ks[3], (E, f, d), f, dtype),
    }


def capacity(T: int, cfg: ModelConfig) -> int:
    """Assignments each expert accepts from ``T`` tokens; the floor keeps
    decode (T small) from ever dropping."""
    k = cfg.top_k
    return max(int((T * k / cfg.n_experts) * cfg.moe_capacity) + 1, min(T * k, 32))


def moe_routing(xt, router, cfg: ModelConfig) -> dict:
    """Routing of ``xt (T, d)``: ``probs (T, E)`` (float32 softmax of the
    router logits, computed in ``xt``'s dtype), ``ids``/``weights (T, k)``
    (top-k, the lower expert first on ties, as ``lax.top_k``; weights
    renormalised), the load-balance ``aux``, and per flat assignment
    ``(T*k,)`` its slot ``pos`` in its expert's buffer and ``keep`` (slot
    below ``cap``)."""
    T = xt.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    logits = einsum("td,de->te", xt, router).float()
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = weights[:, :k], ids[:, :k]
    weights = weights / weights.sum(dim=-1, keepdim=True)

    me = probs.mean(dim=0)
    counts = torch.zeros((E,), dtype=torch.float32, device=xt.device)
    counts.index_add_(0, ids.reshape(-1), torch.ones((T * k,), dtype=torch.float32,
                                                     device=xt.device))
    ce = counts * (1.0 / (T * k))
    aux = E * torch.sum(me * ce)

    flat_ids = ids.reshape(-1)
    cap = capacity(T, cfg)
    onehot = torch.nn.functional.one_hot(flat_ids, E).int()  # (T*k, E)
    pos = torch.gather(torch.cumsum(onehot, dim=0) - onehot, 1, flat_ids[:, None])[:, 0]
    return {"probs": probs, "ids": ids, "weights": weights, "aux": aux, "pos": pos,
            "keep": pos < cap, "cap": cap}


def _moe_local(x, p, cfg: ModelConfig):
    """All experts on this card. x: (B, S, d). Returns (y, aux)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    act = act_fn(cfg.act)
    T = B * S
    A = T * k
    xt = x.reshape(T, d)
    r = moe_routing(xt, p["router"], cfg)
    keep, cap = r["keep"], r["cap"]
    slot = torch.where(keep, r["pos"], 0)

    # scatter the assignment indices into the (E, cap) slot map (dropped
    # assignments go to the extra row E, sliced off), then gather the
    # expert buffer; A marks an empty slot
    e_idx = torch.where(keep, r["ids"].reshape(-1), E)
    slot_src = torch.full((E + 1, cap), A, dtype=torch.int64, device=x.device)
    slot_src[e_idx, slot] = torch.arange(A, device=x.device)
    slot_src = slot_src[:E]
    filled = slot_src < A
    slot_tok = torch.clamp(slot_src, max=A - 1) // k  # the token of each assignment
    buf = torch.where(filled[..., None], xt[slot_tok], torch.zeros((), dtype=xt.dtype,
                                                                     device=x.device))

    h = act(torch.bmm(buf, p["w1"])) * torch.bmm(buf, p["w3"])
    y = torch.bmm(h, p["w2"])  # (E, cap, d)

    # combine: each assignment's expert output, weighted, summed over k
    y_asg = y[torch.clamp(e_idx, max=E - 1), slot]
    w_flat = torch.where(keep, r["weights"].reshape(-1), 0.0).to(y.dtype)
    out = (y_asg * w_flat[:, None]).reshape(T, k, d).sum(dim=1)
    return out.reshape(B, S, d), r["aux"]


def moe(x, p, cfg: ModelConfig):
    """The MoE layer on one card. Returns (y, aux_loss)."""
    w1 = p["w1"]
    held = (w1.to_local() if isinstance(w1, DTensor) else w1).shape[0]  # a mesh: the shard's
    if held != cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: parameters hold {held} of {cfg.n_experts} experts; "
            "expert parallelism over several cards is not ported yet (ROADMAP.md, queue 1 "
            "item 12, multi-GPU)")
    return _moe_local(x, p, cfg)
