"""Feed-forward layers (counterpart of ``repro.models.mlp``): the gated
dense MLP and the capacity-bounded, expert-parallel MoE.

The MoE is the reference's ``_moe_local`` (``models/mlp.py:41-125``):
top-k routing, GShard-style dropping at ``cap`` assignments per expert in
the flat token-major order, a gather-based dispatch into an ``(E_loc, cap,
d)`` buffer and a weighted combine, over the ``E_loc`` experts a shard
holds.  On a mesh whose ``model`` axis is larger than one (reference
``models/mlp.py:1-10, 127-166``) the experts are sharded over ``model``
and each rank dispatches locally: tokens are replicated over ``model``
(sharded over the batch axes), the ``moe_fsdp`` weight shards are
all-gathered over ``data`` at use, ``y`` is summed over ``model`` and the
capacity counts local tokens, as in the reference.  The load-balance
``aux`` is the whole batch's (its two means summed over the batch shards
before their product, so it equals one device's; the reference's
``shard_map`` returns one data shard's).  Gradients flow through the
``DTensor`` placements (partial sums where a replicated operand meets a
rank's experts), as in ``sharding.einsum``.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.distrib.sharding import active_mesh, einsum, placements, resolve_spec, shard
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
def init_moe_params(key, cfg: ModelConfig, dtype=torch.float32, experts=None):
    """The router and the experts' weights; ``experts=(lo, hi)`` draws
    experts ``lo:hi`` alone (the values of those rows of the whole draw)."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    ks = split_keys(key, 4)
    return {
        "router": dense_init(ks[0], (d, E), d, dtype),
        "w1": dense_init(ks[1], (E, d, f), d, dtype, rows=experts),
        "w3": dense_init(ks[2], (E, d, f), d, dtype, rows=experts),
        "w2": dense_init(ks[3], (E, f, d), f, dtype, rows=experts),
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
    counts.index_add_(0, ids.reshape(-1), torch.ones((T * k,), dtype=counts.dtype,
                                                     device=xt.device))
    ce = counts * (1.0 / (T * k))
    aux = E * torch.sum(me * ce)

    flat_ids = ids.reshape(-1)
    cap = capacity(T, cfg)
    onehot = torch.nn.functional.one_hot(flat_ids, E).int()  # (T*k, E)
    pos = torch.gather(torch.cumsum(onehot, dim=0) - onehot, 1, flat_ids[:, None])[:, 0]
    return {"probs": probs, "ids": ids, "weights": weights, "aux": aux, "pos": pos,
            "keep": pos < cap, "cap": cap}


def _moe_local(x, p, cfg: ModelConfig, n_shards: int = 1, shard_idx: int = 0,
               stats: bool = False):
    """The MoE over the experts this shard holds (``p``'s ``E_loc`` experts,
    shard ``shard_idx`` of ``n_shards``; the router is whole).  x: (B, S,
    d).  Returns (y, aux), ``y`` the shard's experts' part of the output;
    with ``stats`` also the routing's ``probs`` summed over tokens and the
    assignments per expert ``(E,)``, for the whole batch's aux."""
    B, S, d = x.shape
    k = cfg.top_k
    E_loc = p["w1"].shape[0]
    act = act_fn(cfg.act)
    T = B * S
    A = T * k
    xt = x.reshape(T, d)
    r = moe_routing(xt, p["router"], cfg)
    cap = r["cap"]

    # this shard's experts: lo .. lo + E_loc - 1.  An assignment's position
    # among its expert's assignments is the same counted over all experts
    # or over the shard's, so the routing's ``pos`` and ``keep`` hold
    ids_l = r["ids"].reshape(-1) - shard_idx * E_loc
    keep = r["keep"] & (ids_l >= 0) & (ids_l < E_loc)
    slot = torch.where(keep, r["pos"], 0)

    # scatter the assignment indices into the (E_loc, cap) slot map (other
    # shards' and dropped assignments go to the extra row E_loc, sliced
    # off), then gather the expert buffer; A marks an empty slot
    e_idx = torch.where(keep, ids_l, E_loc)
    slot_src = torch.full((E_loc + 1, cap), A, dtype=torch.int64, device=x.device)
    slot_src[e_idx, slot] = torch.arange(A, device=x.device)
    slot_src = slot_src[:E_loc]
    filled = slot_src < A
    slot_tok = torch.clamp(slot_src, max=A - 1) // k  # the token of each assignment
    buf = torch.where(filled[..., None], xt[slot_tok], torch.zeros((), dtype=xt.dtype,
                                                                     device=x.device))

    h = act(torch.bmm(buf, p["w1"])) * torch.bmm(buf, p["w3"])
    y = torch.bmm(h, p["w2"])  # (E_loc, cap, d)

    # combine: each assignment's expert output, weighted, summed over k
    y_asg = y[torch.clamp(e_idx, max=E_loc - 1), slot]
    w_flat = torch.where(keep, r["weights"].reshape(-1), 0.0).to(y.dtype)
    out = (y_asg * w_flat[:, None]).reshape(T, k, d).sum(dim=1)
    if not stats:
        return out.reshape(B, S, d), r["aux"]
    counts = torch.zeros((cfg.n_experts,), dtype=r["probs"].dtype, device=x.device)
    counts.index_add_(0, r["ids"].reshape(-1), torch.ones((A,), dtype=counts.dtype,
                                                          device=x.device))
    return out.reshape(B, S, d), r["aux"], r["probs"].sum(dim=0), counts


def moe(x, p, cfg: ModelConfig):
    """The MoE layer. Returns (y, aux_loss): on one device over all
    experts; over DTensors on a mesh with a ``model`` axis, expert-parallel
    (see the module docstring; a ``model`` axis of one holds every expert
    on each rank)."""
    mesh = active_mesh()
    names = () if mesh is None else tuple(mesh.mesh_dim_names or ())
    if "model" in names and (isinstance(x, DTensor) or isinstance(p["w1"], DTensor)
                             or mesh.size(names.index("model")) > 1):
        return _moe_expert_parallel(x, p, cfg, mesh)
    w1 = p["w1"]
    held = (w1.to_local() if isinstance(w1, DTensor) else w1).shape[0]
    if held != cfg.n_experts:
        raise ValueError(
            f"{cfg.name}: parameters hold {held} of {cfg.n_experts} experts, and no mesh "
            "with a model axis larger than one is active to hold the rest")
    return _moe_local(x, p, cfg)


def _moe_expert_parallel(x, p, cfg: ModelConfig, mesh):
    """Reference ``models/mlp.py:127-166`` over DTensors: each rank runs
    ``_moe_local`` on its tokens and its experts."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    mi = names.index("model")
    n_shards = mesh.size(mi)
    if cfg.n_experts % n_shards:
        raise ValueError(f"{cfg.n_experts} experts not divisible by model={n_shards}")
    rep = [Replicate()] * mesh.ndim
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, rep, run_check=False)
    # tokens: sharded over the batch axes, replicated over model
    tok = list(placements(mesh, resolve_spec(("batch", None, None), x.shape)))
    tok[mi] = Replicate()
    if list(x.placements) != tok:
        x = x.redistribute(mesh, tok)
    batch_dims = [i for i, pl in enumerate(tok) if pl.is_shard()]
    # what a rank's local gradient is of: partial sums over model (a rank
    # meets its experts only) and over the batch axes (its tokens only)
    partial = [Partial() if i == mi or i in batch_dims else Replicate()
               for i in range(mesh.ndim)]
    x_loc = x.to_local(grad_placements=[Partial() if i == mi else tok[i]
                                        for i in range(mesh.ndim)])
    experts = [Shard(0) if i == mi else Replicate() for i in range(mesh.ndim)]

    def local(w, want, grad):
        if not isinstance(w, DTensor):
            w = DTensor.from_local(w, mesh, want, run_check=False)
        if list(w.placements) != want:  # the moe_fsdp shards gathered over data
            w = w.redistribute(mesh, want)
        return w.to_local(grad_placements=grad)

    grad_w = [Shard(0) if i == mi else partial[i] for i in range(mesh.ndim)]
    p_loc = {"router": local(p["router"], rep, partial),
             **{k: local(p[k], experts, grad_w) for k in ("w1", "w3", "w2")}}
    shard_idx = mesh.get_coordinate()[mi]
    y, _, prob_sum, counts = _moe_local(x_loc, p_loc, cfg, n_shards, shard_idx, stats=True)
    y = DTensor.from_local(y, mesh, [Partial() if i == mi else tok[i]
                                     for i in range(mesh.ndim)], run_check=False)
    y = y.redistribute(mesh, tok)

    # the whole batch's aux: the means over every token of every batch shard
    n_tok = x.shape[0] * x.shape[1]
    me = DTensor.from_local(prob_sum / n_shards, mesh, partial, run_check=False)
    ce = DTensor.from_local(counts, mesh, [Partial() if i in batch_dims else Replicate()
                                           for i in range(mesh.ndim)], run_check=False)
    me, ce = me.redistribute(mesh, rep), ce.redistribute(mesh, rep)
    aux = cfg.n_experts * torch.sum((me / n_tok) * (ce / (n_tok * cfg.top_k)))
    return y, aux
