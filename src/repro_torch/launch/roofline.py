"""Roofline terms of a step from its per-device operation count
(counterpart of ``repro.launch.roofline``):

    compute    = device FLOPs / PEAK_FLOPS
    memory     = device bytes / HBM_BW
    collective = device collective bytes moved / LINK_BW

The counts come from ``launch.op_cost`` (the aten operations the step
dispatches, per device on a DTensor mesh), with the reference's ring
factors for the collectives.

The constants are the card's: NVIDIA's H100 SXM5 data sheet at its 700 W
power limit, 989 TFLOP/s dense bfloat16 on the tensor cores, 3.35 TB/s of
HBM3, and 450 GB/s each way per GPU over NVLink 4 (900 GB/s both ways).
A card set below 700 W runs slower than these.
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12  # dense bf16 / card
HBM_BW = 3.35e12  # bytes/s
LINK_BW = 450e9  # bytes/s, NVLink, each way


@dataclasses.dataclass
class Roofline:
    flops: float  # per-device counted flops
    hbm_bytes: float  # per-device bytes accessed
    coll_bytes: float  # per-device collective bytes moved (factored)
    coll_breakdown: dict
    n_devices: int
    model_flops: float  # 6*N*D (global, dense/active)
    hbm_bytes_min: float = 0.0  # perfect-fusion floor (2 x result bytes)

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / global counted flops (remat/redundancy waste)."""
        total = self.flops * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """useful compute time / achievable step time (max of terms)."""
        t_useful = self.model_flops / self.n_devices / PEAK_FLOPS
        t_step = max(self.t_compute, self.t_memory, self.t_collective)
        return t_useful / t_step if t_step else 0.0

    @property
    def t_memory_min(self) -> float:
        return self.hbm_bytes_min / HBM_BW

    def row(self) -> dict:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_memory_min_s": self.t_memory_min,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def analyze(cost, n_devices: int, model_flops: float) -> Roofline:
    """The roofline of an ``op_cost.OpCost`` (one device's count)."""
    return Roofline(
        flops=cost.flops,
        hbm_bytes=cost.bytes_accessed,
        coll_bytes=cost.coll_bytes,
        coll_breakdown=dict(cost.coll_breakdown),
        n_devices=n_devices,
        model_flops=model_flops,
        hbm_bytes_min=cost.bytes_min,
    )


_COUNT_CACHE: dict = {}


def exact_param_counts(cfg) -> tuple[float, float, float]:
    """(matmul-active params, expert params total, shared-block params),
    counted from ``init_params`` on the meta device (no allocation).

    "matmul-active" excludes the embedding table gather but includes the
    LM head (tied embeddings still pay the logits matmul)."""
    if cfg in _COUNT_CACHE:
        return _COUNT_CACHE[cfg]
    import numpy as np

    from repro_torch import rng
    from repro_torch.models.model_zoo import build_model
    from repro_torch.tree import tree_flatten_with_path

    shapes = build_model(cfg).init_params(rng.PRNGKey(0, device="meta"))
    total = expert = shared = 0.0
    for keys, leaf in tree_flatten_with_path(shapes).items():
        n = float(np.prod(leaf.shape))
        if keys == "embed":
            if cfg.tie_embeddings:
                total += n  # logits matmul reuses the table
            continue
        total += n
        if "/moe/w" in keys or keys.endswith(("moe/w1", "moe/w3", "moe/w2")):
            expert += n
        if keys.startswith("shared/"):
            shared += n
    _COUNT_CACHE[cfg] = (total, expert, shared)
    return total, expert, shared


def model_flops_for(cfg, shape) -> float:
    """Useful model FLOPs for the cell: 2*N_active*D per forward pass
    (+ attention score/value FLOPs, which 6ND omits and which dominate at
    32k context), x3 for training (bwd ~ 2x fwd).

    MoE: only top_k/n_experts of the expert store is active per token.
    Zamba: the shared block's params are *applied* n_groups times."""
    total, expert, shared = exact_param_counts(cfg)
    n_active = total - expert * (1.0 - cfg.top_k / max(cfg.n_experts, 1)) if cfg.n_experts else total
    if cfg.shared_attn_period:
        groups = cfg.n_layers // cfg.shared_attn_period
        n_active += shared * (groups - 1)

    B, S = shape.global_batch, shape.seq_len
    mult = 3.0 if shape.kind == "train" else 1.0
    tokens = B * S if shape.kind in ("train", "prefill") else B

    # attention score+value flops (causal ~ S/2 average context)
    attn = 0.0
    if cfg.n_kv_heads or cfg.shared_attn_period:
        H, hd = cfg.n_heads, cfg.head_dim
        if cfg.shared_attn_period:
            n_attn_layers = cfg.n_layers // cfg.shared_attn_period
        else:
            n_attn_layers = cfg.n_layers
        if shape.kind in ("train", "prefill"):
            if cfg.window_pattern:
                w, period = cfg.window_pattern
                ctx_local = min(w, S)
                n_glob = cfg.n_layers // period
                n_loc = cfg.n_layers - n_glob
                attn = 4.0 * B * H * hd * S * (
                    n_glob * (S / 2) + n_loc * ctx_local
                )
            else:
                ctx = min(S, getattr(cfg, "shared_attn_window", S)) if cfg.shared_attn_period else S
                attn = 4.0 * B * H * hd * S * (ctx / 2) * n_attn_layers
        else:  # decode: one token attends over the cache
            ctx = min(S, cfg.shared_attn_window) if cfg.shared_attn_period else S
            attn = 4.0 * B * H * hd * ctx * n_attn_layers

    return mult * (2.0 * n_active * tokens + attn)
