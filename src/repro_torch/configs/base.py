"""Architecture + shape configuration and the --arch registry (the port's
copy of ``repro.configs.base``: data only, the same ten presets)."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "swiglu"  # swiglu | geglu
    qkv_bias: bool = False
    rope_theta: float = 1e6
    # sliding-window pattern: (local_window, period) => layer i is LOCAL
    # unless (i+1) % period == 0 (gemma3's 5:1 local:global). None = all full.
    window_pattern: Optional[tuple[int, int]] = None
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_capacity: float = 1.25
    # SSM / RWKV
    ssm_state: int = 0
    # Zamba-style shared attention block applied every `shared_attn_period`
    # backbone blocks (0 = none).
    shared_attn_period: int = 0
    shared_attn_window: int = 32768  # KV window for shared blocks at 500k
    # misc
    embed_scale: bool = False  # gemma multiplies embeddings by sqrt(d)
    tie_embeddings: bool = True
    norm_plus_one: bool = False  # gemma RMSNorm (1 + w)
    attn_strategy: str = "heads"  # heads | sequence (train-time TP choice)
    frontend: str = "none"  # none | audio_stub | vision_stub
    # full attention everywhere (=> long_500k inapplicable)?
    @property
    def pure_full_attention(self) -> bool:
        return (
            self.family not in ("ssm", "hybrid") and self.window_pattern is None
        )

    @property
    def q_per_kv(self) -> int:
        return max(1, self.n_heads // max(self.n_kv_heads, 1))

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + layers)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        attn = d * self.n_heads * self.head_dim + 2 * d * self.n_kv_heads * self.head_dim
        attn += self.n_heads * self.head_dim * d
        if self.family in ("ssm",):
            attn = 0  # replaced by the mixer params below
        n_gates = 3 if self.act in ("swiglu", "geglu") else 2
        if self.n_experts:
            ffn = self.n_experts * n_gates * d * self.d_ff
        else:
            ffn = n_gates * d * self.d_ff
        mixer = 0
        if self.family == "ssm":  # rwkv6-ish: r,k,v,g,o + decay/ffn
            mixer = 5 * d * d
        if self.family == "hybrid":  # mamba2-ish in/out proj + ssm params
            mixer = 0  # counted in attn/ffn approximations below
        per_layer = attn + ffn + mixer
        router = self.n_experts * d if self.n_experts else 0
        return emb + L * (per_layer + router + 2 * d)

    def active_param_count(self) -> int:
        if not self.n_experts:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        n_gates = 3
        full_ffn = self.n_experts * n_gates * d * self.d_ff
        act_ffn = self.top_k * n_gates * d * self.d_ff
        return self.param_count() - L * (full_ffn - act_ffn)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        load_all()
    return _REGISTRY[name]


def all_configs() -> dict[str, ModelConfig]:
    if not _REGISTRY:
        load_all()
    return dict(_REGISTRY)


def load_all():
    # import for registration side effects
    from repro_torch.configs import (  # noqa: F401
        gemma3_4b,
        gemma_7b,
        llava_next_mistral_7b,
        mistral_nemo_12b,
        musicgen_large,
        phi3_5_moe_42b_a6_6b,
        qwen1_5_4b,
        qwen3_moe_235b_a22b,
        rwkv6_1_6b,
        zamba2_7b,
    )


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """The assigned shape cells for this architecture (DESIGN.md §4)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.family in ("ssm", "hybrid"):
        out.append("long_500k")
    return out


def reduced(cfg: ModelConfig) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    return dataclasses.replace(
        cfg,
        n_layers=max(2, min(4, cfg.n_layers)),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else 0,
        head_dim=32,
        d_ff=256,
        vocab=512,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        window_pattern=(64, cfg.window_pattern[1]) if cfg.window_pattern else None,
        shared_attn_period=cfg.shared_attn_period and 3,
        shared_attn_window=256,
    )
