"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3-235B-A22B family].

94L d_model=4096 64H (GQA kv=4, head_dim=128), MoE 128 experts top-8 with
per-expert d_ff=1536, vocab=151936."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab=151936, act="swiglu", rope_theta=1e6,
    n_experts=128, top_k=8, tie_embeddings=False, attn_strategy="heads",
))
