"""Phi-3.5-MoE-42B-A6.6B [hf:microsoft/Phi-3.5-MoE-instruct].

32L d_model=4096 32H (GQA kv=8, head_dim=128), MoE 16 experts top-2 with
per-expert d_ff=6400, vocab=32064."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=6400, vocab=32064, act="swiglu", rope_theta=1e4,
    n_experts=16, top_k=2, tie_embeddings=False, attn_strategy="heads",
))
