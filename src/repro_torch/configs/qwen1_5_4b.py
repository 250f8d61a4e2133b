"""Qwen1.5-4B [hf:Qwen/Qwen1.5-4B family].

40L d_model=2560 20H (kv=20 MHA, head_dim=128) d_ff=6912 vocab=151936,
QKV bias.  20 heads is not divisible by the 16-way model axis, so the
train-time attention strategy is sequence-parallel (DESIGN.md §5)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, head_dim=128,
    d_ff=6912, vocab=151936, act="swiglu", qkv_bias=True, rope_theta=1e6,
    tie_embeddings=True, attn_strategy="sequence",
))
