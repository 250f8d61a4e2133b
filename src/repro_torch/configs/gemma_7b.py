"""Gemma-7B [arXiv:2403.08295].

28L d_model=3072 16H (kv=16 MHA, head_dim=256) d_ff=24576 vocab=256000,
GeGLU, embeddings scaled by sqrt(d), RMSNorm(1+w)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab=256000, act="geglu", rope_theta=1e4,
    embed_scale=True, norm_plus_one=True, tie_embeddings=True,
    attn_strategy="heads",
))
