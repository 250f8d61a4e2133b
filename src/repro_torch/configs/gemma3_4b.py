"""Gemma3-4B [hf:google/gemma-3-4b-pt, unverified].

34L d_model=2560 8H (GQA kv=4, head_dim=256) d_ff=10240 vocab=262144,
5:1 local:global sliding-window pattern (window 1024), 128k context.
8 heads < 16-way model axis => sequence-parallel attention at train time."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=10240, vocab=262144, act="geglu", rope_theta=1e6,
    window_pattern=(1024, 6),  # layers with (i+1)%6==0 are global
    embed_scale=True, norm_plus_one=True, tie_embeddings=True,
    attn_strategy="sequence",
))
