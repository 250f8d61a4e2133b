"""Zamba2-7B [arXiv:2411.15242] — Mamba2 backbone + shared attention blocks.

81 backbone blocks, d_model=3584, 32H shared attention (kv=32),
d_ff=14336, vocab=32000, ssm_state=64.  The shared attention block reuses
one parameter set at every application (Zamba's design); at 500k decode its
KV window is bounded at 32k (DESIGN.md §4)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab=32000, act="swiglu", rope_theta=1e4,
    ssm_state=64, shared_attn_period=6, shared_attn_window=32768,
    tie_embeddings=True, attn_strategy="heads",
))
