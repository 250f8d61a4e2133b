"""LLaVA-Next (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf].

Backbone: 32L d_model=4096 32H (GQA kv=8, head_dim=128) d_ff=14336
vocab=32000.  The anyres vision tiling frontend is a STUB: input_specs()
provides precomputed patch embeddings concatenated with token embeddings."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=32000, act="swiglu", rope_theta=1e6,
    tie_embeddings=False, attn_strategy="heads", frontend="vision_stub",
))
