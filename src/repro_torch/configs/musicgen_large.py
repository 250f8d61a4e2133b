"""MusicGen-large [arXiv:2306.05284] — decoder-only over EnCodec tokens.

48L d_model=2048 32H (kv=32 MHA, head_dim=64) d_ff=8192 vocab=2048.
The EnCodec modality frontend is a STUB: input_specs() provides
precomputed frame embeddings (per the assignment brief)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=2048, act="swiglu", rope_theta=1e4,
    tie_embeddings=False, attn_strategy="heads", frontend="audio_stub",
))
