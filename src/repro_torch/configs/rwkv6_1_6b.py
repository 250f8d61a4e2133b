"""RWKV6-1.6B "Finch" [arXiv:2404.05892] — attention-free, data-dependent
decay.  24L d_model=2048 (32 heads x 64) d_ff=7168 vocab=65536."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=0, head_dim=64,
    d_ff=7168, vocab=65536, act="rwkv_ffn", rope_theta=0.0,
    ssm_state=64, tie_embeddings=False, attn_strategy="heads",
))
