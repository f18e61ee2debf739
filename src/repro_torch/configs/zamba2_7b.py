# Copied from repro/configs/zamba2_7b.py (the JAX package); imports the port's config.
"""zamba2-7b [hybrid] — 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64 — Mamba2 + shared attention blocks
[arXiv:2411.15242; unverified].

81 Mamba2 layers with one weight-shared attention+MLP block applied every
``shared_attn_period`` layers.  Sliding-window attention in the shared
block keeps the arch sub-quadratic for long_500k.
"""
from ..models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000, subquadratic=True,
    sliding_window=4096, shared_attn_period=6,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk=128),
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                         d_ff=128, vocab=256, shared_attn_period=2,
                         sliding_window=64,
                         ssm=SSMConfig(d_state=16, head_dim=16, expand=2,
                                       chunk=32))
