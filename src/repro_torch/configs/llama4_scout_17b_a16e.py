# Copied from repro/configs/llama4_scout_17b_a16e.py (the JAX package); imports the port's config.
"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16e top-1 — MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].
"""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048, rope_theta=5e5,
    moe=MoEConfig(n_experts=16, top_k=1, n_shared=1, d_ff_expert=8192),
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=128, vocab=256,
                         moe=MoEConfig(n_experts=4, top_k=1, n_shared=1,
                                       d_ff_expert=128,
                                       capacity_factor=8.0))
