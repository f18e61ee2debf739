# Copied from repro/configs/deepseek_v2_236b.py (the JAX package); imports the port's config.
"""deepseek-v2-236b [moe] — 60L d_model=5120 128H d_ff=1536 vocab=102400,
MoE 160e top-6 — MLA kv_lora=512, 2 shared + 160 routed top-6
[arXiv:2405.04434; hf].
"""
from ..models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="mla_moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=1536, vocab=102400, rope_theta=1e4,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, n_shared=2, d_ff_expert=1536),
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96, vocab=256,
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=8,
                      nope_head_dim=16, v_head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, n_shared=1, d_ff_expert=96,
                      capacity_factor=8.0))
