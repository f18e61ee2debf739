# Copied from repro/configs/mistral_nemo_12b.py (the JAX package); imports the port's config.
"""mistral-nemo-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 — 128k ctx, head_dim=128
[hf:mistralai/Mistral-Nemo-Base-2407; hf].
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=131072, head_dim=128, rope_theta=1e6,
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=128, vocab=256, head_dim=16)
