# Copied from repro/configs/rwkv6_3b.py (the JAX package); imports the port's config.
"""rwkv6-3b [ssm] — 32L d_model=2560 (attn-free) d_ff=8960 vocab=65536 —
Finch, data-dependent decay [arXiv:2404.05892; hf].
"""
from ..models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="rwkv6",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab=65536, subquadratic=True,
    ssm=SSMConfig(head_dim=64),
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                         d_ff=128, vocab=256,
                         ssm=SSMConfig(head_dim=16))
