# Copied from repro/configs/whisper_base.py (the JAX package); imports the port's config.
"""whisper-base [audio] — 6L d_model=512 8H d_ff=2048 vocab=51865 —
enc-dec, conv frontend (stub) [arXiv:2212.04356; unverified].

Backbone only: the conv/audio frontend is a stub; ``input_specs`` provides
precomputed frame embeddings.  n_layers counts decoder layers, n_enc_layers
the encoder stack (whisper-base is 6+6).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=6, n_enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865, rope_theta=1e4, tie_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return CONFIG.scaled(n_layers=2, n_enc_layers=2, d_model=64, n_heads=4,
                         n_kv_heads=4, d_ff=128, vocab=256)
