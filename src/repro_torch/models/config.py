# Copied unchanged from repro/models/config.py (the JAX package), so the port imports nothing of it.
"""Unified model configuration for the 10 assigned architectures."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0
    d_ff_expert: int = 0           # expert hidden dim (d_ff if 0)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD block parameters (Zamba2) / RWKV-6 head size."""
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    chunk: int = 128              # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense|moe|mla_moe|rwkv6|hybrid|encdec|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None       # default d_model // n_heads
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rope_theta: float = 1e4
    mrope: bool = False                  # Qwen2-VL multi-axis RoPE
    sliding_window: Optional[int] = None  # hybrid attn at long context
    shared_attn_period: int = 6          # Zamba2: shared block cadence
    n_enc_layers: int = 0                # Whisper encoder depth
    subquadratic: bool = False           # can run long_500k
    tie_embeddings: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def scaled(self, **kw) -> "ModelConfig":
        """A reduced copy for smoke tests."""
        return dataclasses.replace(self, **kw)


# ----------------------------------------------------------------------------
# Input shape grid (assigned): every LM cell is seq_len x global_batch.
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str      # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

__all__ = ["ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig",
           "ShapeConfig", "SHAPES"]
