# Port of repro/configs/__init__.py (the JAX package): the same architectures, imported lazily.
"""Architecture configs (one module per architecture the port runs).

``get_config(name)`` returns the full published configuration;
``get_smoke_config(name)`` returns a reduced same-family configuration for
CPU smoke tests.  All ten architectures of the JAX package's zoo are
ported: the dense decoders (DeepSeek-7B, Mistral-NeMo-12B, StableLM-3B,
TinyLlama-1.1B), Qwen2-VL-2B's backbone, Llama-4 Scout's MoE,
DeepSeek-V2's MLA + MoE, Whisper-base's encoder-decoder, RWKV-6-3B and
Zamba2-7B (Mamba-2 with a shared attention block); any other name raises
and points at ROADMAP.md.
"""
from __future__ import annotations

import importlib

from ..models.config import ModelConfig

# The JAX package's ARCH_IDS, in its order.
ARCH_IDS = [
    "qwen2_vl_2b",
    "llama4_scout_17b_a16e",
    "deepseek_v2_236b",
    "deepseek_7b",
    "mistral_nemo_12b",
    "stablelm_3b",
    "tinyllama_1_1b",
    "whisper_base",
    "rwkv6_3b",
    "zamba2_7b",
]


# CLI ids use dashes (e.g. --arch tinyllama-1.1b).
def _norm(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def _module(name: str):
    arch = _norm(name)
    if arch not in ARCH_IDS:
        raise NotImplementedError(
            f"architecture {name!r} is not ported yet (the port runs "
            f"{ARCH_IDS}); see ROADMAP.md, Queue 2")
    return importlib.import_module(f".{arch}", __package__)


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()


__all__ = ["ARCH_IDS", "get_config", "get_smoke_config"]
