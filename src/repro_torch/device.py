"""The port's device rule.

Every entry point takes ``device=None``, which means the CUDA device.
Without a card it raises rather than run on the CPU behind the caller's
back; callers that want the CPU (the tests) say ``device="cpu"``.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``torch.distributed`` DTensor (a step on a
    ``DeviceMesh``)."""
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)
