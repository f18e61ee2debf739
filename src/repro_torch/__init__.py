"""PyTorch/CUDA port of the MIG VM-placement system (``repro``).

Module names follow the JAX package, so each module's counterpart is
found under the same path there.  Entry points run on the CUDA device
unless the caller passes ``device="cpu"`` (see :mod:`repro_torch.device`).
"""
