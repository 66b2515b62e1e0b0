"""PyTorch / CUDA port of the `repro` serving stack for NVIDIA Hopper.

Same layout and function names as the JAX package (`configs/ core/ nn/
kernels/ serving/ launch/ obs/`); the JAX package stays the reference.
This package imports `torch`, numpy and the stdlib only — never `jax`
and nothing of `repro`.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The port runs on the card: None means CUDA and raises without a
    CUDA device. The CPU (plain versions of the kernels) only on request."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu' to run "
                               "the plain versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
