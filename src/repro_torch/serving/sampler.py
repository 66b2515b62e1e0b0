"""Token samplers for the serving engine (counterpart of
`repro.serving.sampler`; greedy only so far)."""
from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """argmax over the vocabulary (first index on ties, as jnp.argmax)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
