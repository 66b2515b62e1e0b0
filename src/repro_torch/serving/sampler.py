"""Token samplers for the serving engine (counterpart of
`repro.serving.sampler`). A sampler is ``sample(logits, generator)``:
logits [B, V] f32 -> tokens [B] int32, with `generator` the engine's
`torch.Generator` on the logits' device (greedy ignores it)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import cache as kvcache


def greedy(logits: torch.Tensor,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """argmax over the vocabulary (first index on ties, as jnp.argmax)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def temperature(temp: float, top_k: int = 0):
    """Sampling at temperature `temp` (floored at 1e-4), restricted to the
    `top_k` largest logits when top_k > 0, as Gumbel-max: ``argmax(
    logits / temp + g)`` with g a standard Gumbel draw of the logits'
    shape (`cache.gumbel`, on their device), which is how
    `jax.random.categorical` samples. No host sync, and no
    `torch.multinomial`.

    Top-k masks every logit below the k-th largest to -inf and keeps ties
    at the threshold, as the JAX sampler does; the threshold is the k-th
    value of `torch.topk` (its indices break ties differently from
    `jax.lax.top_k`, its values do not)."""
    def sample(logits: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        lg = logits / max(temp, 1e-4)
        if top_k:
            kth = torch.topk(lg, top_k, dim=-1).values[..., -1:]
            lg = torch.where(lg < kth, float("-inf"), lg)
        g = kvcache.gumbel(lg.shape, generator, lg.device)
        return torch.argmax(lg + g, dim=-1).to(torch.int32)
    return sample
