"""Primitive layers over plain dict parameter trees (counterpart of
`repro.nn.layers`): `linear` weights are [d_in, d_out] and apply as
``x @ w``, the JAX package's layout, so parameters convert as they are."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm computed in f32, cast back to the input dtype."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


def embed(p: dict, ids: torch.Tensor) -> torch.Tensor:
    return p["table"][ids]


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied LM head: logits in f32."""
    return x.float() @ p["table"].float().T


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: silu of the gate in f32, cast back, times the up branch."""
    g = F.silu(linear(p["gate"], x).float()).to(x.dtype)
    return linear(p["down"], g * linear(p["up"], x))
