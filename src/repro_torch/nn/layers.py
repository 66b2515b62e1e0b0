"""Primitive layers over plain dict parameter trees (counterpart of
`repro.nn.layers`): `linear` weights are [d_in, d_out] and apply as
``x @ w``, the JAX package's layout, so parameters convert as they are."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    from repro_torch.nn import sharding as shd
    y = x @ shd.gather_fsdp(p["w"])
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm computed in f32, cast back to the input dtype (a DTensor
    x first takes the residual stream's layout, `sharding.rows_whole`)."""
    from repro_torch.nn import sharding as shd
    x = shd.rows_whole(x)
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


def embed(p: dict, ids: torch.Tensor) -> torch.Tensor:
    from repro_torch.nn import sharding as shd
    if shd.is_dtensor(p["table"]):
        return shd.embed_lookup(p["table"], ids)
    return p["table"][ids]


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied LM head: logits in f32."""
    from repro_torch.nn import sharding as shd
    t = shd.gather_fsdp(p["table"])        # keep vocab sharded, gather d
    return x.float() @ t.float().T


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: silu of the gate in f32, cast back, times the up branch."""
    from repro_torch.nn import sharding as shd
    pg, pu, pd = p["gate"], p["up"], p["down"]
    if shd.opt_enabled("weight_gather"):
        # gather the fsdp-sharded weight at use rather than all-reduce
        # activation-sized partial sums over the fsdp axis
        pg = {**pg, "w": shd.constrain(pg["w"], None, "tp")}
        pu = {**pu, "w": shd.constrain(pu["w"], None, "tp")}
        pd = {**pd, "w": shd.constrain(pd["w"], "tp", None)}
    g = F.silu(linear(pg, x).float()).to(x.dtype)
    return linear(pd, g * linear(pu, x))
