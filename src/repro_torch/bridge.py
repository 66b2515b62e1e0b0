"""Numpy -> torch conversion of the JAX package's parameter trees and
caches, so the port can run on exactly the reference's weights.

The caller turns JAX arrays into numpy (``np.asarray``); this module
never imports jax. numpy has no bfloat16: ``np.asarray`` of a bf16 jax
array is an ``ml_dtypes`` array that `torch.from_numpy` rejects, so such
leaves go through float32 (exact) and then to ``torch.bfloat16``.
Layouts need no change — the port keeps the JAX layouts: linear weights
``[d_in, d_out]``, block leaves with a leading ``[n_sb]`` dim, cache
leaves ``[n_sb, nA, B, ...]`` — except that the port's paged pools carry
one drop block past the JAX pools' blocks (`core.paging`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import paging
from repro_torch.core.cache import LayerKV, SSMState


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def params_from_numpy(tree: dict, cfg, device=None) -> dict:
    """A `repro.nn.model.init_params` tree (leaves as numpy) -> the
    port's parameter dict, leaves on `device`. Each leaf keeps its JAX
    dtype class: an f32 leaf stays f32 (the MoE router, which JAX keeps
    in f32 in a bf16 model), the model-dtype leaves take `cfg.dtype`."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        t = tensor_from_numpy(x, device)
        return t if t.dtype == torch.float32 else t.to(cfg.dtype)
    return conv(tree)


def layer_kv_from_numpy(lc, device=None) -> LayerKV:
    """Anything with the `LayerKV` fields (a JAX LayerKV, leaves as numpy)
    -> a torch `LayerKV` with the same dtypes and shapes."""
    return LayerKV(*(tensor_from_numpy(getattr(lc, f), device)
                     for f in LayerKV._fields))


def paged_kv_from_numpy(p, device=None) -> paging.PagedLayerKV:
    """A JAX `PagedLayerKV` (leaves as numpy) -> the port's, with a zero
    drop block appended to every pool (the block axis is 4th from the
    end for the code / K-scale pools, 3rd for the V-scale pools)."""
    out = {}
    for f in paging.PagedLayerKV._fields:
        t = tensor_from_numpy(getattr(p, f), device)
        if f in paging.POOL_FIELDS:
            axis = t.dim() - (3 if f.startswith("pv_") else 4)
            shape = list(t.shape)
            shape[axis] = 1
            t = torch.cat([t, t.new_zeros(shape)], dim=axis)
        out[f] = t
    return paging.PagedLayerKV(**out)


def ssm_state_from_numpy(st, device=None) -> SSMState:
    """A JAX `SSMState` (leaves as numpy) -> the port's, same dtypes."""
    return SSMState(*(tensor_from_numpy(getattr(st, f), device)
                      for f in SSMState._fields))


def model_cache_from_numpy(c, device=None):
    """A JAX `ModelCache` (leaves as numpy) -> the port's: its attention
    part dense or paged, its SSM part, and an encoder-decoder's cross
    memory."""
    from repro_torch.nn.model import ModelCache
    attn = None
    if c.attn is not None:
        attn = (layer_kv_from_numpy(c.attn, device)
                if hasattr(c.attn, "k") else paged_kv_from_numpy(c.attn,
                                                                  device))
    ssm = None if c.ssm is None else ssm_state_from_numpy(c.ssm, device)
    cross = [None if getattr(c, f) is None
             else tensor_from_numpy(getattr(c, f), device)
             for f in ("cross_k", "cross_v", "cross_bias")]
    return ModelCache(attn, ssm, *cross)


def train_state_from_numpy(st, cfg, device=None):
    """A JAX `TrainState` (leaves as numpy) -> the port's: params as
    `params_from_numpy`, the `AdamState` moments in f32 and the step
    counts as int32 0-dim tensors."""
    from repro_torch.optim.optimizers import AdamState, tree_map
    from repro_torch.train.loop import TrainState

    def f32(tree):
        return tree_map(lambda v: tensor_from_numpy(v, device).float(), tree)

    def step(x):
        return tensor_from_numpy(np.asarray(x, np.int32), device)

    opt = AdamState(step(st.opt.step), f32(st.opt.mu), f32(st.opt.nu))
    return TrainState(params_from_numpy(st.params, cfg, device), opt,
                      step(st.step))
