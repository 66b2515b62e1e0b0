"""Numpy -> torch conversion of the JAX package's parameter trees and
caches, so the port can run on exactly the reference's weights.

The caller turns JAX arrays into numpy (``np.asarray``); this module
never imports jax. numpy has no bfloat16: ``np.asarray`` of a bf16 jax
array is an ``ml_dtypes`` array that `torch.from_numpy` rejects, so such
leaves go through float32 (exact) and then to ``torch.bfloat16``.
Layouts need no change — the port keeps the JAX layouts: linear weights
``[d_in, d_out]``, block leaves with a leading ``[n_sb]`` dim, cache
leaves ``[n_sb, nA, B, ...]``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cache import LayerKV


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def params_from_numpy(tree: dict, cfg, device=None) -> dict:
    """A `repro.nn.model.init_params` tree (leaves as numpy) -> the
    port's parameter dict, leaves on `device` in `cfg.dtype`."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return tensor_from_numpy(x, device).to(cfg.dtype)
    return conv(tree)


def layer_kv_from_numpy(lc, device=None) -> LayerKV:
    """Anything with the `LayerKV` fields (a JAX LayerKV, leaves as numpy)
    -> a torch `LayerKV` with the same dtypes and shapes."""
    return LayerKV(*(tensor_from_numpy(getattr(lc, f), device)
                     for f in LayerKV._fields))
