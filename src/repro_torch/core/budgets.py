"""(Counterpart of `repro.core.budgets`: the numpy allocators; the jax
signal functions that feed squeeze / zigzag are not ported yet.)

Layer-wise KV budget allocation (the survey's "attention compression"
family, §4): the global cache budget is split unevenly across layers.

Allocators return integer per-layer budgets summing to ~n_layers*budget,
rounded to `multiple` (the quantization group, so group flushes stay
aligned). Signals:

  * PyramidInfer [25] — deeper layers keep less (context redundancy
    grows with depth): geometric decay.
  * SqueezeAttention [24] — layers whose block output is cosine-similar
    to its input do "less work" and get smaller budgets.
  * ZigZagKV [6] — budget proportional to a layer *uncertainty* signal
    (how spread the layer's attention mass is: flatter -> needs more).
"""
from __future__ import annotations

import numpy as np


def _round_to(x: np.ndarray, multiple: int, lo: int, hi: int) -> np.ndarray:
    x = np.clip(np.round(x / multiple) * multiple, lo, hi)
    return x.astype(np.int32)


def uniform(n_layers: int, budget: int, *, multiple: int = 1, **_) -> np.ndarray:
    return _round_to(np.full(n_layers, budget, float), multiple,
                     multiple, budget * n_layers)


def pyramid(n_layers: int, budget: int, *, decay: float = 0.85,
            min_frac: float = 0.2, multiple: int = 1, **_) -> np.ndarray:
    """PyramidInfer: geometric decay with depth, renormalized to the global
    budget n_layers * budget."""
    w = decay ** np.arange(n_layers)
    w = np.maximum(w, min_frac)
    w = w / w.sum() * n_layers
    return _round_to(w * budget, multiple, multiple, budget * n_layers)


def squeeze(n_layers: int, budget: int, *, cos_sim: np.ndarray,
            low_frac: float = 0.6, multiple: int = 1, **_) -> np.ndarray:
    """SqueezeAttention: 2-means over per-layer cosine similarity between
    block input and output; the high-similarity cluster gets
    ``low_frac * budget``, freed budget goes to the rest."""
    cs = np.asarray(cos_sim, float)
    assert cs.shape == (n_layers,)
    thresh = np.median(cs)
    lazy = cs >= thresh
    w = np.where(lazy, low_frac, 1.0)
    w = w / w.sum() * n_layers
    return _round_to(w * budget, multiple, multiple, budget * n_layers)


def zigzag(n_layers: int, budget: int, *, uncertainty: np.ndarray,
           floor_frac: float = 0.3, multiple: int = 1, **_) -> np.ndarray:
    """ZigZagKV: per-layer budget proportional to attention uncertainty
    (e.g. normalized entropy of the layer's attention mass), with a floor
    so no layer collapses."""
    u = np.asarray(uncertainty, float)
    assert u.shape == (n_layers,)
    u = u / max(u.sum(), 1e-9) * n_layers
    w = floor_frac + (1 - floor_frac) * u
    w = w / w.sum() * n_layers
    return _round_to(w * budget, multiple, multiple, budget * n_layers)


ALLOCATORS = {
    "uniform": uniform,
    "pyramid": pyramid,
    "squeeze": squeeze,
    "zigzag": zigzag,
}
