"""KVSharer (survey [10]): layer-wise *dissimilar* KV cache sharing
(counterpart of `repro.core.sharing`).

KVSharer's counter-intuitive observation: sharing the KV cache between
layers whose KV states are most **dissimilar** degrades quality least.
A calibration pass collects per-layer K/V summaries; the sharing map
(layer -> source layer) names the `n_share` layers most amenable to
sharing, and the serving path reuses the source layer's LayerKV (memory
drops by n_share/L).

Sharing crosses layer boundaries, so it runs on the unrolled runner
(`repro_torch.serving.shared_runner`), not in the continuous engine.
The map builder works in numpy float64, as the JAX package's does, so
both packages pick the same pairs from the same summaries.
"""
from __future__ import annotations

import numpy as np
import torch


def layer_kv_similarity(kv_summaries) -> np.ndarray:
    """kv_summaries: [L, F] per-layer flattened KV statistics (e.g. mean K
    over a calibration batch; a tensor or an array). Returns [L, L]
    cosine similarity."""
    if isinstance(kv_summaries, torch.Tensor):
        kv_summaries = kv_summaries.detach().cpu().double().numpy()
    x = np.asarray(kv_summaries, dtype=np.float64)
    n = x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)
    return n @ n.T


def build_sharing_map(kv_summaries, n_share: int) -> dict[int, int]:
    """Greedy KVSharer strategy: pick the `n_share` (target, source) pairs
    with the *lowest* KV similarity; each shared layer reuses its source's
    cache. Sources are never themselves shared, targets are re-used once.
    Returns {target_layer: source_layer}."""
    sim = layer_kv_similarity(kv_summaries)
    L = sim.shape[0]
    pairs = sorted(
        ((sim[i, j], i, j) for i in range(L) for j in range(L) if i > j),
        key=lambda t: t[0],
    )
    mapping: dict[int, int] = {}
    used_target, used_source = set(), set()
    for s, i, j in pairs:
        if len(mapping) >= n_share:
            break
        # deeper layer i reuses shallower j's cache
        if i in used_target or i in used_source or j in used_target:
            continue
        mapping[i] = j
        used_target.add(i)
        used_source.add(j)
    return mapping


def calibration_summaries(ks: torch.Tensor, vs: torch.Tensor) -> torch.Tensor:
    """ks/vs: [L, B, S, H, D] calibration K/V -> [L, F] f32 summaries."""
    L = ks.shape[0]
    mk = ks.float().mean(dim=(1, 2)).reshape(L, -1)
    mv = vs.float().mean(dim=(1, 2)).reshape(L, -1)
    return torch.cat([mk, mv], dim=-1)


def shared_bytes_fraction(mapping: dict[int, int], n_layers: int) -> float:
    """Memory kept after sharing (the KVSharer compression claim)."""
    return 1.0 - len(mapping) / n_layers
