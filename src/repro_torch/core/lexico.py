"""Lexico [5] and PQCache [31] — reference implementations, math only
(counterpart of `repro.core.lexico`).

Lexico: each KV vector ≈ sparse combination of a universal dictionary
(matching pursuit, s atoms per vector). Storage per vector: s × (idx +
coeff) vs D floats.

PQCache: split D into m sub-spaces, k-means codebook per sub-space;
storage per vector: m bytes (+ codebooks, amortized).

The dictionary's atoms and k-means' initial centroids are random; they
come from `quantization.normal` and `choice`, where the JAX functions
draw from ``key``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import quantization as qz


def choice(n: int, k: int, generator: Optional[torch.Generator],
           device) -> torch.Tensor:
    """`k` distinct indices of range(n), as `jax.random.choice(...,
    replace=False)` draws them (k-means' initial centroids)."""
    return torch.randperm(n, generator=generator, device=device)[:k]


# ---------------------------------------------------------------------------
# Lexico: matching pursuit over a fixed dictionary
# ---------------------------------------------------------------------------


class LexicoCode(NamedTuple):
    idx: torch.Tensor      # [..., s] int32 atom indices
    coef: torch.Tensor     # [..., s] f32 coefficients


def make_dictionary(n_atoms: int, d: int, *,
                    generator: Optional[torch.Generator] = None,
                    device=None) -> torch.Tensor:
    """Universal dictionary: unit-norm random atoms [n_atoms, d]."""
    D = qz.normal((n_atoms, d), generator, device)
    return D / torch.linalg.norm(D, dim=-1, keepdim=True)


def lexico_encode(x: torch.Tensor, dictionary: torch.Tensor,
                  sparsity: int) -> LexicoCode:
    """Matching pursuit: greedily pick `sparsity` atoms. x: [..., d]."""
    resid = x.float()
    idxs, coefs = [], []
    for _ in range(sparsity):
        scores = resid @ dictionary.T                    # [..., n_atoms]
        best = torch.argmax(scores.abs(), dim=-1)        # [...]
        coef = torch.gather(scores, -1, best[..., None])[..., 0]
        resid = resid - coef[..., None] * dictionary[best]
        idxs.append(best)
        coefs.append(coef)
    return LexicoCode(torch.stack(idxs, -1).to(torch.int32),
                      torch.stack(coefs, -1))


def lexico_decode(code: LexicoCode, dictionary: torch.Tensor) -> torch.Tensor:
    atoms = dictionary[code.idx.long()]                  # [..., s, d]
    return torch.sum(atoms * code.coef[..., None], dim=-2)


def lexico_bytes_per_vector(sparsity: int, coef_bits: int = 16,
                            idx_bits: int = 16) -> float:
    return sparsity * (coef_bits + idx_bits) / 8.0


# ---------------------------------------------------------------------------
# PQCache: product quantization (+ exact MIPS against centroids)
# ---------------------------------------------------------------------------


class PQCodebook(NamedTuple):
    centroids: torch.Tensor    # [m, k, d/m]


def _subspaces(x: torch.Tensor, m: int) -> torch.Tensor:
    n, d = x.shape
    return x.reshape(n, m, d // m).transpose(0, 1)       # [m, n, d/m]


def pq_train(x: torch.Tensor, m: int, k: int, iters: int = 8, *,
             generator: Optional[torch.Generator] = None) -> PQCodebook:
    """k-means per sub-space. x: [n, d]."""
    sub = _subspaces(x, m)
    cent = sub[:, choice(x.shape[0], k, generator, x.device)]   # [m, k, d/m]
    for _ in range(iters):
        d2 = torch.sum((sub[:, :, None] - cent[:, None]) ** 2, -1)  # [m,n,k]
        one = F.one_hot(torch.argmin(d2, -1), k).float()            # [m,n,k]
        counts = one.sum(1)[..., None]                              # [m,k,1]
        sums = torch.einsum("mnk,mnd->mkd", one, sub)
        cent = torch.where(counts > 0, sums / torch.clamp(counts, min=1),
                           cent)
    return PQCodebook(cent)


def pq_encode(cb: PQCodebook, x: torch.Tensor) -> torch.Tensor:
    """x: [n, d] -> codes [n, m] uint8."""
    sub = _subspaces(x, cb.centroids.shape[0])
    d2 = torch.sum((sub[:, :, None] - cb.centroids[:, None]) ** 2, -1)
    return torch.argmin(d2, -1).T.to(torch.uint8)        # [n, m]


def _lookup(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """table [m, k, ...] at codes [n, m] -> [n, m, ...]."""
    m = table.shape[0]
    return table[torch.arange(m, device=codes.device)[None, :], codes.long()]


def pq_decode(cb: PQCodebook, codes: torch.Tensor) -> torch.Tensor:
    m, k, dsub = cb.centroids.shape
    return _lookup(cb.centroids, codes).reshape(codes.shape[0], m * dsub)


def pq_mips_scores(cb: PQCodebook, codes: torch.Tensor,
                   q: torch.Tensor) -> torch.Tensor:
    """Asymmetric distance computation: q: [d]; inner-product scores vs
    all encoded vectors via per-subspace lookup tables (PQCache's MIPS
    primitive). codes: [n, m] -> [n]."""
    m, k, dsub = cb.centroids.shape
    lut = torch.einsum("md,mkd->mk", q.reshape(m, dsub).float(),
                       cb.centroids)
    return torch.sum(_lookup(lut, codes), dim=-1)
