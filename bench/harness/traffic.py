"""The one traffic generator: offline batches of requests.

A traffic file fixes the batch: ``batch_requests`` requests whose prompt
lengths are drawn over ``prompt_buckets`` in the proportions
``prompt_weights`` (largest remainders, so the counts are exact) and whose
output lengths are the batch's stratified quantiles of ``output``:

* ``{"dist": "lognormal", "median": m, "sigma": s, "min": a, "max": b}``;
* ``{"dist": "uniform", "min": a, "max": b}``.

The pairs (prompt length, output length) and their order within batch
``i`` are the same for every seed (a fixed shuffle of the batch's index):
the seed draws only the prompt tokens. The order sets how long a batch's
last requests keep the slots busy, so a seed that reordered the batch
would change the work; with it fixed, every seed does the same work and
the batches of one run differ from each other. ``eos_id`` null: each
request emits exactly its output length.

An optional ``shared_prefix`` ``{"lengths": [l0, l1, ...]}`` makes sessions
that share system prompts: the run draws one prefix of each length from
the seed (the same in every batch), and request ``j`` of a batch starts
with prefix ``j mod k`` (cut to its prompt, where longer); the rest of its
prompt is its own. A new traffic shape is a data file for this generator:
a mix that needs code of its own could not be claimed on by a later PR
that adds only files.
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import List, Tuple

import numpy as np


def _apportion(n: int, weights) -> List[int]:
    w = np.asarray(weights, dtype=np.float64)
    share = n * w / w.sum()
    counts = np.floor(share).astype(int)
    order = np.argsort(-(share - counts), kind="stable")
    counts[order[:n - counts.sum()]] += 1
    return counts.tolist()


def _output_lengths(n: int, out: dict) -> List[int]:
    lo, hi = int(out["min"]), int(out["max"])
    qs = [(i + 0.5) / n for i in range(n)]
    if out["dist"] == "lognormal":
        mu, sd = math.log(out["median"]), float(out["sigma"])
        vals = [math.exp(mu + sd * NormalDist().inv_cdf(q)) for q in qs]
    elif out["dist"] == "uniform":
        vals = [lo + q * (hi - lo + 1) - 0.5 for q in qs]
    else:
        raise ValueError(f"unknown output distribution {out['dist']!r}")
    return [int(min(max(round(v), lo), hi)) for v in vals]


def pairs(traffic: dict) -> List[Tuple[int, int]]:
    """The batch's (prompt length, output length) pairs, seed-free."""
    n = int(traffic["batch_requests"])
    lens = []
    for b, c in zip(traffic["prompt_buckets"],
                    _apportion(n, traffic["prompt_weights"])):
        lens += [int(b)] * c
    outs = _output_lengths(n, traffic["output"])
    # a fixed pairing: output lengths dealt over the prompts by a draw
    # that does not depend on the run's seed
    perm = np.random.default_rng(0).permutation(n)
    return [(lens[i], outs[j]) for i, j in enumerate(perm)]


def batch(traffic: dict, seed: int, index: int,
          vocab: int) -> List[Tuple[np.ndarray, int]]:
    """Batch `index` of a run with `seed`: (prompt tokens int32, max_new)
    per request, in submission order."""
    ps = pairs(traffic)
    order = np.random.default_rng([1, int(index)]).permutation(len(ps))
    s = int(seed) & (2 ** 63 - 1)
    rng = np.random.default_rng([s, int(index)])
    out = [(rng.integers(0, vocab, size=ps[i][0]).astype(np.int32),
            ps[i][1]) for i in order]
    shared = traffic.get("shared_prefix")
    if shared:
        pre = np.random.default_rng([s, 1 << 32])
        heads = [pre.integers(0, vocab, size=int(n)).astype(np.int32)
                 for n in shared["lengths"]]
        for j, (toks, _) in enumerate(out):
            h = heads[j % len(heads)][:len(toks)]
            toks[:len(h)] = h
    return out


def max_output(traffic: dict) -> int:
    return max(o for _, o in pairs(traffic))
