"""What decides `correct`: the served tokens against the plain reference.

Once the window has closed, a sample drawn from the seed of the requests
the window finished (its longest request always among them) is run through
`bench.reference.decoder` over each prompt and its served tokens. At each
row, the gap is how far the served token's reference logit lies below the
reference's best (greedy traffic: the program should serve the
reference's argmax up to its rounding). A cell compares the numbers its
``check.limits`` names: ``max_logit_gap``, the widest gap, and
``mean_logit_gap``, their mean over the sample's rows (steady from seed
to seed where the widest swings; see PERF.md for which and why). Besides,
every request has to be served whole: a failed or cut-short request is an
answer that never came.

The control (`control_gaps`) puts the reference computed in float8 in the
program's place: at each row it takes the token the fp8 reference ranks
first and reads that token's gap under the f32 reference.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

from bench.reference import decoder

from . import weights


def cache_policy(cell: dict) -> decoder.CachePolicy:
    c = cell["cache"]
    return decoder.CachePolicy(budget=c.get("budget", 0),
                               window=c.get("window", 0),
                               sinks=c.get("sinks", 4),
                               bits=c.get("bits", 16))


def served(batches) -> Tuple[list, int]:
    """(request, result) pairs served whole, and the count of those that
    failed or came short."""
    whole, missing = [], 0
    for b in batches:
        res = {r.uid: r for r in b.result.results}
        for q in b.requests:
            r = res.get(q.uid)
            if r is None or r.finish_reason == "failed" \
                    or r.n_tokens != q.max_new:
                missing += 1
            else:
                whole.append((q, r))
    return whole, missing


def sample(pairs: list, n: int, seed: int) -> list:
    """The longest served request and n - 1 more, drawn from the seed."""
    if not pairs:
        return []
    order = sorted(range(len(pairs)), key=lambda i: -(
        len(pairs[i][0].tokens) + pairs[i][1].n_tokens))
    rest = order[1:]
    rng = np.random.default_rng([int(seed) & (2 ** 63 - 1), 7])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [pairs[order[0]]] + [pairs[rest[i]] for i in sorted(pick)]


def reference_logits(cell, config, params, picked, precision="f32"):
    arch = decoder.Arch.from_config(config)
    seqs = [np.concatenate([q.tokens, r.tokens[:-1]]).tolist()
            for q, r in picked]
    plens = [len(q.tokens) for q, _ in picked]
    return decoder.logits_of(arch, weights.reference_view(params,
                                                          arch.layers),
                             seqs, plens, cache_policy(cell),
                             precision=precision)


def gap_numbers(ref: List[torch.Tensor], tokens: List[list]) -> dict:
    """The widest and the mean gap of `tokens` (one list a sequence)
    under the reference's logits."""
    g = torch.cat([decoder.row_gaps(l, t) for l, t in zip(ref, tokens)])
    return {"max_logit_gap": float(g.max()), "mean_logit_gap":
            float(g.double().mean())}


def control_gaps(ref: List[torch.Tensor], low: List[torch.Tensor]) -> dict:
    """The gap numbers, under the f32 reference, of the tokens the lower
    precision ranks first."""
    return gap_numbers(ref, [b.argmax(dim=-1).tolist() for b in low])


def check(cell: dict, config: dict, params: dict, batches, seed: int, *,
          log: Callable = print) -> dict:
    whole, missing = served(batches)
    picked = sample(whole, int(cell["check"]["requests"]), seed)
    nums = {"max_logit_gap": float("inf"), "mean_logit_gap": float("inf")}
    if picked:
        ref = reference_logits(cell, config, params, picked)
        nums = gap_numbers(ref, [r.tokens.tolist() for _, r in picked])
        log(f"check: {len(picked)} requests, "
            f"{sum(r.n_tokens for _, r in picked)} served tokens, "
            f"prompts {[len(q.tokens) for q, _ in picked]}; "
            + ", ".join(f"{k} {v!r}" for k, v in nums.items()))
    compared = {k: {"value": nums[k], "limit": float(lim)}
                for k, lim in cell["check"]["limits"].items()}
    compared["unserved_requests"] = {"value": missing, "limit": 0}
    ok = all(c["value"] <= c["limit"] for c in compared.values())
    return {"correct": bool(ok), "compared": compared}
