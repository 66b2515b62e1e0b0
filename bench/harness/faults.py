"""Faults planted under the timed path, to see the check come out not
correct: in the CPU tests at a tiny size, and on the card at a cell's own
size (`bench/readings.py --faults`).

* ``altered_token``: every row of every tenth sampling emits the next
  token id (a token altered where it is produced);
* ``state_unchanged``: a decode step advances each row's position but
  writes nothing into the cache (a step that returns its state unchanged);
* ``half_batch``: a decode step's second half of rows gets the first
  half's logits (half of the batch left out, the rest served twice).

`patch(name)` gives ``(module, attribute, replacement)``; `planted(name)`
sets it for the span of a ``with`` and restores the original.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import torch

NAMES = ("altered_token", "state_unchanged", "half_batch")


def _altered_token():
    from repro_torch.serving import sampler
    real = sampler.greedy
    calls = [0]

    def greedy(logits, generator=None):
        calls[0] += 1
        tok = real(logits, generator)
        if calls[0] % 10 == 0:
            tok = (tok + 1) % logits.shape[-1]
        return tok
    return sampler, "greedy", greedy


def _state_unchanged():
    from repro_torch.core import cache

    def append_token(lc, spec, k_new, v_new, **kw):
        lc.pos.add_(1)
        return lc
    return cache, "append_token", append_token


def _half_batch():
    from repro_torch.nn import model as M
    real = M.decode_step

    def decode_step(*a, **kw):
        logits, cache = real(*a, **kw)
        h = logits.shape[0] // 2 or 1
        return torch.cat([logits[:h], logits[:logits.shape[0] - h]]), cache
    return M, "decode_step", decode_step


def patch(name: str) -> Tuple[object, str, object]:
    return {"altered_token": _altered_token,
            "state_unchanged": _state_unchanged,
            "half_batch": _half_batch}[name]()


@contextlib.contextmanager
def planted(name: str):
    """The fault `name` in place for the block (the sampler's before the
    engine is built: the engine holds its sampler)."""
    mod, attr, new = patch(name)
    old = getattr(mod, attr)
    setattr(mod, attr, new)
    try:
        yield
    finally:
        setattr(mod, attr, old)
