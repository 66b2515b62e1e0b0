"""Deterministic synthetic data pipeline (the port's copy of
`repro.data.synthetic`, numpy only: the same draws from the same seeds).

Two generators:
  * `synthetic_tokens` — a Zipfian-ish Markov token stream with enough
    structure that a ~100M model's loss visibly drops within a few hundred
    steps (the JAX package's examples/train_tiny.py) and perplexity
    deltas between cache policies are meaningful.
  * `needle_prompt` — Needle-in-a-Haystack prompts (the survey's quality
    benchmark for selective compression, Table 1): filler stream + a
    KEY->VALUE fact at a controlled depth + the query at the end; quality
    = does greedy decode retrieve VALUE.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

Array = np.ndarray


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def synthetic_tokens(vocab: int, batch: int, seq: int, *, seed: int = 0,
                     n_states: int = 64) -> Iterator[dict]:
    """Markov-chain LM stream: learnable bigram structure (predictable
    ~60% of the time) over a Zipf marginal. Yields {"tokens": [B, S+1]}."""
    rng = _rng(seed)
    n_states = min(n_states, vocab)
    # sparse transition: each state prefers 4 successors
    prefer = rng.integers(0, n_states, size=(n_states, 4))
    zipf_p = 1.0 / np.arange(1, vocab + 1)
    zipf_p /= zipf_p.sum()
    while True:
        out = np.empty((batch, seq + 1), np.int32)
        state = rng.integers(0, n_states, size=batch)
        for t in range(seq + 1):
            use_markov = rng.random(batch) < 0.6
            nxt_m = prefer[state, rng.integers(0, 4, size=batch)]
            nxt_r = rng.choice(vocab, size=batch, p=zipf_p)
            tok = np.where(use_markov, nxt_m, nxt_r)
            out[:, t] = tok
            state = tok % n_states
        yield {"tokens": out}


def lm_batches(cfg, batch: int, seq: int, *, seed: int = 0) -> Iterator[dict]:
    """Training batches for any assigned arch (adds stub encoder features
    for enc-dec models — the modality-frontend carve-out)."""
    gen = synthetic_tokens(cfg.vocab_size, batch, seq, seed=seed)
    rng = _rng(seed + 1)
    for b in gen:
        if cfg.is_encoder_decoder:
            src_len = max(seq // 4, 16)
            b["src_embeds"] = rng.standard_normal(
                (batch, src_len, cfg.d_model), dtype=np.float32)
        yield b


def needle_prompt(vocab: int, length: int, *, depth: float = 0.5,
                  seed: int = 0, key_span: int = 8) -> tuple[Array, Array, int]:
    """Returns (prompt [length], needle_value_tokens [key_span], marker).

    Layout: [filler ... | MARKER needle_value MARKER | filler ... | MARKER]
    A model with an intact cache continues the final MARKER with
    needle_value; an over-compressed cache loses it. MARKER is a reserved
    rare token; filler avoids it."""
    rng = _rng(seed)
    marker = vocab - 1
    hi = max(vocab - 1000, vocab // 2 + 2)
    filler = rng.integers(0, hi, size=length).astype(np.int32)
    value = rng.integers(vocab // 2, hi, size=key_span).astype(np.int32)
    pos = int(depth * (length - 3 * key_span - 4))
    prompt = filler.copy()
    prompt[pos] = marker
    prompt[pos + 1: pos + 1 + key_span] = value
    prompt[pos + 1 + key_span] = marker
    prompt[-1] = marker                 # query: "MARKER ->" expects value
    return prompt, value, marker
