"""The yardstick: peaks, the least time work can take, and the operations
and bytes of the work a cell's requests need, worked out from the
configuration and the requests' lengths alone (never from the program).

Published peaks of one NVIDIA H100 SXM (dense, no sparsity): 989 TFLOP/s
in bf16, 3.35 TB/s of HBM.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, List, Sequence, Tuple

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """Least time: the larger of operations over peak and bytes over
    bandwidth."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


@dataclass(frozen=True)
class Shape:
    """What the counts need of a cell: the model's widths and the cache
    policy (``bits`` 16 and ``budget`` 0: the uncompressed cache)."""
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    budget: int = 0
    window: int = 0
    bits: int = 16

    @classmethod
    def of(cls, config: dict, workload: dict) -> "Shape":
        c = workload["cache"]
        return cls(layers=config["num_hidden_layers"],
                   d_model=config["hidden_size"],
                   heads=config["num_attention_heads"],
                   kv_heads=config["num_key_value_heads"],
                   head_dim=config["head_dim"],
                   d_ff=config["intermediate_size"],
                   vocab=config["vocab_size"],
                   budget=c.get("budget", 0), window=c.get("window", 0),
                   bits=c.get("bits", 16))

    # ---- the cache ---------------------------------------------------
    def decode_rows(self, prompt_len: int, k: int) -> Tuple[int, int]:
        """(main-store rows, exact rows) one layer attends to in the decode
        step that emits token `k` (k >= 1; that step appends token k-1 at
        position prompt_len + k - 1)."""
        if self.bits >= 16:
            return 0, prompt_len + k
        W = G = self.window
        n_main = min(self.budget, prompt_len - W)
        flushes = (k - 1) // W + 1
        main = min(n_main + G * flushes, self.budget)
        return main, (k - 1) % W + 1

    # ---- attention kernels ---------------------------------------------
    def decode_attn(self, prompt_len: int, k: int) -> Tuple[float, float]:
        """(FLOPs, bytes) of one layer's decode attention for one request:
        q and the output once, each row it attends to once at its stored
        precision (2-bit codes with their scales, the exact ring in bf16)."""
        main, exact = self.decode_rows(prompt_len, k)
        H, Hk, D = self.heads, self.kv_heads, self.head_dim
        flops = 4.0 * H * D * (main + exact)
        nbytes = 2 * H * D * 2 + exact * 2 * Hk * D * 2
        if main:
            codes = 2 * Hk * D * self.bits / 8
            k_scales = 2 * Hk * D * 4 / self.window  # a group's min, scale
            v_scales = 2 * Hk * 4
            nbytes += main * (codes + k_scales + v_scales)
        return flops, nbytes

    def prefill_attn(self, prompt_len: int) -> Tuple[float, float]:
        """(FLOPs, bytes) of one layer's causal prefill attention: q, k, v
        and the output once."""
        T, H, Hk, D = prompt_len, self.heads, self.kv_heads, self.head_dim
        return (4.0 * H * D * T * (T + 1) / 2,
                (2 * H + 2 * Hk) * T * D * 2.0)

    # ---- the whole model -----------------------------------------------
    @property
    def matmul_params(self) -> int:
        d, H, Hk, D = self.d_model, self.heads, self.kv_heads, self.head_dim
        return self.layers * (d * (H + 2 * Hk) * D + H * D * d
                              + 3 * d * self.d_ff)

    def prefill_flops(self, prompt_len: int) -> float:
        """Model FLOPs of one admission: every prompt token through every
        matmul and causal attention, the head on the last row."""
        attn = self.prefill_attn(prompt_len)[0] * self.layers
        return (2.0 * self.matmul_params * prompt_len + attn
                + 2.0 * self.d_model * self.vocab)

    def decode_flops(self, prompt_len: int, k: int) -> float:
        """Model FLOPs of the decode step's work for token `k` of one
        request: the matmuls, the head and attention over what it sees."""
        return (2.0 * (self.matmul_params + self.d_model * self.vocab)
                + self.decode_attn(prompt_len, k)[0] * self.layers)

    def request_flops(self, prompt_len: int, n_tokens: int) -> float:
        return self.prefill_flops(prompt_len) + sum(
            self.decode_flops(prompt_len, k) for k in range(1, n_tokens))


def decode_bound_s(shape: Shape, items: Iterable[Tuple[int, int]]) -> float:
    """Least time of the decode attention calls that emitted `items`
    ((step, prompt length, token index) triples): one call a layer and a
    step, each bounded on its own."""
    by_step = {}
    for step, p, k in items:
        f, b = shape.decode_attn(p, k)
        acc = by_step.setdefault(step, [0.0, 0.0])
        acc[0] += f
        acc[1] += b
    return shape.layers * sum(bound_s(f, b) for f, b in by_step.values())


def prefill_bound_s(shape: Shape, prompt_lens: Sequence[int]) -> float:
    return shape.layers * sum(bound_s(*shape.prefill_attn(p))
                              for p in prompt_lens)


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (the smallest value with at least q of the
    samples at or below it); inf counts as a sample."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no samples")
    return xs[max(0, math.ceil(q * len(xs)) - 1)]


def union_seconds(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total
