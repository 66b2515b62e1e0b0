"""Adaptive dynamic cache budgets (counterpart of `repro.serving.adaptive`)
— the survey's §7.2 future direction, implemented at the scheduler level
(one cache shape per bucket; the "dynamism" is bucket choice).

Signal: prompts whose token distribution is low-entropy (repetitive,
template-heavy) compress harder — heavy hitters dominate and a small
budget retains quality; high-entropy prompts spread attention and need
larger budgets. `choose_budget` maps normalized unigram entropy onto the
configured bucket ladder; `AdaptiveEngine` keeps one engine per bucket
and routes request waves by signal.

`PressureController` is the *runtime* half of the same future-work line:
instead of choosing a budget once at admission, it watches the paged
`BlockAllocator` free list during a continuous run and, above a
high-water mark, asks the engine to evict resident quantized/window
slots down to a tighter effective budget (dropping their oldest flushed
groups — quality-reversible: the slots regrow one group per window of
appends once pressure clears). With KV tiering enabled the same
controller (a second instance, watching tier headroom too) drives the
*spill* rung ahead of it, so the full overload ladder is: spill cold
blocks to host RAM (lossless — bytes come back bit-identical), degrade
resident budgets reversibly, preempt (to host when the tier has room —
restore instead of recompute — else recompute-on-resume), and only then
fail.

`prompt_entropy` and `choose_budget` are numpy only; this module keeps
its own copy of them (the port imports nothing of the JAX package).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from repro_torch.core.policy import presets
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serving.engine import Engine, GenerationResult


class PressureController:
    """Watermark policy for pressure-driven budget degradation.

    The engine calls `shortfall(allocator)` once per decode loop
    iteration: 0 means no action; a positive value is the number of pool
    blocks the engine should try to free by degrading resident
    quantized-ring slots (dropping their oldest non-sink groups via
    `core.paging.degrade_slot_groups`).

    Hysteresis: pressure engages when the allocated fraction crosses
    `high_water` and keeps asking for blocks down to `low_water`, so the
    controller does not flap at the boundary; it disengages once usage
    falls to `low_water` (slots then regrow naturally — "relaxing the
    mark when the pool drains"). `keep_groups` floors how far any one
    slot may be degraded (the sink group plus at least one recent
    group always survive)."""

    def __init__(self, *, high_water: float = 0.85, low_water: float = 0.60,
                 keep_groups: int = 2, tracer=None):
        if not 0.0 < low_water <= high_water <= 1.0:
            raise ValueError(
                f"need 0 < low_water <= high_water <= 1, got "
                f"{low_water}/{high_water}")
        if keep_groups < 2:
            raise ValueError(f"keep_groups must be >= 2 (sinks + one "
                             f"recent group), got {keep_groups}")
        self.high_water = float(high_water)
        self.low_water = float(low_water)
        self.keep_groups = int(keep_groups)
        self._pressed = False
        self.trace = tracer if tracer is not None else NULL_TRACER
        self.stats = dict(degrades=0, blocks_dropped=0, ticks_pressed=0,
                          peak_used_frac=0.0, spills=0, blocks_spilled=0)

    @property
    def pressed(self) -> bool:
        return self._pressed

    def shortfall(self, allocator) -> int:
        """Blocks the engine should free to return to `low_water` usage;
        0 when the pool is below the engaged watermark."""
        used_frac = allocator.used / max(allocator.n_blocks, 1)
        self.stats["peak_used_frac"] = max(self.stats["peak_used_frac"],
                                           used_frac)
        if self._pressed:
            if used_frac <= self.low_water:
                self._pressed = False
                return 0
        elif used_frac < self.high_water:
            return 0
        else:
            self._pressed = True
        self.stats["ticks_pressed"] += 1
        target_used = int(self.low_water * allocator.n_blocks)
        return max(allocator.used - target_used, 0)

    def note_degrade(self, n_blocks: int) -> None:
        self.stats["degrades"] += 1
        self.stats["blocks_dropped"] += n_blocks
        if self.trace:
            self.trace.instant("degrade", args=dict(blocks=n_blocks))

    def note_spill(self, n_blocks: int) -> None:
        """The spill rung freed `n_blocks` by demotion (not loss)."""
        self.stats["spills"] += 1
        self.stats["blocks_spilled"] += n_blocks
        if self.trace:
            self.trace.instant("spill_rung", args=dict(blocks=n_blocks))


def prompt_entropy(tokens: np.ndarray, vocab: int) -> float:
    """Normalized unigram entropy in [0, 1]. tokens: [S]."""
    _, counts = np.unique(tokens, return_counts=True)
    p = counts / counts.sum()
    h = -(p * np.log(p)).sum()
    hmax = np.log(min(len(tokens), vocab))
    return float(h / max(hmax, 1e-9))


def choose_budget(tokens: np.ndarray, vocab: int,
                  buckets: Sequence[int], lo: float = 0.55,
                  hi: float = 0.85) -> int:
    """Map entropy onto the bucket ladder: <=lo -> smallest,
    >=hi -> largest, linear in between."""
    e = prompt_entropy(tokens, vocab)
    t = min(max((e - lo) / max(hi - lo, 1e-9), 0.0), 1.0)
    idx = min(int(t * len(buckets)), len(buckets) - 1)
    return int(buckets[idx])


@dataclass
class AdaptiveResult:
    per_bucket: dict
    budgets_chosen: list


class AdaptiveEngine:
    """Routes each request wave to a per-bucket Engine. `device` and
    `use_kernels` pass through to every engine (None: the card)."""

    def __init__(self, cfg, params, *, buckets: Sequence[int],
                 policy_name: str = "h2o", window: int = 16,
                 prompt_len: int = 256, max_new: int = 16, slots: int = 4,
                 device=None, use_kernels=None):
        self.cfg = cfg
        self.buckets = sorted(buckets)
        self.engines = {
            b: Engine(cfg, params,
                      presets(budget=b, window=window)[policy_name],
                      prompt_len=prompt_len, max_new=max_new, slots=slots,
                      device=device, use_kernels=use_kernels)
            for b in self.buckets
        }

    def generate(self, prompts: np.ndarray) -> AdaptiveResult:
        chosen = [choose_budget(p, self.cfg.vocab_size, self.buckets)
                  for p in prompts]
        out: dict[int, GenerationResult] = {}
        for b in self.buckets:
            idx = [i for i, c in enumerate(chosen) if c == b]
            if idx:
                out[b] = self.engines[b].generate(prompts[idx])
        return AdaptiveResult(per_bucket=out, budgets_chosen=chosen)
