"""One CUDA graph per decode step: the engine's decode dispatch (the
model's `decode_step` over every layer, the logits and the sample)
captured once per cache and flush variant, then replayed, instead of
launching its thousands of ops from Python every step.

**The rule** (`blocker`, then `StepGraphs.ready` per step). A step is
graphed when the engine has a capture backend (the card: `CudaGraphs`;
none on the CPU), no cache tensor is a DTensor, the model is attention
only with dense FFNs (no SSM mixer, no MoE, no cross-attention memory)
and runs the hand-written kernels (`cfg.use_kernels`; the plain
reference path stays eager), the policy draws no noise
(`cache.draws_noise`), the sampler is greedy (draws nothing), and the
step's ``ring_full`` is a host bool with no ``append_mask`` (the
speculative loop's steps pass one and stay eager). Every other step
runs the eager path; the captured function is the eager step itself.

**Variants and captures.** A cache's graphs are keyed by ``ring_full``
(a quantized ring's flush and no-flush steps; one graph for an
unquantized store) and share one private memory pool. A capture records
launches without running them, so both variants are captured back to
back at the first step that needs one, on live cache state, before any
step replays. Capture needs every shape of the step run eagerly once in
the process first (cuBLAS's first call, the kernels' first load, the
split-KV scratch sized: `kernels.build.DeviceScratch`): until then a
variant's step runs eagerly and marks its shapes warm.

**Buffers.** The step reads its tokens from a static input, copied in on
the stream before each replay, and writes them to a static output,
copied out on the stream after it: the caller's token tensors never
alias the graph's. A graph holds the addresses of the cache's tensors,
so it is recaptured when any changes (the engine's in-place cache
surgery keeps them). Replays go on the current stream, as the eager
launches do (the split-KV kernels' scratch assumes one stream).

**Launch counters.** The kernels' Python counters (`CudaKernel`,
`LaunchCount`) move when a launch is recorded, not when it runs: a
capture's increments are taken back and added again at each replay, so
the counts are those of the eager path.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import cache as kvcache
from repro_torch.kernels import build as kbuild
from repro_torch.nn import model as M
from repro_torch.nn import sharding as shd
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import sampler as sampler_lib

# (step signature, ring_full) pairs this process has run eagerly
_WARM: set = set()


class CudaGraphs:
    """The capture backend on the card: `capture(fn, pool)` records
    `fn`'s launches into a `torch.cuda.CUDAGraph` (sharing `pool`, a
    previous graph's, when given) and returns (replay, the graph's pool)."""

    def capture(self, fn: Callable[[], None], pool):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, pool=pool,
                              capture_error_mode="thread_local"):
            fn()
        return g.replay, g.pool()


def cache_leaves(cache: M.ModelCache) -> list:
    """Every tensor of a model cache."""
    out = []
    for part in cache:
        if isinstance(part, torch.Tensor):
            out.append(part)
        elif part is not None:
            out.extend(t for t in part if isinstance(t, torch.Tensor))
    return out


def blocker(cfg, spec, cache: M.ModelCache, sampler,
            generator) -> Optional[str]:
    """Why no decode step of `cache` can be one graph, or None when its
    steps can (the per-step conditions are `StepGraphs.ready`'s)."""
    if cache.attn is None or M.ssm_positions(cfg):
        return "SSM mixer"
    if cfg.is_moe:
        return "mixture of experts"
    if cfg.is_encoder_decoder or cache.cross_k is not None:
        return "cross-attention memory"
    if not cfg.use_kernels:
        return "plain path"
    if any(shd.is_dtensor(t) for t in cache_leaves(cache)):
        return "sharded cache"
    if kvcache.draws_noise(spec, generator):
        return "policy noise"
    if sampler is not sampler_lib.greedy:
        return "sampler draws"
    return None


class StepGraphs:
    """The decode step of one cache as graphs, one per flush variant.
    `step(tok, ring_full)` is the eager step (the model's dispatch and
    the sample; returns the tokens). `variants` are the ``ring_full``
    values the policy takes. Counts `replays`, `captures` and
    `capture_s` (host seconds)."""

    def __init__(self, backend, step: Callable, cfg, cache: M.ModelCache,
                 tok: torch.Tensor, variants) -> None:
        self.backend = backend
        self.cache = cache
        self._step = step
        self.variants = tuple(variants)
        self.tok_in = torch.empty_like(tok)
        self.tok_out = torch.empty(tok.shape[0], dtype=torch.int32,
                                   device=tok.device)
        leaves = cache_leaves(cache)
        self._sig = (cfg, tuple(tok.shape), tok.dtype, str(tok.device),
                     tuple((tuple(t.shape), t.dtype) for t in leaves))
        self._ptrs = None
        self._graphs: dict = {}
        self._pool = None
        self.replays = self.captures = 0
        self.capture_s = 0.0

    def ready(self, tok: torch.Tensor, ring_full, trace) -> bool:
        """Whether this step replays a graph: it is one of the cache's
        variants with a static token shape, and its shapes have run
        eagerly in the process (then the warm variants not yet captured
        are captured now, back to back, under a ``graph_capture`` span of
        `trace` that holds the model step's ranges). False means the
        caller runs the step eagerly, which warms its shapes."""
        if (not isinstance(ring_full, bool) or ring_full not in self.variants
                or tok.shape != self.tok_in.shape
                or tok.dtype != self.tok_in.dtype):
            return False
        ptrs = tuple(t.data_ptr() for t in cache_leaves(self.cache))
        if ptrs != self._ptrs:
            self._graphs.clear()
            self._ptrs, self._pool = ptrs, None
        if ring_full in self._graphs:
            return True
        if (self._sig, ring_full) not in _WARM:
            _WARM.add((self._sig, ring_full))
            return False
        with trace.span("graph_capture") as sp, \
                obs_trace.model_tracing(trace):
            for rf in self.variants:
                if rf not in self._graphs and (self._sig, rf) in _WARM:
                    self._graphs[rf] = self._capture(rf)
        self.capture_s += sp.elapsed
        return True

    def _capture(self, ring_full: bool):
        """(replay, ((counter, increments the capture recorded), ...))."""
        def fn():
            self.tok_out.copy_(self._step(self.tok_in, ring_full))

        counters = tuple(kbuild.LAUNCH_COUNTERS)
        before = [c.launches for c in counters]
        replay, self._pool = self.backend.capture(fn, self._pool)
        moved = tuple((c, c.launches - n) for c, n in zip(counters, before)
                      if c.launches != n)
        for c, n in moved:
            c.launches -= n
        self.captures += 1
        return replay, moved

    def replay(self, tok: torch.Tensor, ring_full: bool) -> torch.Tensor:
        """One step through the variant's graph (`ready` said True): the
        tokens copied in, the graph replayed, the sampled tokens copied
        out (a new tensor), the launch counters moved as the eager step
        moves them."""
        replay, moved = self._graphs[ring_full]
        self.tok_in.copy_(tok)
        replay()
        for c, n in moved:
            c.launches += n
        self.replays += 1
        return self.tok_out.clone()
