"""Batched serving engine with first-class cache compression (counterpart
of `repro.serving.engine`: the wave path and the dense, monolithic
continuous-batching path).

  * **Wave-based** (`generate`): requests in waves of `slots` sequences
    of one prompt length; one prefill + `max_new - 1` decode steps each.
  * **Continuous** (`generate_continuous`): one persistent `slots`-wide
    cache; each request is prefilled at its bucket length (batch 1),
    copied into a free batch slot (`cache.insert_request`), and retired
    the moment it hits EOS or its `max_new`, its slot refilled from the
    queue mid-decode.

Both decode loops are double-buffered: step N+1 is dispatched from step
N's device-side tokens before the host reads step N's tokens, and the
read waits on an event recorded right behind step N's token copy — not
on step N+1. The quantized ring's flush decision rides a host mirror of
the ring lengths, so a decode step needs no device sync at all.

Not ported yet (the constructor raises NotImplementedError): the paged
pool, chunked prefill, speculative decoding, prefix sharing, the
overload ladder (preemption, degradation) and tiering; samplers other
than greedy; tracing and metrics.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import budgets as budgets_lib
from repro_torch.core import cache as kvcache
from repro_torch.core.cache import CacheSpec, cache_logical_bytes_per_layer
from repro_torch.core.policy import CompressionPolicy
from repro_torch.nn import model as M
from repro_torch.serving import sampler as sampler_lib
from repro_torch.serving.scheduler import Request, RequestResult, Scheduler


@dataclass
class GenerationResult:
    tokens: np.ndarray            # [n_requests, max_new]
    prefill_seconds: float
    decode_seconds: float
    decode_tokens_per_s: float
    cache_physical_bytes: int
    cache_logical_bytes: float
    full_cache_bytes: float
    compression_ratio: float
    policy_name: str


@dataclass
class ContinuousGenerationResult:
    results: List[RequestResult]  # sorted by uid; per-request tokens + latency
    prefill_seconds: float
    decode_seconds: float
    decode_steps: int
    decode_tokens: int            # useful tokens produced by decode steps
    decode_tokens_per_s: float
    occupancy: float              # mean active-slot fraction per decode step
    ttft_mean_s: float
    cache_physical_bytes: int     # resident slots-wide footprint
    cache_logical_bytes: float
    full_cache_bytes: float
    compression_ratio: float
    policy_name: str


class RingMirror:
    """Host mirror of each slot's quantized-ring length. Every row of the
    batch appends once per decode step, and a row whose ring is full
    flushes first, so the counts evolve without reading the device; an
    admission leaves the ring full (`compress_prompt`), a reset empty."""

    def __init__(self, spec: CacheSpec, slots: int) -> None:
        self.window = spec.window if spec.quantized else 0
        self.rlen = np.zeros(slots, np.int64)

    def fill(self, slot: Optional[int] = None) -> None:
        self.rlen[slice(None) if slot is None else slot] = self.window

    def clear(self, slot: int) -> None:
        self.rlen[slot] = 0

    def advance(self) -> bool:
        """Account one decode step; True when some ring flushes in it."""
        if not self.window:
            return False
        full = self.rlen >= self.window
        self.rlen[full] = 0
        self.rlen += 1
        return bool(full.any())


class _TokenFetch:
    """Pipelined device->host token reads. `start` queues an async copy
    into pinned memory right behind the step that made the tokens and
    records an event; `get` waits for that event only, so work
    dispatched after `start` keeps running. Two buffers alternate: a
    buffer is reused only after its tokens were read."""

    def __init__(self, device: torch.device, n: int) -> None:
        self.cuda = device.type == "cuda"
        self._bufs = [torch.empty(n, dtype=torch.int32, pin_memory=self.cuda)
                      for _ in range(2)]
        self._i = 0

    def start(self, tok_dev: torch.Tensor):
        buf = self._bufs[self._i]
        self._i ^= 1
        buf.copy_(tok_dev, non_blocking=self.cuda)
        ev = None
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record()
        return buf, ev

    @staticmethod
    def get(handle) -> np.ndarray:
        buf, ev = handle
        if ev is not None:
            ev.synchronize()
        return buf.numpy().copy()


class Engine:
    """Serving engine over one compression policy (module docstring).
    `device` None means the card and raises without one; `params` must
    live on the engine's device. `use_kernels` overrides the config's
    kernels-or-reference switch."""

    def __init__(self, cfg, params, policy: CompressionPolicy, *,
                 prompt_len: Optional[int] = None, max_new: int,
                 slots: int = 4, buckets: Optional[Sequence[int]] = None,
                 use_kernels: Optional[bool] = None, device=None,
                 paged: bool = False,
                 chunked_prefill: bool = False, speculative: bool = False,
                 prefix_sharing: bool = False, preemption: bool = False,
                 degrade: bool = False, tiering: bool = False):
        for flag, on in (("paged", paged),
                         ("chunked_prefill", chunked_prefill),
                         ("speculative", speculative),
                         ("prefix_sharing", prefix_sharing),
                         ("preemption", preemption), ("degrade", degrade),
                         ("tiering", tiering)):
            if on:
                raise NotImplementedError(f"{flag}: not yet ported")
        self.device = resolve_device(device)
        if prompt_len is None and not buckets:
            raise ValueError("need prompt_len and/or buckets")
        if use_kernels is not None:
            cfg = cfg.replace(use_kernels=bool(use_kernels))
        self.buckets = (tuple(sorted({int(b) for b in buckets}))
                        if buckets else (int(prompt_len),))
        if prompt_len is None:
            prompt_len = max(self.buckets)
        if max(self.buckets) > prompt_len:
            raise ValueError(f"bucket {max(self.buckets)} exceeds "
                             f"prompt_len {prompt_len}")
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(f"params live on {table.device}, the engine "
                             f"on {self.device}")
        self.cfg, self.params, self.policy = cfg, params, policy
        self.prompt_len, self.max_new, self.slots = prompt_len, max_new, slots

        spec = policy.spec
        if spec.policy in ("nacl", "keyformer"):
            raise NotImplementedError(f"policy {spec.policy!r}: its noise "
                                      "draws are not yet ported")
        if not spec.compressed:
            # the uncompressed baseline still needs decode headroom (sized
            # for the largest bucket so every bucket shares one shape)
            spec = CacheSpec(budget=prompt_len + max_new, policy="none",
                             sinks=spec.sinks)
        self.spec = spec

        n_attn = cfg.num_attn_layers()
        alloc = budgets_lib.ALLOCATORS[policy.allocator]
        kw = dict(policy.allocator_kwargs)
        kw.setdefault("multiple", spec.group if spec.quantized else 1)
        # the measured signals of squeeze / zigzag are not ported yet:
        # their allocators take the JAX engine's defaults
        if policy.allocator == "squeeze":
            kw.setdefault("cos_sim", np.linspace(0.6, 0.95, n_attn))
        if policy.allocator == "zigzag":
            kw.setdefault("uncertainty", np.ones(n_attn))
        self.layer_budgets = np.minimum(alloc(n_attn, spec.budget, **kw),
                                        spec.main_store_len(prompt_len))

    # ------------------------------------------------------------------
    def _prefill(self, tokens: np.ndarray):
        batch = {"tokens": torch.as_tensor(np.asarray(tokens, np.int64),
                                           device=self.device)}
        return M.prefill(self.params, self.cfg, batch, self.spec,
                         layer_budgets=self.layer_budgets)

    def _decode(self, cache: M.ModelCache, tok: torch.Tensor,
                ring_full: bool) -> torch.Tensor:
        logits, _ = M.decode_step(self.params, self.cfg, cache, tok,
                                  self.spec, ring_full=ring_full)
        return sampler_lib.greedy(logits)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _logical_bytes_per_seq(self) -> float:
        """Per-sequence logical cache bytes under the layer budgets."""
        return sum(
            cache_logical_bytes_per_layer(
                self.spec, self.prompt_len + self.max_new,
                self.cfg.num_kv_heads, self.cfg.head_dim)
            * (lb / max(self.spec.budget, 1))
            for lb in self.layer_budgets)

    # ------------------------------------------------------------------
    def generate(self, prompts: np.ndarray) -> GenerationResult:
        """prompts: [n, prompt_len] int (exact bucket length)."""
        n, L = prompts.shape
        if L != self.prompt_len:
            raise ValueError(f"prompt length {L} != {self.prompt_len}")
        outs = np.zeros((n, self.max_new), np.int32)
        prefill_s = decode_s = 0.0
        phys = logical = 0.0
        fetch = _TokenFetch(self.device, self.slots)

        for w0 in range(0, n, self.slots):
            w1 = min(w0 + self.slots, n)
            wave = prompts[w0:w1]
            pad = self.slots - (w1 - w0)
            if pad:
                wave = np.concatenate([wave, np.repeat(wave[-1:], pad, 0)], 0)
            t0 = time.perf_counter()
            logits, cache = self._prefill(wave)
            tok = sampler_lib.greedy(logits)
            # kvlint: ok(host-sync: prefill's first tokens — once per wave, before the decode loop)
            first = tok.cpu().numpy()
            prefill_s += time.perf_counter() - t0
            outs[w0:w1, 0] = first[: w1 - w0]
            ring = RingMirror(self.spec, self.slots)
            ring.fill()
            tok = tok[:, None]
            t0 = time.perf_counter()
            pend, pend_t = None, 0
            for t in range(1, self.max_new):
                tok_dev = self._decode(cache, tok, ring.advance())
                tok = tok_dev[:, None]
                handle = fetch.start(tok_dev)
                if pend is not None:
                    # kvlint: ok(host-sync: the pipelined read — step t-1's tokens, behind step t's dispatch)
                    outs[w0:w1, pend_t] = fetch.get(pend)[: w1 - w0]
                pend, pend_t = handle, t
            if pend is not None:
                # kvlint: ok(host-sync: loop epilogue — the last pending tokens, once per wave)
                outs[w0:w1, pend_t] = fetch.get(pend)[: w1 - w0]
            self._sync()
            decode_s += time.perf_counter() - t0
            active = w1 - w0
            phys += (kvcache.cache_physical_bytes(cache.attn) * active
                     / self.slots)
            logical += self._logical_bytes_per_seq() * active
        full = (self.cfg.kv_bytes_per_token()
                * (self.prompt_len + self.max_new) * n)
        return GenerationResult(
            tokens=outs, prefill_seconds=prefill_s, decode_seconds=decode_s,
            decode_tokens_per_s=n * (self.max_new - 1) / max(decode_s, 1e-9),
            cache_physical_bytes=int(phys),
            cache_logical_bytes=float(logical),
            full_cache_bytes=float(full),
            compression_ratio=float(full / max(logical, 1.0)),
            policy_name=self.policy.name)

    # ------------------------------------------------------------------
    def generate_continuous(
        self, requests: Sequence[Union[Request, np.ndarray]], *,
        buckets: Optional[Sequence[int]] = None,
    ) -> ContinuousGenerationResult:
        """Serve `requests` through one persistent `slots`-wide cache.

        Each request is prefilled at its prompt bucket (batch 1) and
        copied into a free batch slot; every decode step advances all
        occupied slots at once; a request hitting its `eos_id` or
        `max_new` retires immediately and its slot goes to the next
        queued request. Bare arrays become
        `Request(tokens, max_new=self.max_new)`."""
        if buckets and max(int(b) for b in buckets) > self.prompt_len:
            raise ValueError(
                f"bucket {max(int(b) for b in buckets)} exceeds engine "
                f"prompt_len {self.prompt_len}")
        sched = Scheduler(buckets or self.buckets, self.slots)
        for r in requests:
            if not isinstance(r, Request):
                r = Request(tokens=r, max_new=self.max_new)
            if r.max_new > self.max_new:
                raise ValueError(f"request max_new {r.max_new} exceeds "
                                 f"engine headroom {self.max_new}")
            sched.submit(r)

        cache = M.init_cache(self.cfg, self.spec, self.slots,
                             self.prompt_len + self.max_new,
                             layer_budgets=self.layer_budgets,
                             device=self.device)
        next_tok = np.zeros(self.slots, np.int32)
        prefill_s = 0.0
        decode_tokens = 0
        # slots known to hold the empty-cache state: a refused admission
        # resets a slot at most once
        clean_slots = set(range(self.slots))
        ring = RingMirror(self.spec, self.slots)
        fetch = _TokenFetch(self.device, self.slots)

        def admit_into(slot_idx: int) -> bool:
            """Fill a free slot from the queue: batch-1 prefill, copy into
            the live cache, record the first token. Loops in case a
            request finishes on its first token. True when a request now
            occupies the slot (its first token in `next_tok`)."""
            nonlocal prefill_s
            while True:
                req = sched.admit_next(slot_idx)
                if req is None:
                    if slot_idx not in clean_slots:
                        # clear the slot so stale KV never leaks into a
                        # later occupant or the accounting
                        kvcache.reset_slot(cache.attn, slot_idx, batch_axis=2)
                        ring.clear(slot_idx)
                        clean_slots.add(slot_idx)
                    return False
                t0 = time.perf_counter()
                logits, pc = self._prefill(req.tokens[None])
                kvcache.insert_request(cache.attn, slot_idx, pc.attn,
                                       batch_axis=2)
                ring.fill(slot_idx)
                clean_slots.discard(slot_idx)
                # kvlint: ok(host-sync: admission prefill's first token — once per admitted request, not per decode step)
                tok_i = int(sampler_lib.greedy(logits).item())
                prefill_s += time.perf_counter() - t0
                next_tok[slot_idx] = tok_i
                reason = sched.record_token(slot_idx, tok_i)
                if reason is None:
                    return True
                sched.retire(slot_idx, reason)   # 1-token request; refill

        for i in range(self.slots):
            admit_into(i)

        # Double-buffered decode: step N+1 is dispatched from step N's
        # device-side tokens before the host reads step N's tokens. A
        # slot that retires at step N already has a stale step N+1 in
        # flight: its output is dropped from the valid set, and the
        # admission's insert overwrites the slot (wiping the stale
        # append) before the next dispatch carries the new first token.
        tok_in = torch.as_tensor(next_tok, device=self.device)
        pending = None                          # (fetch handle, valid slots)
        loop_t0 = time.perf_counter()
        prefill_at_loop = prefill_s
        while True:
            active = sched.active_slots()
            new_pending = None
            if active:
                tok_dev = self._decode(cache, tok_in[:, None], ring.advance())
                sched.note_decode_step()
                new_pending = (fetch.start(tok_dev), list(active))
                tok_in = tok_dev                # feed N+1 from N, no sync
            if new_pending is None and pending is None and not sched.pending:
                break
            if pending is not None:
                handle, pvalid = pending
                # kvlint: ok(host-sync: the one pipelined read — step N-1's tokens, behind step N's dispatch)
                toks = fetch.get(handle)
                admitted = []
                for i in pvalid:
                    decode_tokens += 1
                    reason = sched.record_token(i, toks[i])
                    if reason is not None:
                        sched.retire(i, reason)
                        if new_pending is not None and i in new_pending[1]:
                            new_pending[1].remove(i)
                        if admit_into(i):
                            admitted.append(i)
                if admitted:
                    idx = torch.as_tensor(admitted, device=self.device)
                    tok_in = tok_in.index_put(
                        (idx,), torch.as_tensor(next_tok[admitted],
                                                device=self.device))
            pending = new_pending
        decode_s = ((time.perf_counter() - loop_t0)
                    - (prefill_s - prefill_at_loop))

        results = sorted(sched.results, key=lambda r: r.uid)
        ttfts = [r.ttft_s for r in results]
        logical = self._logical_bytes_per_seq() * self.slots
        full = (self.cfg.kv_bytes_per_token()
                * (self.prompt_len + self.max_new) * self.slots)
        return ContinuousGenerationResult(
            results=results, prefill_seconds=prefill_s,
            decode_seconds=decode_s, decode_steps=sched.decode_steps,
            decode_tokens=decode_tokens,
            decode_tokens_per_s=decode_tokens / max(decode_s, 1e-9),
            occupancy=sched.occupancy,
            ttft_mean_s=float(np.mean(ttfts)) if ttfts else 0.0,
            cache_physical_bytes=kvcache.cache_physical_bytes(cache.attn),
            cache_logical_bytes=float(logical),
            full_cache_bytes=float(full),
            compression_ratio=float(full / max(logical, 1.0)),
            policy_name=self.policy.name)
