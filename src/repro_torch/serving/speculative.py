"""Self-speculative decoding over compressed KV caches (counterpart of
`repro.serving.speculative`, for the dense and eagerly paged stores).

Per-token decode moves every weight to produce one token per slot. A
compressed cache is also a cheap *drafter*: the same weights decode gamma
tokens per slot against a second, cheaper cache view (`--draft-policy`:
a sliding-window view over an uncompressed store, a tiny quantized KIVI
ring, or `same`, a clone of the target spec — the acceptance ceiling).
Then ONE rectangular forward (`nn.model.verify_step`) scores each slot's
segment (last committed token + drafts) against the real cache, commits
the longest draft prefix that matches the target's argmax plus the
bonus / correction token, and rolls the rejects back inside the same step.

**Exactness.** Greedy speculative streams equal non-speculative decode
because every verify sub-step reproduces the decode step it replaces.
The one obligation that makes rollback trivial is the **depth cap**: a
slot drafts at most as many tokens as its cache can append without an
eviction or a quantized ring flush (`CacheMirror.headroom_after_feeds`).
The committed first row may evict or flush (it is never rolled back),
the draft rows may not: `full` speculates to the end of its budget, a
KIVI ring in ring-sized bursts, a dense compressed store at budget
(`h2o`) not at all (every round is a plain step).

**No device reads for control.** Flush and eviction timing depend only
on append counts, so host mirrors (`CacheMirror`) decide depths and feed
every append's flush decision (`ring_full`): only sub-step 0 of a verify
segment may flush, by the depth cap. The round is synchronous by design —
drafting needs the previous round's committed tokens on the host.

Appends are row-masked: a slot that is not decoding (free, or mid chunked
admission) never appends, so the mirrors of the active slots are the
whole flush state.

**The overload ladder.** Under lazy block growth each round grants the
blocks its verify appends need (a starved slot drops to a plain step,
then climbs the ladder or retires "oom") and a rollback returns the
blocks it no longer covers. A preempted slot drops its target and
drafter state; on re-admission it replays its committed tokens through
plain rounds (no drafts), then one more plain round, and drafts again.

Not ported: tracing and metrics.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import cache as kvcache
from repro_torch.core import paging
from repro_torch.core.cache import CacheSpec
from repro_torch.nn import model as M
from repro_torch.serving.scheduler import Request


# ---------------------------------------------------------------------------
# Draft-policy resolution
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DraftPolicy:
    """Resolved drafter: the model config and cache spec it decodes with
    (same weights either way)."""
    name: str
    cfg: Any
    spec: CacheSpec


def resolve_draft_policy(policy: str, cfg, base_spec: CacheSpec,
                         prompt_len: int, max_new: int) -> DraftPolicy:
    """Parse a `--draft-policy` string.

    * ``window:N`` — sliding-window attention (window N) over an
      uncompressed store: cheapest attention reads, always has headroom.
    * ``kivi2[:budget[:window]]`` (also kivi4 / int8) — a quantized KIVI
      ring at a tiny budget, whose headroom cycles like the target's.
    * ``same`` — the target spec (the drafter computes what the verifier
      does: acceptance 1.0).
    """
    parts = policy.split(":")
    kind = parts[0]
    if kind == "same":
        return DraftPolicy("same", cfg, base_spec)
    if kind == "window":
        win = int(parts[1]) if len(parts) > 1 else 64
        if win < 1:
            raise ValueError(f"draft window must be >= 1, got {win}")
        spec = CacheSpec(budget=prompt_len + max_new, policy="none",
                         sinks=base_spec.sinks)
        return DraftPolicy(f"window:{win}",
                           dataclasses.replace(cfg, sliding_window=win), spec)
    bits = {"kivi2": 2, "kivi4": 4, "int8": 8}.get(kind)
    if bits is None:
        raise ValueError(
            f"unknown draft policy {policy!r} (want window:N, "
            f"kivi2[:budget[:window]], kivi4[...], int8[...], or same)")
    window = int(parts[2]) if len(parts) > 2 else (base_spec.window or 16)
    budget = int(parts[1]) if len(parts) > 1 else (base_spec.budget or 64)
    budget = max(-(-budget // window) * window, window)   # group-aligned
    spec = CacheSpec(budget=budget, window=window, bits=bits, group=window,
                     policy="streaming", sinks=base_spec.sinks)
    return DraftPolicy(f"{kind}:{budget}:{window}", cfg, spec)


# ---------------------------------------------------------------------------
# Host-side cache mirror
# ---------------------------------------------------------------------------


class CacheMirror:
    """Host replica of each slot's cache-growth state: per-layer main
    store `length`, ring `rlen`, absolute `pos`. An append flushes iff
    ``rlen >= window`` and evicts iff ``length >= cap``, so depth caps and
    flush decisions follow from counts without reading the device. The
    loop advances it for every append / truncate it causes and re-derives
    it at each admission (`compress_prompt`'s arithmetic)."""

    def __init__(self, spec: CacheSpec, layer_budgets, S_phys: int,
                 n_slots: int):
        self.spec = spec
        self.S = int(S_phys)
        lb = np.minimum(np.asarray(layer_budgets, np.int64).reshape(-1),
                        self.S)
        # a quantized flush grows whole groups; a dense append evicts at
        # min(budget, S)
        self.cap_rows = (lb // spec.group) * spec.group if spec.quantized \
            else lb
        self.length = np.zeros((n_slots, lb.size), np.int64)
        self.rlen = np.zeros(n_slots, np.int64)
        self.pos = np.zeros(n_slots, np.int64)

    def admit(self, slot: int, prompt_len: int) -> None:
        """Replicate `compress_prompt`'s post-admission state."""
        spec, S, W = self.spec, self.S, self.spec.window
        if S >= prompt_len and not spec.quantized and W == 0:
            self.length[slot] = prompt_len     # verbatim-placement branch
        else:
            n_main = max(min(S, prompt_len - W), 0)
            self.length[slot] = np.minimum(n_main, self.cap_rows)
        self.rlen[slot] = W
        self.pos[slot] = prompt_len

    def reset(self, slot: int) -> None:
        self.length[slot] = 0
        self.rlen[slot] = 0
        self.pos[slot] = 0

    def snapshot(self, slot: int) -> dict:
        """The slot's mirror row, detached: it rides a host-tier slot
        snapshot, so a spill-preempted request resumes with the row
        counts it left with."""
        return dict(length=self.length[slot].copy(),
                    rlen=int(self.rlen[slot]), pos=int(self.pos[slot]))

    def restore(self, slot: int, snap: dict) -> None:
        self.length[slot] = snap["length"]
        self.rlen[slot] = snap["rlen"]
        self.pos[slot] = snap["pos"]

    def drop_rows(self, slot: int, n: int) -> None:
        """Mirror of pressure degradation (`paging.degrade_slot_groups`):
        the slot lost `n` of its oldest flushed main-store rows in every
        layer. The ring and the absolute position stay: the drop rewrites
        history, not the append cursor."""
        if n <= 0:
            return
        self.length[slot] = np.maximum(self.length[slot] - n, 0)

    def _sim(self, slot: int, n: int):
        """(length, rlen) after n more appends."""
        ln = self.length[slot].copy()
        rl = int(self.rlen[slot])
        W = self.spec.window
        for _ in range(n):
            if self.spec.quantized:
                if rl >= W:
                    ln = np.minimum(ln + W, self.cap_rows)
                    rl = 0
                rl += 1
            else:
                ln = np.minimum(ln + 1, self.cap_rows)
        return ln, rl

    def append(self, slot: int, n: int = 1) -> None:
        self.length[slot], self.rlen[slot] = self._sim(slot, n)
        self.pos[slot] += n

    def truncate(self, slot: int, n: int) -> None:
        """Mirror of `cache.truncate_rows` (by the depth cap, the undone
        appends were fresh in every layer)."""
        if n <= 0:
            return
        if self.spec.quantized:
            self.rlen[slot] -= n
        else:
            self.length[slot] -= n
        self.pos[slot] -= n

    def flushes(self, slot: int, n: int) -> bool:
        """True when the append after `n` more appends flushes the ring."""
        return self.spec.quantized and self._sim(slot, n)[1] >= \
            self.spec.window

    def headroom_after_feeds(self, slot: int, n: int) -> int:
        """Appends guaranteed eviction / flush-free after `n` more appends
        land: the depth budget for rows that may be rolled back."""
        ln, rl = self._sim(slot, n)
        if self.spec.quantized:
            return int(self.spec.window - rl)
        return int(np.min(self.cap_rows - ln))

    def rows_after_feeds(self, slot: int, n: int) -> int:
        """Most main-store rows any layer uses after `n` more appends: the
        paged block-coverage target (one table serves every layer, so
        coverage follows the widest layer)."""
        ln, _ = self._sim(slot, n)
        return int(ln.max())


# ---------------------------------------------------------------------------
# Acceptance accounting
# ---------------------------------------------------------------------------


@dataclass
class SpecStats:
    """Draft / verify accounting for one `generate_continuous` run."""
    rounds: int = 0             # loop iterations that dispatched a step
    verify_rounds: int = 0      # ... of which ran `verify_step` (the rest
                                # ran one plain decode step)
    draft_calls: int = 0        # drafter decode steps dispatched
    verify_steps: int = 0       # slot-steps verified with >= 1 draft
    plain_steps: int = 0        # slot-steps with no drafts (depth cap 0)
    drafted: int = 0            # draft tokens proposed
    accepted: int = 0           # draft tokens accepted by the verifier
    committed: int = 0          # tokens committed by drafted verify steps
    draft_policy: str = ""
    gamma: int = 0

    @property
    def plain_rounds(self) -> int:
        return self.rounds - self.verify_rounds

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(self.drafted, 1)

    @property
    def committed_per_verify_step(self) -> float:
        return self.committed / max(self.verify_steps, 1)

    def describe(self) -> str:
        return (f"spec[{self.draft_policy} gamma={self.gamma}]: "
                f"{self.verify_steps} verify + {self.plain_steps} plain "
                f"slot-steps, acceptance {self.acceptance_rate:.2f} "
                f"({self.accepted}/{self.drafted}), "
                f"{self.committed_per_verify_step:.2f} committed/verify")


# ---------------------------------------------------------------------------
# The draft / verify serving loop
# ---------------------------------------------------------------------------


@dataclass
class _SlotSpecState:
    """Per-slot host state of the speculative lifecycle."""
    stream: List[int] = field(default_factory=list)   # prompt + committed
    fed: int = 0            # stream tokens whose KV the draft cache holds
    # recompute-on-resume: committed tokens still to re-feed through the
    # target cache (outputs discarded); while nonempty the slot drafts
    # nothing (plain replay rounds)
    replay: List[int] = field(default_factory=list)
    # True from a continuation's admission until its first round past the
    # replay: that round is plain too, so its one append stays inside the
    # admission's resume reserve and always commits a new token (what
    # makes preemption converge)
    resumed: bool = False


def generate_continuous_spec(eng, requests: Sequence[Union[Request,
                                                           np.ndarray]], *,
                             buckets: Optional[Sequence[int]] = None):
    """Speculative twin of `Engine.generate_continuous` (dispatched from
    it when the engine was built with ``speculative=True``). Synchronous
    rounds of: admit (monolithic, or one chunked-prefill step) -> draft ->
    verify / commit / rollback -> record."""
    gamma = eng.gamma
    dspec = eng.draft.spec
    stats = SpecStats(draft_policy=eng.draft.name, gamma=gamma)
    sched = eng._new_scheduler(buckets)
    for r in requests:
        if not isinstance(r, Request):
            r = Request(tokens=r, max_new=eng.max_new)
        if r.max_new > eng.max_new:
            raise ValueError(f"request max_new {r.max_new} exceeds engine "
                             f"headroom {eng.max_new}")
        sched.submit(r)

    max_len = eng.prompt_len + eng.max_new
    cache = M.init_cache(eng.cfg, eng.spec, eng.slots, max_len,
                         layer_budgets=eng.layer_budgets, device=eng.device,
                         paged=eng.paged, block_len=eng.block_len,
                         pool_blocks=eng.pool_blocks)
    dcache = M.init_cache(eng.draft.cfg, dspec, eng.slots, max_len,
                          layer_budgets=eng.draft_layer_budgets,
                          device=eng.device)
    tmirror = CacheMirror(eng.spec, eng.layer_budgets, eng._S_phys,
                          eng.slots)
    dmirror = CacheMirror(dspec, eng.draft_layer_budgets,
                          dspec.main_store_len(max_len), eng.slots)
    slot_state = [_SlotSpecState() for _ in range(eng.slots)]
    prefill_s = 0.0
    decode_tokens = 0
    clean = set(range(eng.slots))

    def reset_slot(i: int) -> None:
        eng._reset(cache, i)
        kvcache.reset_slot(dcache.attn, i, batch_axis=2)
        tmirror.reset(i)
        dmirror.reset(i)
        slot_state[i] = _SlotSpecState()
        clean.add(i)

    def replaying() -> List[int]:
        """Slots mid-resume: never preemption victims (a victim must have
        recorded progress since its last preemption). A continuation
        stays exempt past its replay until its first new token commits
        (`resumed`): the JAX loop exempts only a nonempty replay, so a
        slot preempted between its last replay round and its first new
        token resumes with nothing gained, and on a small pool two
        admissions can trade it forever."""
        return [i for i, st in enumerate(slot_state)
                if st.replay or st.resumed]

    def spec_preempt(i: int) -> None:
        """Preempt slot `i`: requeue prompt + committed tokens as a
        continuation and drop its target and drafter state (the drafter
        re-prefills at re-admission). Every committed token was recorded
        synchronously, so none is in flight."""
        sched.preempt(i)
        reset_slot(i)

    def resume(slot: int, req: Request) -> None:
        """A re-admitted continuation: the prompt's KV was just
        prefilled (its sample is discarded, the first emitted token is in
        the prefix); the recorded tokens re-enter through plain replay
        rounds, all but the last with their outputs discarded; the last
        one's output is the first new token."""
        st = slot_state[slot]
        st.stream = (list(map(int, req.tokens))
                     + [int(t) for t in req.emitted_prefix])
        st.replay = [int(t) for t in req.emitted_prefix[:-1]]
        st.resumed = True

    def admit_draft(slot: int, req: Request) -> None:
        """Prefill + insert the drafter's cache for a just-admitted
        request (the drafter sees the same prompt under its own spec)."""
        nonlocal prefill_s
        with eng.trace.span("draft_prefill", tid=slot + 1,
                            args=dict(uid=req.uid)) as sp:
            _, dpc = eng._prefill(req.tokens[None], draft=True)
            kvcache.insert_request(dcache.attn, slot, dpc.attn, batch_axis=2)
        prefill_s += sp.elapsed
        dmirror.admit(slot, len(req.tokens))
        slot_state[slot] = _SlotSpecState(stream=list(map(int, req.tokens)),
                                          fed=len(req.tokens))

    def record(slot: int, tok: int, *, count: bool = True) -> bool:
        """Record one committed token; True if the slot retired. A
        request's prefill-made first token is not a decode token."""
        nonlocal decode_tokens
        if count:
            decode_tokens += 1
        slot_state[slot].stream.append(int(tok))
        reason = sched.record_token(slot, int(tok))
        if reason is not None:
            sched.retire(slot, reason)
            reset_slot(slot)
            return True
        return False

    def admit_into(slot: int, ladder: bool = False) -> bool:
        """Monolithic admission of target and drafter caches, as the plain
        loop's; True when a request now decodes in the slot. `ladder`
        (round-top sweep only: a victim reset mid-round would corrupt
        the round's per-slot state) lets a refused admission preempt a
        victim for its blocks."""
        nonlocal prefill_s
        while True:
            req = sched.admit_next(slot)
            if req is None:
                if (eng.paged and sched.pending
                        and eng._retry_refused_admission(
                            sched, ladder, spec_preempt,
                            (slot, *replaying()))):
                    continue
                if slot not in clean:
                    reset_slot(slot)
                return False
            t0 = time.perf_counter()
            with eng.trace.span("prefill", tid=slot + 1,
                                args=dict(uid=req.uid)) as sp:
                logits, pc = eng._prefill(req.tokens[None])
                tok_dev = eng.sampler(logits, eng.gen)
                eng._insert(cache, sched, slot, pc)
                clean.discard(slot)
                tmirror.admit(slot, len(req.tokens))
                # kvlint: ok(host-sync: admission prefill's first token — once per admitted request, not per round)
                tok = int(tok_dev.item())
            prefill_s += sp.elapsed
            admit_draft(slot, req)
            if req.emitted_prefix:
                # the target's and the drafter's prefill
                eng._note_readmit(req, time.perf_counter() - t0)
                resume(slot, req)
                return True
            if not record(slot, tok, count=False):
                return True
            # 1-token request: retired at once, refill the slot

    def grow_blocks_for(slot: int, n_appends: int) -> bool:
        """Lazy growth: make the slot's table cover the rows its next
        `n_appends` appends can touch. False: the pool is starved."""
        return not eng.lazy_blocks or eng._grow_blocks(
            sched, cache, slot, tmirror.rows_after_feeds(slot, n_appends))

    def shrink_blocks_for(slot: int) -> None:
        """Rollback's return to the free list: release the table entries
        past the post-truncate row coverage, unmapped before they can be
        granted again."""
        if not eng.lazy_blocks:
            return
        need = paging.request_blocks_prefix(
            eng.spec, eng._S_phys, tmirror.rows_after_feeds(slot, 0),
            eng.block_len)
        have = len(sched.slot_blocks(slot))
        if have > need:
            sched.release_blocks(slot, have - need)
            paging.clear_block_table_from(cache.attn, slot, need,
                                          batch_axis=2)

    def refill() -> None:
        for i in sched.free_slots():
            if not sched.pending or not admit_into(i):
                break

    def mask_of(slots) -> torch.Tensor:
        m = np.zeros(eng.slots, bool)
        m[list(slots)] = True
        return eng._h2d(m)

    adm = None                          # the in-flight chunked admission
    preempt_due = list(eng.preempt_at)  # forced (round, slot) pairs
    if not eng.chunked_prefill:
        for i in range(eng.slots):
            admit_into(i)

    # per-round telemetry: pre-bound instruments, host mirrors only
    trace = eng.trace
    mx = eng.metrics
    g_free = mx.gauge("pool.free_frac")
    g_active = mx.gauge("slots.active")
    c_iters = mx.counter("engine.loop_iters")
    loop_t0 = time.perf_counter()
    prefill_at_loop = prefill_s
    while True:
        it_t0 = time.perf_counter()
        if mx:
            g_active.set(len(sched.active_slots()))
            c_iters.inc()
            if eng.paged:
                g_free.set(eng.block_allocator.available
                           / max(eng.pool_blocks, 1))
        if eng.chunked_prefill and adm is None:
            adm, dt0 = eng._start_admission_timed(sched)
            prefill_s += dt0
        active = sched.active_slots()
        if eng.chunked_prefill and adm is not None:
            adm, first, dt = eng._advance_chunked_admission(
                adm, sched, cache, run_all=not active)
            prefill_s += dt
            if first is not None:
                slot0, ftok = first
                clean.discard(slot0)
                req0 = sched.slot_request(slot0)
                tmirror.admit(slot0, len(req0.tokens))
                admit_draft(slot0, req0)
                if req0.emitted_prefix:
                    # chunk-admitted continuation: replay, record nothing
                    resume(slot0, req0)
                else:
                    # kvlint: ok(host-sync: chunk-admitted first token — once per admission, not per round)
                    record(slot0, int(ftok[0].item()), count=False)
                active = sched.active_slots()
        if preempt_due:
            # forced preemptions: fire at the given dispatch round
            due = [p for p in preempt_due if p[0] == stats.rounds]
            if due:
                preempt_due = [p for p in preempt_due
                               if p[0] != stats.rounds]
                for _, s in due:
                    if s in sched.active_slots():
                        spec_preempt(s)
                active = sched.active_slots()
        eng._escalate_stall(sched, adm, spec_preempt, replaying())
        if eng.preemption and not eng.chunked_prefill and sched.pending:
            # admission retry sweep: a refused head may fit now, or may
            # claim a victim through the ladder
            for i in sched.free_slots():
                if not sched.pending or not admit_into(i, ladder=True):
                    break
            active = sched.active_slots()
        if (eng.audit_every and stats.rounds
                and stats.rounds % eng.audit_every == 0):
            # kvlint: ok(host-sync: periodic pool audit reads the device block table — every audit_every rounds, off by default)
            eng._run_audit(sched, cache)
            if trace:
                trace.instant("audit", args=dict(round=stats.rounds))
        if not active:
            if sched.pending or adm is not None:
                if not eng.chunked_prefill:
                    for i in sched.free_slots():
                        admit_into(i)
                continue
            break

        # --- per-slot speculation depth (host mirrors, no device read) --
        gam: Dict[int, int] = {}
        for s in active:
            if slot_state[s].replay:
                gam[s] = 0      # mid-resume: plain replay rounds only
                continue
            if slot_state[s].resumed:
                # the first round past the replay: plain, inside the
                # admission's resume reserve
                slot_state[s].resumed = False
                gam[s] = 0
                continue
            st, req = slot_state[s], sched.slot_request(s)
            remaining = req.max_new - len(st.stream) + len(req.tokens)
            g = min(gamma, tmirror.headroom_after_feeds(s, 1),
                    dmirror.headroom_after_feeds(
                        s, len(st.stream) - st.fed) + 1,
                    max(remaining - 1, 0))
            gam[s] = max(int(g), 0)

        # --- draft: chained masked decode steps on the drafter cache ----
        drafts: Dict[int, List[int]] = {s: [] for s in active}
        participating = [s for s in active if gam[s] >= 1]
        while True:
            feed = np.zeros(eng.slots, np.int64)
            rows, want_out = [], set()
            for s in participating:
                st = slot_state[s]
                if st.fed < len(st.stream):
                    feed[s] = st.stream[st.fed]       # catch-up / chain head
                    rows.append(s)
                    if st.fed == len(st.stream) - 1:
                        want_out.add(s)
                elif len(drafts[s]) < gam[s]:
                    feed[s] = drafts[s][-1]
                    rows.append(s)
                    want_out.add(s)
            if not rows:
                break
            ring_full = any(dmirror.flushes(s, 0) for s in rows)
            tok_dev = eng._decode(dcache, eng._h2d(feed)[:, None],
                                  ring_full, append_mask=mask_of(rows),
                                  draft=True)
            stats.draft_calls += 1
            # kvlint: ok(host-sync: draft tokens feed the host-built verify batch — draft rounds are synchronous by design)
            toks = tok_dev.cpu().numpy()
            for s in rows:
                st = slot_state[s]
                if st.fed < len(st.stream):
                    st.fed += 1
                dmirror.append(s, 1)
                if s in want_out and len(drafts[s]) < gam[s]:
                    drafts[s].append(int(toks[s]))

        # --- lazy growth: cover the verify appends; a starved slot drops
        # to a plain step, then climbs the ladder or retires "oom" -------
        def evict(v: int) -> None:
            spec_preempt(v)
            if v in active:
                active.remove(v)
            gam.pop(v, None)

        for s in list(active):
            if s not in active:     # preempted as an earlier slot's victim
                continue
            if grow_blocks_for(s, 1 + gam[s]):
                continue
            if gam[s] > 0 and grow_blocks_for(s, 1):
                gam[s] = 0
                continue
            gam[s] = 0
            if eng._climb_ladder(sched, s, lambda: grow_blocks_for(s, 1),
                                 evict, replaying()) != "oom":
                continue
            sched.retire(s, "oom")
            reset_slot(s)
            active.remove(s)
            gam.pop(s, None)
        if not active:
            continue

        if all(gam[s] == 0 for s in active):
            # --- all-plain round (every depth cap is 0, e.g. a dense
            # compressed store at budget): one decode step is the same
            # computation as a valid_len-1 verify at a fraction of the
            # width; the drafter's unverified chain rows roll back
            m_vec = np.zeros(eng.slots, np.int32)
            for s in active:
                m_vec[s] = max(len(drafts[s]) - 1, 0)
                dmirror.truncate(s, int(m_vec[s]))
            if m_vec.any():
                kvcache.truncate_rows(dcache.attn, dspec, eng._h2d(m_vec))
            feed = np.zeros(eng.slots, np.int64)
            for s in active:
                st = slot_state[s]
                # mid-resume: re-feed the next recorded token (its output
                # recomputes a committed one); past the replay the last
                # stream token's output is the first new token
                feed[s] = st.replay[0] if st.replay else st.stream[-1]
            ring_full = any(tmirror.flushes(s, 0) for s in active)
            tok_dev = eng._decode(cache, eng._h2d(feed)[:, None], ring_full,
                                  append_mask=mask_of(active))
            sched.note_decode_step()
            stats.rounds += 1
            if trace:
                trace.complete("round", it_t0,
                               args=dict(kind="plain", active=len(active)))
            # kvlint: ok(host-sync: plain round — the token builds the next feed host-side)
            toks = tok_dev.cpu().numpy()
            for s in active:
                tmirror.append(s, 1)
                if slot_state[s].replay:
                    slot_state[s].replay.pop(0)   # replayed; output unused
                    continue
                stats.plain_steps += 1
                if record(s, int(toks[s])) and sched.pending \
                        and not eng.chunked_prefill:
                    refill()
            continue

        # --- verify: one rectangular forward, commit + rollback inside --
        tokens = np.zeros((eng.slots, gamma + 1), np.int64)
        valid = np.zeros(eng.slots, np.int32)
        for s in active:
            st = slot_state[s]
            tokens[s, 0] = st.replay[0] if st.replay else st.stream[-1]
            for i, d in enumerate(drafts[s][:gam[s]]):
                tokens[s, 1 + i] = d
            valid[s] = 1 + min(gam[s], len(drafts[s]))
        # only sub-step 0 may flush (the depth cap); the mirrors say where
        ring_full = [any(t < valid[s] and tmirror.flushes(s, t)
                         for s in active) for t in range(gamma + 1)]
        y_dev, acc_dev = eng._verify(cache, eng._h2d(tokens),
                                     eng._h2d(valid), ring_full)
        sched.note_decode_step()
        stats.rounds += 1
        stats.verify_rounds += 1
        if trace:
            trace.complete("round", it_t0,
                           args=dict(kind="verify", active=len(active)))
        # kvlint: ok(host-sync: verify results drive host-side acceptance mirroring — the round is synchronous by design)
        y = y_dev.cpu().numpy()
        # kvlint: ok(host-sync: verify results drive host-side acceptance mirroring — the round is synchronous by design)
        acc = acc_dev.cpu().numpy()

        # acceptance and rollback happened inside verify_step: mirror them
        # and roll the drafter back past the accepted prefix
        m_vec = np.zeros(eng.slots, np.int32)
        for s in active:
            g, a = int(valid[s]) - 1, int(acc[s])
            tmirror.append(s, int(valid[s]))
            tmirror.truncate(s, g - a)
            # chain rows the drafter appended: drafts made minus the last,
            # which was never fed
            fed_draft = max(len(drafts[s]) - 1, 0)
            keep = min(a, fed_draft)
            m_vec[s] = fed_draft - keep
            dmirror.truncate(s, int(m_vec[s]))
            slot_state[s].fed += keep
            if g >= 1:
                stats.verify_steps += 1
                stats.drafted += g
                stats.accepted += a
            elif not slot_state[s].replay:
                stats.plain_steps += 1
        if m_vec.any():
            kvcache.truncate_rows(dcache.attn, dspec, eng._h2d(m_vec))

        for s in active:
            g, a = int(valid[s]) - 1, int(acc[s])
            if slot_state[s].replay:
                slot_state[s].replay.pop(0)   # replayed (valid 1); unused
                continue
            retired = False
            for i in range(a + 1):
                if g >= 1:
                    stats.committed += 1
                if record(s, int(y[s, i])):
                    retired = True
                    break
            if not retired:
                shrink_blocks_for(s)
            # as the reference loop: a slot still decoding refills the
            # free ones (a retire alone does not)
            if not retired and sched.pending and not eng.chunked_prefill:
                refill()

    decode_s = (time.perf_counter() - loop_t0) - (prefill_s - prefill_at_loop)
    if eng.paged:
        eng._run_audit(sched)     # every pool block accounted for, or raise
    return eng._continuous_result(sched, cache, prefill_s=prefill_s,
                                  decode_s=decode_s,
                                  decode_tokens=decode_tokens,
                                  spec_stats=stats)
