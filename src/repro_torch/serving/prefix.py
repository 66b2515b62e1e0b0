"""Host-side radix index over the paged pool: cross-request prefix reuse
(counterpart of `repro.serving.prefix`).

A trie keyed on token ids at **block granularity** (full blocks only: a
partial block's rows cannot be mapped read-only without tearing), where
each node pins one pool block id plus the host copy of that block's
prefill-scratch rows (K / V + attention mass). The engine owns all
device state and drives this class, as it drives the scheduler.

Two things are cached per node, for two reuses:

  * the **pool block id**: a warm admission maps it read-only into its
    block table and skips the pool write at insert (`n_skip`), so N
    templated requests pin one physical copy of the shared prefix;
  * the **scratch piece**: the block's rows of the chunked-prefill
    scratch (`nn.model.PrefillState`), kept on the host. A warm admission
    rebuilds its scratch from these pieces and streams only the suffix
    segments (`prefill_chunk` at a nonzero offset), so prefill work
    scales with the suffix, not the prompt.

Ownership: the index holds **one allocator reference per node** (taken
at `ingest`, dropped by the caller after `evict` / `disown`), so a
retired request's prefix blocks linger at refcount 1 — the pool doubles
as a prompt cache — and are reclaimed LRU-leaf-first only under
allocator pressure (the scheduler's `reclaim` hook). A block still
mapped by a resident slot (refcount > 1) is never evicted.

The index also keeps the last few full prompts, so the engine can spot
near-hits (same template, edited middle) and route them through
CacheBlend's selective recompute (`serving.cacheblend`).

With tiering, a cold node (refcount 1) can be *demoted* instead of
evicted: its block bytes move to the host tier under a handle
(`mark_host`) and the node keeps its trie position, so a later warm hit
pages it back (`promote`) rather than re-prefilling. `match` stops at the
first demoted node (a host block cannot be mapped read-only).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs.trace import NULL_TRACER


class _Node:
    """One full block of an indexed prefix: trie edge key = the block's
    token ids, payload = pool block id + host scratch rows. A demoted node
    (`host` set, `block_id` None) keeps its place in the trie, its block
    bytes in the host tier under that handle."""

    __slots__ = ("key", "parent", "children", "block_id", "piece", "tick",
                 "host")

    def __init__(self, key: tuple, parent: Optional["_Node"], block_id: int,
                 piece, tick: int):
        self.key = key
        self.parent = parent
        self.children: Dict[tuple, "_Node"] = {}
        self.block_id = block_id
        self.piece = piece
        self.tick = tick
        self.host: Optional[int] = None       # HostTier handle when demoted


class PrefixIndex:
    """Radix index at block granularity. `block_len` is the pool block
    length; `align` is the restore-length quantum the engine needs
    (lcm(block_len, the attention-mass group): chunked prefill resumes
    only at mass-group-aligned offsets)."""

    def __init__(self, block_len: int, *, align: int = 1,
                 max_recent: int = 16, tracer=None):
        if block_len < 1:
            raise ValueError(f"need block_len >= 1, got {block_len}")
        self.bl = block_len
        self.trace = tracer if tracer is not None else NULL_TRACER
        self.align = max(int(align), 1)
        self._children: Dict[tuple, _Node] = {}      # root's children
        self._nodes: Dict[int, _Node] = {}           # block id -> node
        self._host: Dict[int, _Node] = {}            # tier handle -> node
        self._orphaned: List[int] = []               # handles disown dropped
        self._tick = 0
        self._recent: List[np.ndarray] = []
        self.max_recent = max_recent
        self.ingested = 0
        self.evicted = 0
        self.demoted = 0
        self.promoted = 0

    def __len__(self) -> int:
        return len(self._nodes)

    def block_ids(self) -> List[int]:
        """Every pool block id the index holds a reference to (one per
        node): the index's side of the pool audit."""
        return list(self._nodes)

    def _key(self, tokens, b: int) -> tuple:
        return tuple(int(t) for t in tokens[b * self.bl:(b + 1) * self.bl])

    def _walk(self, tokens) -> List[_Node]:
        path: List[_Node] = []
        children = self._children
        for b in range(len(tokens) // self.bl):
            node = children.get(self._key(tokens, b))
            if node is None:
                break
            path.append(node)
            children = node.children
        return path

    # ---- reuse -----------------------------------------------------------
    def match(self, tokens) -> Tuple[List[int], List[tuple]]:
        """Longest indexed prefix of `tokens`, in full blocks: (pool block
        ids, scratch pieces) along the path, which is touched (LRU). The
        engine decides how much of the match it can use (alignment,
        budget retention, >= 1 suffix token). The usable match stops at
        the first demoted node; the engine promotes the path first
        (`match_nodes` + `promote`) when it wants the whole hit."""
        path = self._walk(tokens)
        self._tick += 1
        for n in path:
            n.tick = self._tick
        usable = []
        for n in path:
            if n.host is not None:
                break
            usable.append(n)
        return [n.block_id for n in usable], [n.piece for n in usable]

    def match_nodes(self, tokens) -> List[_Node]:
        """The raw matched path, demoted nodes included (no LRU touch):
        the engine's pre-admission hook for paging host nodes back."""
        return self._walk(tokens)

    def ingest(self, tokens, block_ids: List[int], pieces: List,
               allocator) -> int:
        """Index the first ``len(block_ids)`` full blocks of an admitted
        prompt: `block_ids[b]` holds rows ``[b*bl, (b+1)*bl)`` and
        `pieces[b]` their host scratch rows. A newly indexed block takes
        one allocator reference (the index's own: it outlives the
        ingesting slot). A node that exists keeps its block: first writer
        wins, the newcomer's block stays its slot's alone. Returns the
        number of blocks newly indexed."""
        children = self._children
        parent: Optional[_Node] = None
        added = 0
        self._tick += 1
        for b, bid in enumerate(block_ids):
            key = self._key(tokens, b)
            node = children.get(key)
            if node is None:
                node = _Node(key, parent, int(bid), pieces[b], self._tick)
                children[key] = node
                self._nodes[node.block_id] = node
                allocator.incref([node.block_id])
                added += 1
            node.tick = self._tick
            parent = node
            children = node.children
        self.ingested += added
        return added

    def _unlink(self, node: _Node) -> None:
        siblings = (node.parent.children if node.parent is not None
                    else self._children)
        if siblings.get(node.key) is node:
            del siblings[node.key]

    # ---- pressure --------------------------------------------------------
    def evict(self, n_blocks: int, allocator) -> List[int]:
        """Drop up to `n_blocks` LRU **leaf** nodes whose block only the
        index references (refcount 1: lingering prompt cache, mapped by no
        resident slot). Leaf-first keeps every surviving node's root path
        whole (a restore needs contiguous blocks). Returns the dropped
        ids; the caller releases the index's references through the
        scheduler's `release` seam."""
        out: List[int] = []
        while len(out) < n_blocks:
            cands = [nd for nd in self._nodes.values()
                     if not nd.children
                     and allocator.refcount(nd.block_id) == 1]
            if not cands:
                break
            victim = min(cands, key=lambda nd: nd.tick)
            self._unlink(victim)
            del self._nodes[victim.block_id]
            out.append(victim.block_id)
        self.evicted += len(out)
        if out and self.trace:
            self.trace.instant("prefix_evict", args=dict(blocks=len(out)))
        return out

    # ---- host tier (demote instead of evict) -----------------------------
    def spillable(self, allocator) -> int:
        """Blocks the engine could demote now: device-resident nodes only
        the index references (refcount 1). The scheduler's tier-aware
        admission counts them as coverable capacity."""
        return sum(1 for nd in self._nodes.values()
                   if allocator.refcount(nd.block_id) == 1)

    def demote_candidate(self, allocator) -> Optional[_Node]:
        """The LRU device node eligible for demotion (refcount 1: mapped by
        no resident slot). Unlike `evict` it need not be a leaf: the node
        keeps its trie position, so surviving paths stay whole."""
        cands = [nd for nd in self._nodes.values()
                 if allocator.refcount(nd.block_id) == 1]
        return min(cands, key=lambda nd: nd.tick) if cands else None

    def mark_host(self, node: _Node, handle: int) -> None:
        """Device -> host: the node's block bytes were spilled under
        `handle`; the caller releases the index's block reference. The
        node stays in the trie, so a warm hit survives pool churn."""
        if node.host is not None or node.block_id is None:
            raise ValueError("mark_host of a node that is not on the device")
        del self._nodes[node.block_id]
        node.block_id = None
        node.host = handle
        self._host[handle] = node
        self.demoted += 1
        if self.trace:
            self.trace.instant("prefix_demote", args=dict(handle=handle))

    def promote(self, node: _Node, block_id: int) -> None:
        """Host -> device: the node's bytes were fetched into the freshly
        allocated `block_id` (the caller owns the fetch and hands the
        index its reference)."""
        if node.host is None:
            raise ValueError("promote of a node that is not on the host")
        del self._host[node.host]
        node.host = None
        node.block_id = int(block_id)
        self._nodes[node.block_id] = node
        self.promoted += 1
        if self.trace:
            self.trace.instant("prefix_promote",
                               args=dict(block=node.block_id))

    def host_handles(self) -> List[int]:
        """Every host-tier handle the index holds (audit input)."""
        return list(self._host)

    def drop_node(self, node: _Node) -> Tuple[List[int], List[int]]:
        """Remove `node` and its whole subtree from the trie (a fetch
        refusal killed its bytes). Returns (device block ids, host
        handles) of every removed node; the caller releases the ids and
        drops the tier entries."""
        self._unlink(node)
        ids: List[int] = []
        handles: List[int] = []
        stack = [node]
        while stack:
            nd = stack.pop()
            if nd.block_id is not None:
                if nd.block_id in self._nodes:
                    del self._nodes[nd.block_id]
                    ids.append(nd.block_id)
            elif nd.host is not None and nd.host in self._host:
                del self._host[nd.host]
                handles.append(nd.host)
            stack.extend(nd.children.values())
        self.evicted += len(ids) + len(handles)
        return ids, handles

    def disown(self, ids) -> List[int]:
        """Remove these blocks' nodes from the trie, with every descendant
        left unreachable. Returns each removed node's block id; the caller
        drops the index's reference on each through `release` (blocks a
        slot still maps survive at their remaining refcount). The
        copy-on-write pressure fallback: a slot that must un-share but
        cannot afford the copies gives up the index's claim on its blocks
        instead — legal exactly when no other resident slot maps them.
        Demoted descendants caught in the cascade surface their tier
        handles through `take_orphaned_handles`, for the engine to drop."""
        dropped: List[int] = []
        for bid in ids:
            node = self._nodes.get(int(bid))
            if node is None:
                continue
            self._unlink(node)
            stack = [node]
            while stack:
                nd = stack.pop()
                if nd.block_id is None:
                    if nd.host in self._host:
                        del self._host[nd.host]
                        self._orphaned.append(nd.host)
                    stack.extend(nd.children.values())
                    continue
                if nd.block_id not in self._nodes:
                    continue          # already removed through another id
                del self._nodes[nd.block_id]
                dropped.append(nd.block_id)
                stack.extend(nd.children.values())
        self.evicted += len(dropped)
        return dropped

    def take_orphaned_handles(self) -> List[int]:
        """Drain the tier handles that `disown` cascades orphaned."""
        out, self._orphaned = self._orphaned, []
        return out

    # ---- near-hit detection (CacheBlend routing) -------------------------
    def note_prompt(self, tokens) -> None:
        """Remember a full admitted prompt (bounded, FIFO) for near-hit
        detection."""
        arr = np.asarray(tokens)
        for p in self._recent:
            if p.shape == arr.shape and np.array_equal(p, arr):
                return
        self._recent.append(arr.copy())
        if len(self._recent) > self.max_recent:
            self._recent.pop(0)

    def near_overlap(self, tokens) -> float:
        """Highest positionwise token-equality fraction against any
        remembered prompt of the same length (0.0 when none): the near-hit
        signal — a high overlap with a short exact prefix is an edited
        middle, CacheBlend's case."""
        arr = np.asarray(tokens)
        best = 0.0
        for p in self._recent:
            if p.shape == arr.shape:
                best = max(best, float((p == arr).mean()))
        return best
