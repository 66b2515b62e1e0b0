"""The port's prefix cache against the JAX package on the CPU (the cases of
tests/test_prefix.py): the allocator's refcounts, the scheduler's adopt /
copy-on-write / reclaim seams, the radix index (each run beside the JAX
package's own objects on the same operations), the paged pool's shared
blocks, `n_skip` insert and block copy, and the serving contract —
greedy streams with sharing on equal the JAX engine's with sharing on
and the port's with sharing off, with the JAX engine's prefix counters
(warm / cold / near-hit admissions, copy-on-write copies, indexed and
evicted blocks). f32 throughout; streams and counters exact, pool rows
bit-equal."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny shapes; JAX's threads share the cores

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.core import cache as JC
from repro.core import paging as JP
from repro.core.policy import presets as jax_presets
from repro.nn import model as JM
from repro.serving import Engine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving.prefix import PrefixIndex as JaxPrefixIndex
from repro.serving.scheduler import Scheduler as JaxScheduler
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import cache as C
from repro_torch.core import paging as P
from repro_torch.core.cache import CacheSpec
from repro_torch.core.policy import presets
from repro_torch.serving.engine import Engine
from repro_torch.serving.prefix import PrefixIndex
from repro_torch.serving.scheduler import Request, Scheduler

COUNTERS = ("warm_hits", "cold", "near_hits", "cow_copies",
            "ingested_blocks", "evicted_blocks", "index_blocks")


@pytest.fixture(scope="module")
def small_model():
    jcfg = jax_reduced(jax_get_config("paper-llama-7b"), num_layers=2)
    cfg = reduced(get_config("paper-llama-7b"))
    jp = JM.init_params(jax.random.key(0), jcfg)
    return jcfg, jp, cfg, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            cfg)


# ---------------------------------------------------------------------------
# BlockAllocator refcounts (each case on both allocators)
# ---------------------------------------------------------------------------

ALLOCATORS = [P.BlockAllocator, JP.BlockAllocator]
ALLOC_IDS = ["port", "jax"]


@pytest.mark.parametrize("Alloc", ALLOCATORS, ids=ALLOC_IDS)
def test_refcount_lifecycle(Alloc):
    a = Alloc(4)
    ids = a.alloc(2)
    assert all(a.refcount(i) == 1 for i in ids)
    a.incref(ids)                       # second owner (the prefix index)
    assert all(a.refcount(i) == 2 for i in ids)
    a.free(ids)                         # first owner drops: still held
    assert all(a.refcount(i) == 1 for i in ids)
    assert a.available == 2
    a.free(ids)                         # last owner drops: recycled
    assert a.available == 4
    assert all(a.refcount(i) == 0 for i in ids)


@pytest.mark.parametrize("Alloc", ALLOCATORS, ids=ALLOC_IDS)
def test_refcount_free_past_zero_raises(Alloc):
    a = Alloc(2)
    ids = a.alloc(1)
    a.free(ids)
    with pytest.raises(ValueError):
        a.free(ids)


@pytest.mark.parametrize("Alloc", ALLOCATORS, ids=ALLOC_IDS)
def test_refcount_incref_unallocated_raises(Alloc):
    with pytest.raises(ValueError):
        Alloc(2).incref([0])


def test_exhaustion_with_lingering_refs():
    """Blocks only the index holds still occupy the pool; the two
    allocators agree on every step."""
    out = []
    for Alloc in ALLOCATORS:
        a = Alloc(4)
        ids = a.alloc(4)
        a.incref(ids)                   # index reference
        a.free(ids)                     # slot retires
        steps = [a.available, a.alloc(1)]
        a.free(ids[:2])                 # index evicts two
        steps += [a.alloc(2), a.alloc(1), a.available, a.refcounts()]
        out.append(steps)
    assert out[0] == out[1]
    assert out[0][:2] == [0, None] and out[0][3] is None


# ---------------------------------------------------------------------------
# Scheduler: adopt / cow_swap / reclaim, beside the JAX scheduler
# ---------------------------------------------------------------------------


def _mini(pool=8, need=4, jax_side=False):
    Alloc, Sched, Req = ((JP.BlockAllocator, JaxScheduler, JaxRequest)
                         if jax_side else
                         (P.BlockAllocator, Scheduler, Request))
    alloc = Alloc(pool)
    sched = Sched((8,), 2, allocator=alloc, block_need=lambda r: need)
    sched.submit(Req(tokens=np.zeros(8, np.int32), max_new=4))
    return alloc, sched


@pytest.mark.parametrize("jax_side", [False, True], ids=ALLOC_IDS)
def test_adopt_and_cow_swap(jax_side):
    alloc, sched = _mini(jax_side=jax_side)
    index_ids = alloc.alloc(2)          # the index's blocks
    sched.begin_prefill(0)
    sched.adopt_blocks(0, index_ids)    # read-only mapping: +1 ref each
    assert all(alloc.refcount(i) == 2 for i in index_ids)
    assert sched.grant_blocks(0, 2)     # owned suffix
    old, new = sched.cow_swap(0, 2)
    assert old == index_ids
    assert all(alloc.refcount(i) == 1 for i in old)    # index keeps its ref
    assert sched.slot_blocks(0)[:2] == new
    sched.finish_prefill(0)
    sched.record_token(0, 1)
    sched.retire(0, "length")
    assert all(alloc.refcount(i) == 1 for i in index_ids)
    assert alloc.available == 6


def test_cow_swap_refuses_when_pool_exhausted():
    for jax_side in (False, True):
        alloc, sched = _mini(pool=4, jax_side=jax_side)
        index_ids = alloc.alloc(2)
        sched.begin_prefill(0)
        sched.adopt_blocks(0, index_ids)
        assert sched.grant_blocks(0, 2)     # pool now empty
        assert sched.cow_swap(0, 2) is None
        assert sched.slot_blocks(0)[:2] == index_ids


def test_reclaim_hook_retries_allocation():
    for jax_side in (False, True):
        alloc, sched = _mini(pool=4, need=2, jax_side=jax_side)
        lingering = alloc.alloc(3)      # index-only blocks fill the pool
        shortfalls = []

        def reclaim(n):
            shortfalls.append(n)
            alloc.free(lingering[:2])

        sched.reclaim = reclaim
        assert sched.admit_next(0) is not None
        assert shortfalls == [1]


# ---------------------------------------------------------------------------
# PrefixIndex, each sequence of operations beside the JAX index
# ---------------------------------------------------------------------------


def _toks(*blocks):
    return np.concatenate([np.full(4, b, np.int32) for b in blocks])


def _both(fn):
    """Run `fn(Index, Alloc)` on the port's and the JAX package's classes;
    the two must return the same."""
    got = fn(PrefixIndex, P.BlockAllocator)
    want = fn(JaxPrefixIndex, JP.BlockAllocator)
    assert got == want
    return got


def test_index_match_ingest_evict():
    def run(Index, Alloc):
        a = Alloc(16)
        idx = Index(4)
        ids1 = a.alloc(3)
        out = [idx.ingest(_toks(1, 2, 3), ids1, [("p", b) for b in
                                                 range(3)], a)]
        out.append([a.refcount(i) for i in ids1])
        out.append(idx.match(_toks(1, 2, 9)))
        out.append(idx.match(_toks(9, 9, 9))[0])
        ids2 = a.alloc(3)
        out.append(idx.ingest(_toks(1, 2, 7), ids2,
                              [("q", b) for b in range(3)], a))
        out.append(a.refcount(ids2[0]))
        a.free(ids1)
        a.free(ids2)
        out.append(len(idx))
        freed = idx.evict(10, a)
        out += [sorted(freed), len(idx)]
        a.free(freed)
        out.append(a.available)
        return out

    out = _both(run)
    assert out[0] == 3 and out[4] == 1 and out[6] == 4 and out[-1] == 16


def test_index_evict_skips_blocks_mapped_by_slots():
    def run(Index, Alloc):
        a = Alloc(8)
        idx = Index(4)
        ids = a.alloc(2)
        idx.ingest(_toks(1, 2), ids, [None, None], a)
        held = idx.evict(2, a)          # a slot still maps both
        a.free(ids)                     # slot retires
        return held, sorted(idx.evict(2, a)), sorted(ids)

    held, freed, ids = _both(run)
    assert held == [] and freed == ids


def test_index_disown_cascades_to_unreachable_children():
    def run(Index, Alloc):
        a = Alloc(8)
        idx = Index(4)
        ids = a.alloc(3)
        idx.ingest(_toks(1, 2, 3), ids, [None] * 3, a)
        dropped = idx.disown(ids[1:2])
        return sorted(dropped), len(idx), idx.match(_toks(1, 2, 3))[0], ids

    dropped, n, match, ids = _both(run)
    assert dropped == sorted(ids[1:]) and n == 1 and match == ids[:1]


def test_index_near_overlap():
    def run(Index, Alloc):
        idx = Index(4, max_recent=2)
        base = np.arange(16, dtype=np.int32)
        idx.note_prompt(base)
        edited = base.copy()
        edited[5] = 99
        out = [idx.near_overlap(edited),
               idx.near_overlap(np.arange(8, dtype=np.int32))]
        idx.note_prompt(base)           # dedup: still one entry
        return out + [len(idx._recent)]

    assert _both(run) == [pytest.approx(15 / 16), 0.0, 1]


# ---------------------------------------------------------------------------
# Paged device ops: multi-mapped blocks, metadata-only insert, block copy
# ---------------------------------------------------------------------------


def _one_request(spec, max_len, H, D, seed):
    """A dense batch-1 cache holding S random rows, as numpy (JAX layout,
    one leading layer dim) for both packages."""
    S = spec.main_store_len(max_len)
    one = jax.tree.map(np.asarray, JC.init_layer_kv(spec, 1, max_len, H, D,
                                                   jnp.float32))
    kk = np.random.default_rng(seed).standard_normal(
        (1, S, H, D)).astype(np.float32)
    one = one._replace(k=kk.astype(one.k.dtype), v=(kk * 2).astype(one.v.dtype),
                       scores=np.abs(kk[..., 0, 0]),
                       slot_pos=np.arange(S, dtype=np.int32)[None],
                       length=np.full((1,), S, np.int32),
                       pos=np.full((1,), S, np.int32))
    return jax.tree.map(lambda x: x[None].copy(), one)


SPEC_ARGS = dict(budget=16, window=0, policy="streaming", bits=16, group=8,
                 recent_protect=8)


def test_shared_blocks_gather_identically_and_copy_preserves():
    """Two slots mapping the same blocks (`pool_write=False` maps without
    writing) gather identical rows; `copy_pool_blocks` then clones the
    rows, so a table rewrite to the copies gathers the same bits. The
    port's pools equal the JAX package's after each step (its drop block
    aside)."""
    jspec, spec = JC.CacheSpec(**SPEC_ARGS), CacheSpec(**SPEC_ARGS)
    B, H, D, max_len, bl = 2, 2, 8, 16, 8
    n_max = spec.main_store_len(max_len) // bl
    pre = _one_request(jspec, max_len, H, D, 0)
    jpg = JP.stacked_paged_kv(jspec, 1, B, max_len, H, D,
                              n_blocks=2 * n_max + 2, block_len=bl,
                              dtype=jnp.float32)
    pg = P.stacked_paged_kv(spec, 1, B, max_len, H, D,
                            n_blocks=2 * n_max + 2, block_len=bl,
                            dtype=torch.float32)
    jpre = jax.tree.map(jnp.asarray, pre)._replace(budget=jpg.budget)
    tpre = C.LayerKV(*(torch.tensor(x) for x in pre))
    ids = np.arange(n_max, dtype=np.int32)
    for slot, write in ((0, True), (1, False)):
        jpg = JP.insert_request_paged(jpg, jnp.int32(slot), jpre,
                                      jnp.asarray(ids), batch_axis=1,
                                      pool_write=write)
        before = pg.pk.clone()
        P.insert_request_paged(pg, slot, tpre, torch.tensor(ids),
                               batch_axis=1, pool_write=write)
        if not write:
            assert torch.equal(before, pg.pk)
    np.testing.assert_array_equal(pg.pk[:, :-1].numpy(), np.asarray(jpg.pk))
    g = P.gather_dense(C.layer_view(pg, 0), spec)
    assert torch.equal(g.k[0], g.k[1]) and torch.equal(g.v[0], g.v[1])
    dst = ids + n_max
    jpg = JP.copy_pool_blocks(jpg, jnp.asarray(ids), jnp.asarray(dst),
                              batch_axis=1)
    P.copy_pool_blocks(pg, torch.tensor(ids, dtype=torch.int64),
                       torch.tensor(dst, dtype=torch.int64), batch_axis=1)
    P.write_block_table(pg, 1, 0, torch.tensor(dst), batch_axis=1)
    np.testing.assert_array_equal(pg.pk[:, :-1].numpy(), np.asarray(jpg.pk))
    np.testing.assert_array_equal(pg.pv[:, :-1].numpy(), np.asarray(jpg.pv))
    g2 = P.gather_dense(C.layer_view(pg, 0), spec)
    assert torch.equal(g.k[1], g2.k[1]) and torch.equal(g.v[1], g2.v[1])
    # unmapping a table tail: the rows stop routing into those blocks
    P.clear_block_table_from(pg, 1, 1, batch_axis=1)
    assert pg.block_tbl[0, 1].tolist() == [int(dst[0])] + [-1] * (
        pg.block_tbl.shape[-1] - 1)


def test_insert_n_skip_leaves_leading_blocks_untouched():
    jspec, spec = JC.CacheSpec(**SPEC_ARGS), CacheSpec(**SPEC_ARGS)
    H, D, max_len, bl = 2, 8, 16, 8
    n_max = spec.main_store_len(max_len) // bl
    pre = _one_request(jspec, max_len, H, D, 1)
    jpg = JP.stacked_paged_kv(jspec, 1, 1, max_len, H, D, n_blocks=n_max,
                              block_len=bl, dtype=jnp.float32)
    pg = P.stacked_paged_kv(spec, 1, 1, max_len, H, D, n_blocks=n_max,
                            block_len=bl, dtype=torch.float32)
    ids = np.arange(n_max, dtype=np.int32)
    before = pg.pk.clone()
    P.insert_request_paged(pg, 0, C.LayerKV(*(torch.tensor(x) for x in pre)),
                           torch.tensor(ids), batch_axis=1, n_skip=1)
    jpg = JP.insert_request_paged(
        jpg, jnp.int32(0),
        jax.tree.map(jnp.asarray, pre)._replace(budget=jpg.budget),
        jnp.asarray(ids), batch_axis=1, n_skip=1)
    assert torch.equal(before[:, 0], pg.pk[:, 0])             # skipped
    assert not torch.equal(before[:, 1], pg.pk[:, 1])         # written
    np.testing.assert_array_equal(pg.pk[:, :-1].numpy(), np.asarray(jpg.pk))
    assert pg.block_tbl[0, 0, :n_max].tolist() == ids.tolist()


# ---------------------------------------------------------------------------
# Serving contract: sharing on == sharing off == the JAX engine, bit for bit
# ---------------------------------------------------------------------------


def _templated_prompts(cfg, n, L, seed=1, shared_frac=0.5):
    rng = np.random.default_rng(seed)
    m = int(L * shared_frac)
    shared = rng.integers(0, cfg.vocab_size, size=m).astype(np.int32)
    return [np.concatenate([shared, rng.integers(
        0, cfg.vocab_size, size=L - m).astype(np.int32)]) for _ in range(n)]


def _run(model, pname, *, share, jax_side=False, chunked=False, near=0.0,
         L=64, new=16, slots=2, prompts=None, use_kernels=None,
         pool_blocks=None):
    jcfg, jp, cfg, p = model
    kw = dict(prompt_len=L, max_new=new, slots=slots, paged=True,
              block_len=8, chunked_prefill=chunked, chunk_len=16,
              prefix_sharing=share, near_hit=near if share else 0.0,
              use_kernels=use_kernels, pool_blocks=pool_blocks)
    if jax_side:
        eng = JaxEngine(jcfg, jp, jax_presets(budget=64, window=8)[pname],
                        **kw)
        R = JaxRequest
    else:
        eng = Engine(cfg, p, presets(budget=64, window=8)[pname],
                     device="cpu", **kw)
        R = Request
    res = eng.generate_continuous([R(tokens=t, max_new=new)
                                   for t in prompts])
    # teardown audit: refcounts vs slot tables vs the prefix index
    assert eng.last_audit is not None and eng.last_audit["clean"]
    return res


def _assert_equal(got, want, label):
    assert len(got.results) == len(want.results)
    for a, b in zip(got.results, want.results):
        np.testing.assert_array_equal(a.tokens, b.tokens, err_msg=label)
        assert a.finish_reason == b.finish_reason


def _assert_counters(got, want):
    assert {k: got.prefix[k] for k in COUNTERS} == \
        {k: want.prefix[k] for k in COUNTERS}


# verbatim dense policy on monolithic admission; quantized streaming
# policy through the chunked machinery (copy-on-write fires)
FAST_GRID = [("full", False), ("kivi2", True)]
FULL_GRID = [(p, c) for p in ("full", "kivi2") for c in (False, True)]


@pytest.mark.parametrize("pname,chunked", FAST_GRID, ids=lambda v: str(v))
def test_sharing_streams_identical(small_model, pname, chunked):
    prompts = _templated_prompts(small_model[2], 6, 64)
    kw = dict(chunked=chunked, prompts=prompts)
    off = _run(small_model, pname, share=False, **kw)
    on = _run(small_model, pname, share=True, **kw)
    want = _run(small_model, pname, share=True, jax_side=True, **kw)
    _assert_equal(on, off, f"{pname}/chunked={chunked}: sharing")
    _assert_equal(on, want, f"{pname}/chunked={chunked}: vs JAX")
    _assert_counters(on, want)
    assert on.prefix["warm_hits"] >= 3
    assert on.prefix["ingested_blocks"] > 0
    assert on.pool_peak_blocks == want.pool_peak_blocks
    if pname == "kivi2":
        # evict-at-cap flushes force un-sharing mid-decode
        assert on.prefix["cow_copies"] >= 1


@pytest.mark.parametrize("pname,chunked", FULL_GRID, ids=lambda v: str(v))
def test_sharing_streams_identical_full_grid(small_model, pname, chunked):
    prompts = _templated_prompts(small_model[2], 6, 64)
    off = _run(small_model, pname, share=False, chunked=chunked,
               prompts=prompts)
    on = _run(small_model, pname, share=True, chunked=chunked,
              prompts=prompts)
    _assert_equal(on, off, f"{pname}/chunked={chunked}")
    assert on.prefix["warm_hits"] >= 3


def test_sharing_streams_identical_reference_path(small_model):
    """The materialize / matmul reference path (`use_kernels=False`)
    over shared block tables, against the JAX engine's (the other tests
    run the kernels' plain versions, the port's default)."""
    prompts = _templated_prompts(small_model[2], 4, 64)
    kw = dict(prompts=prompts, use_kernels=False, new=8)
    off = _run(small_model, "kivi2", share=False, chunked=True, **kw)
    on = _run(small_model, "kivi2", share=True, chunked=True, **kw)
    want = _run(small_model, "kivi2", share=True, chunked=True,
                jax_side=True, **kw)
    _assert_equal(on, off, "reference path")
    _assert_equal(on, want, "reference path vs JAX")
    assert on.prefix["warm_hits"] >= 2


def test_sharing_under_pool_pressure(small_model):
    """A pool sized for the resident slots alone forces lingering index
    blocks out through the reclaim hook; streams still match sharing off
    on the same pool, and the JAX engine's counters."""
    prompts = _templated_prompts(small_model[2], 6, 64)
    pool = 2 * ((64 + 16) // 8)         # exactly two full grants
    off = _run(small_model, "full", share=False, prompts=prompts,
               pool_blocks=pool)
    on = _run(small_model, "full", share=True, prompts=prompts,
              pool_blocks=pool)
    want = _run(small_model, "full", share=True, prompts=prompts,
                pool_blocks=pool, jax_side=True)
    _assert_equal(on, off, "pool pressure")
    _assert_counters(on, want)
    assert on.prefix["evicted_blocks"] > 0
    assert on.prefix["warm_hits"] >= 1


def test_sharing_with_lazy_growth_is_refused(small_model):
    """Lazy block growth is not ported (ROADMAP A10): asking for it with
    sharing raises, as it does without."""
    cfg, p = small_model[2], small_model[3]
    with pytest.raises(NotImplementedError, match="not yet ported"):
        Engine(cfg, p, presets(budget=64, window=8)["full"], prompt_len=64,
               max_new=4, paged=True, prefix_sharing=True,
               block_growth="lazy", device="cpu")


def test_score_policy_refuses_sharing(small_model):
    """h2o orders rows by data: the index never matches or ingests, and
    streams are untouched."""
    prompts = _templated_prompts(small_model[2], 4, 64)
    off = _run(small_model, "h2o", share=False, prompts=prompts, new=8)
    on = _run(small_model, "h2o", share=True, prompts=prompts, new=8)
    _assert_equal(on, off, "h2o refuses")
    assert on.prefix["warm_hits"] == 0
    assert on.prefix["ingested_blocks"] == 0


def test_direct_insert_parity(small_model):
    """Prefill-direct (verbatim policy, chunked): segment rows straight
    into pool blocks + metadata-only insert == the monolithic insert."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, small_model[2].vocab_size,
                            size=64).astype(np.int32) for _ in range(4)]
    mono = _run(small_model, "full", share=False, chunked=False,
                prompts=prompts, new=8)
    direct = _run(small_model, "full", share=False, chunked=True,
                  prompts=prompts, new=8)
    _assert_equal(direct, mono, "prefill-direct")


def _edited_pair(cfg):
    rng = np.random.default_rng(5)
    base = rng.integers(0, cfg.vocab_size, size=64).astype(np.int32)
    edited = base.copy()
    edited[8:12] = rng.integers(0, cfg.vocab_size, size=4)
    return [base, edited]


def test_near_hit_blend_exact_at_full_recompute(small_model):
    """recompute fraction 1.0: CacheBlend recomputes every token, so the
    blended cache is exact and streams equal sharing off (and the JAX
    engine's near-hit run)."""
    prompts = _edited_pair(small_model[2])
    off = _run(small_model, "full", share=False, prompts=prompts, new=8)
    on = _run(small_model, "full", share=True, near=1.0, prompts=prompts,
              new=8)
    want = _run(small_model, "full", share=True, near=1.0, prompts=prompts,
                new=8, jax_side=True)
    _assert_equal(on, off, "near-hit frac=1.0")
    _assert_equal(on, want, "near-hit frac=1.0 vs JAX")
    _assert_counters(on, want)
    assert on.prefix["near_hits"] == 1


def test_near_hit_blend_approx_smoke(small_model):
    """Below 1 the blend is approximate by design: the near-hit is
    detected, the blended request emits max_new tokens, and the
    counters equal the JAX engine's."""
    prompts = _edited_pair(small_model[2])
    on = _run(small_model, "full", share=True, near=0.25, prompts=prompts,
              new=8)
    want = _run(small_model, "full", share=True, near=0.25, prompts=prompts,
                new=8, jax_side=True)
    assert on.prefix["near_hits"] == 1
    _assert_counters(on, want)
    assert all(r.finish_reason == "length" for r in on.results)
    assert all(r.n_tokens == 8 for r in on.results)


def test_ctor_validations(small_model):
    cfg, p = small_model[2], small_model[3]
    pol = presets(budget=32, window=8)["full"]
    kw = dict(prompt_len=64, max_new=4, device="cpu")
    with pytest.raises(ValueError, match="requires paged"):
        Engine(cfg, p, pol, prefix_sharing=True, **kw)
    with pytest.raises(ValueError, match="near_hit requires"):
        Engine(cfg, p, pol, paged=True, near_hit=0.5, **kw)
    with pytest.raises(ValueError, match="recompute fraction"):
        Engine(cfg, p, pol, paged=True, prefix_sharing=True, near_hit=1.5,
               **kw)
    with pytest.raises(ValueError, match="speculative"):
        Engine(cfg, p, pol, paged=True, prefix_sharing=True,
               speculative=True, **kw)
