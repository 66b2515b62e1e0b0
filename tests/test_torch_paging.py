"""The port's paged block pool against the JAX package on the CPU
(`repro_torch.core.paging` against `repro.core.paging`): the allocator
and block-aware scheduler, paged append / insert / reset, the plain
version of the paged decode kernel against the Pallas kernel in
interpret mode, and `Engine(paged=True)` streams token-equal to the JAX
engine's. Integer leaves exact; float leaves within 1e-6 (the same
float32 quantization arithmetic on both sides, which may round a last
bit differently); attention outputs within 2e-5 (f32 summation order)."""
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
from repro.kernels.decode_qattn import kernel as jax_dq
from repro.nn import model as JM
from repro.serving import Engine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.bridge import paged_kv_from_numpy, params_from_numpy
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import cache as TC
from repro_torch.core import paging as TP
from repro_torch.core.policy import presets
from repro_torch.kernels.decode_qattn import ops as dq_ops
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request, Scheduler

F_ATOL = 1e-6
ATTN_TOL = 2e-5
_j_append = jax.jit(JC.append_token, static_argnums=(1,))
_j_accumulate = jax.jit(JC.accumulate_scores, static_argnums=(1,))


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def assert_paged_equal(t_p, j_p, what=""):
    """Every field equal; the port's pools minus their drop block."""
    for f in TP.PagedLayerKV._fields:
        got, want = _np(getattr(t_p, f)), np.asarray(getattr(j_p, f))
        if f in TP.POOL_FIELDS:
            axis = got.ndim - (3 if f.startswith("pv_") else 4)
            got = np.take(got, range(got.shape[axis] - 1), axis=axis)
        assert got.shape == want.shape, (what, f, got.shape, want.shape)
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=f"{what} {f}")
        else:
            np.testing.assert_allclose(got, want, atol=F_ATOL, rtol=0,
                                       err_msg=f"{what} {f}")


# ---------------------------------------------------------------------------
# BlockAllocator and the block-aware scheduler (tests/test_paging.py:23-55)
# ---------------------------------------------------------------------------


def test_allocator_alloc_free_reuse():
    a = TP.BlockAllocator(8)
    x = a.alloc(3)
    y = a.alloc(2)
    assert sorted(x + y) == list(range(5)) and a.used == 5
    a.free(x)
    assert a.available == 6
    z = a.alloc(6)                      # reuses the freed ids
    assert z is not None and a.available == 0
    assert sorted(y + z) == list(range(8))
    assert a.peak_used == 8
    # the same ids in the same order as the JAX allocator
    j = JP.BlockAllocator(8)
    assert [j.alloc(3), j.alloc(2)] == [x, y]


def test_allocator_exhaustion_is_all_or_nothing():
    a = TP.BlockAllocator(4)
    assert a.alloc(3) is not None
    before = a.available
    assert a.alloc(2) is None           # refused...
    assert a.available == before        # ...without partial grabs
    assert a.alloc(1) is not None


def test_allocator_rejects_foreign_and_double_free():
    a = TP.BlockAllocator(4)
    ids = a.alloc(2)
    a.free(ids)
    with pytest.raises(ValueError):
        a.free(ids)                     # double free
    with pytest.raises(ValueError):
        a.free([99])                    # never allocated


def test_scheduler_block_aware_admission_and_recycling():
    """Pool-exhausted admission refuses (the request stays queued); a
    retire frees the blocks and the same request admits."""
    alloc = TP.BlockAllocator(6)
    sched = Scheduler((8,), 2, allocator=alloc, block_need=lambda r: 4)
    r1, r2 = (Request(tokens=np.zeros(8, np.int32), max_new=4)
              for _ in range(2))
    sched.submit(r1)
    sched.submit(r2)
    assert sched.admit_next(0) is r1 and alloc.used == 4
    assert sched.admit_next(1) is None          # 2 free < 4 needed
    assert sched.pending == 1 and sched.note_retry() == 1
    sched.record_token(0, 1)
    sched.retire(0, "length")                   # frees r1's 4 blocks
    assert alloc.used == 0
    assert sched.admit_next(1) is r2            # retire-then-admit
    assert alloc.used == 4 and alloc.peak_used == 4
    assert TP.audit_pool(alloc, sched.occupied_blocks())["clean"]


def test_audit_catches_leaks_and_table_mismatch():
    alloc = TP.BlockAllocator(4)
    ids = alloc.alloc(2)
    assert TP.audit_pool(alloc, {0: ids})["clean"]
    with pytest.raises(TP.PoolAuditError, match="leak"):
        TP.audit_pool(alloc, {})
    tbl = np.full((2, 3, 2), -1, np.int32)      # [L, B, n_max]
    tbl[:, 0] = ids
    assert TP.audit_pool(alloc, {0: ids}, block_tbl=tbl)["clean"]
    tbl[1, 0, 1] = 3
    with pytest.raises(TP.PoolAuditError, match="diverge"):
        TP.audit_pool(alloc, {0: ids}, block_tbl=tbl)


# ---------------------------------------------------------------------------
# Substrate parity against JAX (tests/test_paging.py:95-180)
# ---------------------------------------------------------------------------

SPECS = [
    dict(budget=32, window=0, policy="streaming", bits=16, group=8,
         recent_protect=8),
    dict(budget=32, window=0, policy="h2o", bits=16, group=8,
         recent_protect=8),
    dict(budget=32, window=8, policy="streaming", bits=2, group=8),
    dict(budget=32, window=8, policy="h2o", bits=4, group=8,
         recent_protect=8),
]


def _paged_pair(kw, B=3, H=2, D=8, max_len=64, bl=8, extra=2, seed=0):
    """A JAX and a port paged cache with the same shuffled block table."""
    jspec, tspec = JC.CacheSpec(**kw), TC.CacheSpec(**kw)
    S = jspec.main_store_len(max_len)
    n_max = S // JP.resolve_block_len(jspec, S, bl)
    nb = B * n_max + extra
    jp = JP.init_paged_kv(jspec, B, max_len, H, D, n_blocks=nb,
                          block_len=bl, dtype=jnp.float32)
    ids = np.random.default_rng(seed).permutation(B * n_max).reshape(B, n_max)
    jp = jp._replace(block_tbl=jnp.asarray(ids, jnp.int32))
    tp = TP.init_paged_kv(tspec, B, max_len, H, D, n_blocks=nb,
                          block_len=bl, dtype=torch.float32)
    tp.block_tbl.copy_(torch.as_tensor(ids, dtype=torch.int32))
    return jspec, tspec, jp, tp, S


@pytest.mark.parametrize("kw", SPECS,
                         ids=lambda k: f"{k['policy']}-b{k['bits']}")
def test_paged_append_matches_jax(kw):
    """Appends past the budget (evictions, ring flushes into pool
    blocks), with score accumulation for h2o; the host ring mirror is
    not used (ring_full=None asks the device)."""
    jspec, tspec, jp, tp, S = _paged_pair(kw)
    B, H, D = 3, 2, 8
    rng = np.random.default_rng(1)
    for t in range(S + jspec.window + 6):
        kn = rng.standard_normal((B, H, D)).astype(np.float32)
        vn = rng.standard_normal((B, H, D)).astype(np.float32)
        jp = _j_append(jp, jspec, jnp.asarray(kn), jnp.asarray(vn))
        TC.append_token(tp, tspec, torch.tensor(kn), torch.tensor(vn))
        if jspec.track_scores():
            mass = np.abs(rng.standard_normal((B, S + jspec.window))
                          ).astype(np.float32)
            jp = _j_accumulate(jp, jspec, jnp.asarray(mass))
            TC.accumulate_scores(tp, tspec, torch.tensor(mass))
    assert_paged_equal(tp, jp, f"after {t + 1} appends")
    # the reference path's dense view: the same gather as JAX's
    jk, jv, jb = JC.materialize(jp, jspec, jnp.float32)
    tk, tv = TC.materialize_kv(tp, tspec, torch.float32)
    np.testing.assert_array_equal(TC.validity_bias(tp).numpy(),
                                  np.asarray(jb))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=F_ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=F_ATOL)


def test_paged_insert_reset_matches_jax():
    kw = dict(budget=16, window=8, policy="streaming", bits=2, group=8)
    jspec, tspec = JC.CacheSpec(**kw), TC.CacheSpec(**kw)
    B, H, D, max_len, bl, nL = 3, 2, 8, 32, 8, 2
    S = jspec.main_store_len(max_len)
    n_max = S // JP.resolve_block_len(jspec, S, bl)
    jpg = JP.stacked_paged_kv(jspec, nL, B, max_len, H, D,
                              n_blocks=B * n_max, block_len=bl,
                              dtype=jnp.float32)
    rng = np.random.default_rng(0)
    one = JC.init_layer_kv(jspec, 1, max_len, H, D, jnp.float32)
    SG = S // jspec.group
    kk = rng.integers(-128, 128, (1, S, H, one.k.shape[-1])).astype(np.int8)
    one = one._replace(
        k=jnp.asarray(kk), v=jnp.asarray(kk[::-1].copy()),
        k_scale=jnp.asarray(rng.uniform(size=(1, SG, H, D)), jnp.float32),
        k_zero=jnp.full((1, SG, H, D), 0.5),
        v_scale=jnp.full((1, S, H), 2.0), v_zero=jnp.zeros((1, S, H)),
        scores=jnp.asarray(rng.uniform(size=(1, S)), jnp.float32),
        slot_pos=jnp.arange(S, dtype=jnp.int32)[None],
        length=jnp.full((1,), S // 2, jnp.int32),
        pos=jnp.full((1,), S // 2, jnp.int32))
    pre = jax.tree.map(lambda x: jnp.broadcast_to(
        x[None], (nL, *x.shape)).copy(), one)
    tpre = TC.LayerKV(*(torch.tensor(np.asarray(x)) for x in pre))
    for ids in (np.arange(n_max, dtype=np.int32) + 1,
                np.asarray([4] + [-1] * (n_max - 1), np.int32)):  # partial
        j2 = JP.insert_request_paged(jpg, jnp.int32(1), pre,
                                     jnp.asarray(ids), batch_axis=1)
        t2 = TP.stacked_paged_kv(tspec, nL, B, max_len, H, D,
                                 n_blocks=B * n_max, block_len=bl,
                                 dtype=torch.float32)
        TP.insert_request_paged(t2, 1, tpre, torch.as_tensor(ids),
                                batch_axis=1)
        assert_paged_equal(t2, j2, f"insert {ids}")
        j3 = JP.reset_slot_paged(j2, jnp.int32(1), batch_axis=1)
        TP.reset_slot_paged(t2, 1, batch_axis=1)
        assert_paged_equal(t2, j3, "reset")


def test_paged_physical_bytes_matches_jax():
    kw = dict(budget=16, window=8, policy="streaming", bits=2, group=8)
    jpg = JP.stacked_paged_kv(JC.CacheSpec(**kw), 2, 3, 32, 2, 8,
                              n_blocks=6, block_len=8)
    tpg = TP.stacked_paged_kv(TC.CacheSpec(**kw), 2, 3, 32, 2, 8,
                              n_blocks=6, block_len=8)
    assert TC.cache_physical_bytes(tpg) == JC.cache_physical_bytes(jpg)
    jpg = jpg._replace(block_tbl=jpg.block_tbl.at[:, 0, 0].set(2))
    tpg.block_tbl[:, 0, 0] = 2
    assert TC.cache_physical_bytes(tpg) == JC.cache_physical_bytes(jpg)
    assert TP.bytes_per_block(tpg) == JP.bytes_per_block(jpg)


# ---------------------------------------------------------------------------
# B3's plain version against decode_attn_paged_pallas (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits,ring,mass", [(16, False, True),
                                            (16, True, False),
                                            (2, True, True)],
                         ids=["dense", "dense-ring", "kivi2"])
def test_paged_decode_plain_matches_pallas(bits, ring, mass):
    """Shuffled block ids, -1 tails and one free slot (every entry -1,
    every key masked: the uniform softmax)."""
    rng = np.random.default_rng(bits)
    B, Hq, Hkv, D, n_max = 3, 4, 2, 32, 4
    G = bl = 8
    W = 8 if ring else 0
    nb = B * n_max + 2
    tbl = rng.permutation(nb)[:B * n_max].reshape(B, n_max).astype(np.int32)
    length = np.asarray([n_max * bl, 11, 0])
    tbl[1, 2:] = -1
    tbl[2] = -1
    if bits < 16:
        Dp = D * bits // 8
        pk, pv = (rng.integers(-128, 128, (nb, bl, Hkv, Dp)).astype(np.int8)
                  for _ in range(2))
        meta = [rng.uniform(0.01, 0.1, s).astype(np.float32)
                for s in ((nb, bl // G, Hkv, D),) * 2 + ((nb, bl, Hkv),) * 2]
        meta[1] -= 0.05
        meta[3] -= 0.05
    else:
        pk, pv = (rng.standard_normal((nb, bl, Hkv, D)).astype(np.float32)
                  for _ in range(2))
        meta = [None] * 4
    bias = np.where(np.arange(n_max * bl)[None] < length[:, None], 0.0,
                    -1e30).astype(np.float32)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    if ring:
        rk, rv = (rng.standard_normal((B, W, Hkv, D)).astype(np.float32)
                  for _ in range(2))
        rbias = np.where(np.arange(W)[None] < np.asarray([W, 3, 0])[:, None],
                         0.0, -1e30).astype(np.float32)
    else:
        rk = rv = rbias = None
    args = [q, tbl, pk, meta[0], meta[1], pv, meta[2], meta[3], bias, rk, rv,
            rbias]
    kw = dict(bits=bits, group=G, return_mass=mass)
    j_out, j_mass = jax_dq.decode_attn_paged_pallas(
        *(None if a is None else jnp.asarray(a) for a in args),
        compute_dtype=jnp.float32, interpret=True, **kw)
    # the port's pools carry the drop block: append one (never read)
    targs = [None if a is None else torch.tensor(a) for a in args]
    for i in (2, 3, 4, 5, 6, 7):
        if targs[i] is not None:
            targs[i] = torch.cat([targs[i], torch.zeros_like(targs[i][:1])])
    t_out, t_mass = dq_ops.decode_attention_paged(*targs, **kw)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out),
                               atol=ATTN_TOL, rtol=ATTN_TOL)
    if mass:
        np.testing.assert_allclose(t_mass.numpy(), np.asarray(j_mass),
                                   atol=ATTN_TOL, rtol=ATTN_TOL)
    else:
        assert t_mass is None


def test_paged_decode_attention_dispatch_matches_jax():
    """`nn.attention.decode_attention` on a lived-in paged cache (through
    the bridge): the kernel path's plain version and the gather
    reference path against the JAX package's paged kernel path."""
    from repro.nn import attention as JA
    from repro_torch.nn import attention as TA
    kw = dict(budget=32, window=8, policy="h2o", bits=2, group=8,
              recent_protect=8)
    jspec, tspec, jp, _, S = _paged_pair(kw, D=16)
    rng = np.random.default_rng(5)
    for _ in range(S + 13):
        jp = _j_append(jp, jspec,
                       *(jnp.asarray(rng.standard_normal((3, 2, 16)),
                                     jnp.float32) for _ in range(2)))
    tp = paged_kv_from_numpy(jax.tree.map(np.asarray, jp))
    q = rng.standard_normal((3, 1, 4, 16)).astype(np.float32)
    want = JA.decode_attention(jnp.asarray(q), jp, jspec, dtype=jnp.float32,
                               use_kernels=True, interpret=True)
    for uk in (True, False):
        got = TA.decode_attention(torch.tensor(q), tp, tspec,
                                  dtype=torch.float32, use_kernels=uk)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       atol=ATTN_TOL, rtol=ATTN_TOL)


# ---------------------------------------------------------------------------
# Engine(paged=True) against the JAX engine (tests/test_paging.py:266-320)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_model():
    jcfg = jax_reduced(jax_get_config("paper-llama-7b"), num_layers=2)
    cfg = reduced(get_config("paper-llama-7b"))
    jp = JM.init_params(jax.random.key(0), jcfg)
    return jcfg, jp, cfg, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            cfg)


def _both(small_model, pname, reqs, **kw):
    """Run the same requests through the JAX engine and the port's (same
    options, kernels' plain versions on the port side)."""
    jcfg, jp, cfg, p = small_model
    jeng = JaxEngine(jcfg, jp, jax_presets(32, 8)[pname], seed=0,
                     use_kernels=False, **kw)
    teng = Engine(cfg, p, presets(32, 8)[pname], device="cpu", **kw)
    want = jeng.generate_continuous(
        [JaxRequest(tokens=t, max_new=m) for t, m in reqs])
    got = teng.generate_continuous(
        [Request(tokens=t, max_new=m) for t, m in reqs])
    assert [r.finish_reason for r in got.results] == \
        [r.finish_reason for r in want.results]
    for g, w in zip(got.results, want.results):
        np.testing.assert_array_equal(g.tokens, w.tokens)
    assert teng.last_audit is not None and teng.last_audit["clean"]
    assert got.pool_peak_blocks == want.pool_peak_blocks
    assert got.cache_physical_bytes == want.cache_physical_bytes
    assert got.paged_bytes_per_seq(2) == want.paged_bytes_per_seq(2)
    return teng, got


def test_continuous_paged_h2o_equals_jax(small_model):
    cfg = small_model[2]
    rng = np.random.default_rng(2)
    reqs = [(rng.integers(0, cfg.vocab_size, size=(16, 32)[i % 2])
             .astype(np.int32), int(rng.integers(3, 7))) for i in range(5)]
    _, res = _both(small_model, "h2o", reqs, max_new=6, slots=2,
                   buckets=(16, 32), paged=True, block_len=8)
    assert res.pool_blocks == 2 * (32 // 8)     # parity: 2 slots x S/bl


def test_paged_pool_exhaustion_recycles(small_model):
    """A pool sized for one request (5 blocks of 8 rows each; the pool
    holds 6) serializes decode but serves everything, within the pool."""
    cfg = small_model[2]
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, cfg.vocab_size, size=32).astype(np.int32), 4)
            for _ in range(4)]
    _, res = _both(small_model, "full", reqs, prompt_len=32, max_new=8,
                   slots=3, buckets=(32,), paged=True, block_len=8,
                   pool_blocks=6)
    assert all(r.n_tokens == 4 for r in res.results)
    assert res.pool_peak_blocks <= 6
    assert res.occupancy <= 1 / 3 + 1e-6        # serialized co-residency


def test_paged_pool_too_small_fails_request(small_model):
    _, res = _both(small_model, "full", [(np.zeros(32, np.int32), 4)],
                   prompt_len=32, max_new=8, slots=2, buckets=(32,),
                   paged=True, block_len=8, pool_blocks=2)
    (r,) = res.results
    assert r.finish_reason == "failed" and r.n_tokens == 0 and r.slot == -1
    assert res.failed() == [r]
