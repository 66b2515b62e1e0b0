"""The port's host-RAM KV tier and pressure-driven degradation against
the JAX package on the CPU.

  * `HostTier` (the cases of tests/test_tiering.py:45-184): the same call
    sequence under the same `FaultPlan` gives the same handles, census,
    payload bytes and `stats` in both packages, and `audit_pool`'s host
    census reports the same violations;
  * `gather_pool_blocks` / `scatter_pool_blocks` / `gather_slot_meta` /
    `scatter_slot_meta` and `degrade_slot_groups` equal the JAX functions
    on the same random paged caches (the port's drop block stripped),
    bit for bit;
  * end to end (reduced paper-llama-7b, 2 layers, f32, the same weights
    through `repro_torch.bridge`): with tiering, forced preemptions spill
    to host and restore; with degradation, resident kivi2 slots drop
    groups under pressure. Streams, finish reasons, preemption counts,
    decode steps, the `tier` counts and bytes and the degrade counts
    equal the JAX engine's (tests/test_tiering.py:221-355,
    tests/test_faults.py:299-431), and every audit, host census
    included, is clean.
"""
import dataclasses

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
from repro_torch.bridge import paged_kv_from_numpy, params_from_numpy
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import cache as TC
from repro_torch.core import paging as TP
from repro_torch.core.policy import presets
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request

BUDGET, WINDOW = 32, 8


# ---------------------------------------------------------------------------
# HostTier: spill / drain / fetch on bare payload trees, both packages
# ---------------------------------------------------------------------------

def _to_jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _to_torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


PACKAGES = {"jax": (JP, _to_jax), "port": (TP, _to_torch)}


def _both(fn, *args):
    """`fn((paging module, payload converter), *args)` for both packages;
    the observations must be equal. Returns the port's."""
    got = {k: fn(v, *args) for k, v in PACKAGES.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def _payload(seed=0, shape=(2, 8, 4, 16)):
    rng = np.random.default_rng(seed)
    return dict(pk=rng.standard_normal(shape).astype(np.float32),
                pv=rng.standard_normal(shape).astype(np.float32))


def _spill(pkg, tier, seed=0, n=1):
    return tier.begin_spill(pkg[1](_payload(seed)), n)


def _host(tree) -> dict:
    return {k: np.array(v) for k, v in tree.items()}


def _corrupt(tier, h, field):
    """Flip one element of a resident entry's payload (a tampered copy
    swapped in, as the JAX package's test does)."""
    e = tier._entries[h]
    if isinstance(e.payload[field], torch.Tensor):
        bad = {k: v.clone() for k, v in e.payload.items()}
        bad[field].view(-1)[0] += 1.0
    else:
        bad = {k: np.array(v) for k, v in e.payload.items()}
        bad[field].flat[0] += 1.0
    tier._entries[h] = e._replace(payload=bad)


def test_host_tier_roundtrip_bit_identical():
    def run(pkg):
        P = pkg[0]
        tier = P.HostTier(4)
        h = _spill(pkg, tier, n=2)
        out = [h, tier.in_flight_blocks, tier.resident_blocks, tier.drain(),
               tier.resident_blocks, tier.free_blocks]
        got, nbytes, stall = tier.fetch(h)
        got = _host(got)
        want = _payload()
        out += [all(np.array_equal(got[k], want[k]) for k in want), nbytes,
                tier.used_blocks, dict(tier.stats)]
        return out
    out = _both(run)
    assert out[:6] == [0, 2, 0, 1, 2, 2] and out[6]
    assert out[7] == sum(v.nbytes for v in _payload().values())
    assert out[9]["spills"] == out[9]["fetches"] == 1


def test_host_tier_fetch_before_drain_drains_on_demand():
    def run(pkg):
        tier = pkg[0].HostTier(2)
        h = _spill(pkg, tier)
        got, _, stall = tier.fetch(h)        # no drain() in between
        st = dict(tier.stats)
        return (np.array_equal(_host(got)["pk"], _payload()["pk"]),
                stall >= 0.0, st["fetch_stall_s"] >= stall,
                {k: v for k, v in st.items() if k != "fetch_stall_s"})
    assert _both(run)[:3] == (True, True, True)


def test_host_tier_prefetch_hides_the_stall():
    def run(pkg):
        tier = pkg[0].HostTier(2)
        h = _spill(pkg, tier)
        tier.prefetch(h)
        resident = tier.resident_blocks
        return resident, tier.fetch(h)[2], dict(tier.stats)
    assert _both(run)[:2] == (1, 0.0)


def test_host_tier_capacity_refusal():
    def run(pkg):
        tier = pkg[0].HostTier(2)
        h = _spill(pkg, tier, n=2)
        small = pkg[1](dict(z=np.zeros(4, np.float32)))
        out = [h, tier.begin_spill(small, 1), tier.stats["refused_spills"]]
        tier.drain()
        tier.fetch(h)
        out.append(tier.begin_spill(small, 1))
        return out + [dict(tier.stats)]
    assert _both(run)[:4] == [0, None, 1, 1]


def test_host_tier_drop_and_dead_handle():
    def run(pkg):
        tier = pkg[0].HostTier(2)
        h = _spill(pkg, tier)
        tier.drop(h)
        out = [tier.stats["drops"], tier.used_blocks]
        tier.drop(h)                         # idempotent
        out.append(tier.stats["drops"])
        with pytest.raises(KeyError):
            tier.fetch(h)
        return out
    assert _both(run) == [1, 0, 1]


def test_host_tier_checksum_catches_corruption():
    def run(pkg):
        P = pkg[0]
        tier = P.HostTier(2)
        h = _spill(pkg, tier)
        tier.drain()
        out = [tier.verify()]
        _corrupt(tier, h, "pk")
        out.append(tier.verify())
        with pytest.raises(P.PoolAuditError, match="checksum"):
            tier.fetch(h)
        return out
    assert _both(run) == [[], [0]]


def test_host_tier_fetch_fault_refusal_and_delay():
    def run(pkg):
        P = pkg[0]
        plan = P.FaultPlan(fail_fetches=(0,), delay_fetches=(1,),
                           fetch_delay_s=0.01)
        tier = P.HostTier(4, fault_plan=plan)
        h0 = _spill(pkg, tier, seed=0)
        h1 = _spill(pkg, tier, seed=1)
        tier.drain()
        out = [tier.fetch(h0) is None, h0 in tier.handles()]
        got, _, stall = tier.fetch(h1)       # delayed but correct
        out += [np.array_equal(_host(got)["pk"], _payload(1)["pk"]),
                stall >= 0.01, dict(tier.stats)]
        return out
    out = _both(run)
    assert out[:4] == [True, False, True, True]
    assert out[4]["refused_fetches"] == out[4]["delayed_fetches"] == 1


@pytest.mark.parametrize("seed", [3, 4])
def test_host_tier_fetch_fail_rate_matches_jax(seed):
    """The seeded refusals (`random.Random(seed + 1)`, one draw per fetch
    call) land on the same fetches in both packages and fire."""
    def run(pkg, s):
        P = pkg[0]
        tier = P.HostTier(16, fault_plan=P.FaultPlan(seed=s,
                                                     fetch_fail_rate=0.4))
        hs = [_spill(pkg, tier, seed=i) for i in range(8)]
        tier.drain()
        return ({i for i, h in enumerate(hs) if tier.fetch(h) is None},
                dict(tier.stats))
    refused, _ = _both(run, seed)
    assert 0 < len(refused) < 8
    assert _both(run, seed)[0] == refused


def test_host_tier_validation():
    for P in (JP, TP):
        with pytest.raises(ValueError):
            P.HostTier(0)


def test_audit_host_census_clean_and_leak():
    def run(pkg):
        P = pkg[0]
        a = P.BlockAllocator(4)
        tier = P.HostTier(4)
        h = _spill(pkg, tier)
        tier.drain()
        rep = P.audit_pool(a, {}, host_tier=tier, tier_holders=[h])
        with pytest.raises(P.PoolAuditError, match="host leak") as err:
            P.audit_pool(a, {}, host_tier=tier, tier_holders=[])
        return rep, str(err.value)
    rep, _ = _both(run)
    assert rep["clean"] and rep["host_entries"] == 1
    assert rep["host_resident"] == 1 and rep["host_in_flight"] == 0


def test_audit_host_census_dead_and_double_claim():
    def run(pkg):
        P = pkg[0]
        a = P.BlockAllocator(4)
        tier = P.HostTier(4)
        h = _spill(pkg, tier)
        msgs = []
        for holders, match in (([h, h + 99], "dead entry"),
                               ([h, h], "claimed by 2")):
            with pytest.raises(P.PoolAuditError, match=match) as err:
                P.audit_pool(a, {}, host_tier=tier, tier_holders=holders)
            msgs.append(str(err.value))
        return msgs
    _both(run)


def test_audit_host_census_checksum():
    def run(pkg):
        P = pkg[0]
        a = P.BlockAllocator(4)
        tier = P.HostTier(4)
        h = _spill(pkg, tier)
        tier.drain()
        _corrupt(tier, h, "pv")
        with pytest.raises(P.PoolAuditError,
                           match="checksum mismatch") as err:
            P.audit_pool(a, {}, host_tier=tier, tier_holders=[h])
        return str(err.value)
    _both(run)


# ---------------------------------------------------------------------------
# Device halves: gather / scatter and degradation on random paged caches
# ---------------------------------------------------------------------------

QSPEC = dict(budget=32, window=8, bits=2, group=8, policy="streaming")
DSPEC = dict(budget=32, policy="none")


def _random_pair(kw, seed, B=3, H=2, D=8, max_len=40, bl=8, extra=3,
                 lead=(2, 1)):
    """A random JAX layer-stacked paged cache (layout of the engines'
    cache: batch axis 2) and the port's copy of it, drop block appended.
    Tables are shuffled block permutations; slot positions and scores
    random; lengths per slot uniform across layers."""
    rng = np.random.default_rng(seed)
    jspec = JC.CacheSpec(**kw)
    S = jspec.main_store_len(max_len)
    bl = JP.resolve_block_len(jspec, S, bl)
    n_max = S // bl
    nb = B * n_max + extra
    jp = JP.init_paged_kv(jspec, B, max_len, H, D, n_blocks=nb,
                          block_len=bl, dtype=jnp.float32)
    leaves = {}
    for f in jp._fields:
        x = np.asarray(getattr(jp, f))
        x = np.broadcast_to(x, (*lead, *x.shape)).copy()
        if x.dtype == np.int8:
            x = rng.integers(-128, 128, x.shape).astype(np.int8)
        elif x.dtype == np.float32:
            x = rng.standard_normal(x.shape).astype(np.float32)
        leaves[f] = x
    ids = rng.permutation(nb)[:B * n_max].reshape(B, n_max)
    leaves["block_tbl"] = np.broadcast_to(
        ids.astype(np.int32), (*lead, B, n_max)).copy()
    leaves["slot_pos"] = rng.permutation(
        np.arange(S * B * 4)).reshape(4 * B, S)[:B].astype(np.int32)
    leaves["slot_pos"] = np.broadcast_to(
        leaves["slot_pos"], (*lead, B, S)).copy()
    length = rng.integers(0, S + 1, B).astype(np.int32)
    leaves["length"] = np.broadcast_to(length, (*lead, B)).copy()
    for f in ("rlen", "pos"):
        leaves[f] = rng.integers(0, 8, (*lead, B)).astype(np.int32)
    jp = JP.PagedLayerKV(**{f: jnp.asarray(v) for f, v in leaves.items()})
    tp = paged_kv_from_numpy(JP.PagedLayerKV(**leaves))
    return jspec, TC.CacheSpec(**kw), jp, tp, nb


def _strip(f, x):
    """The port's pool without its drop block (block axis 2 here)."""
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.take(x, range(x.shape[2] - 1), axis=2) \
        if f in TP.POOL_FIELDS else x


def _assert_caches_equal(tp, jp):
    for f in TP.PagedLayerKV._fields:
        np.testing.assert_array_equal(_strip(f, getattr(tp, f)),
                                      np.asarray(getattr(jp, f)), err_msg=f)


@pytest.mark.parametrize("kw", [QSPEC, DSPEC], ids=["kivi2", "full"])
@pytest.mark.parametrize("seed", [0, 1])
def test_gather_scatter_equal_jax(kw, seed):
    """Gathered blocks and slot metadata equal JAX's; scattering them into
    other ids and another slot gives the same caches."""
    _, _, jp, tp, nb = _random_pair(kw, seed)
    rng = np.random.default_rng(seed + 10)
    src = rng.choice(nb, 3, replace=False)
    dst = rng.choice(nb, 3, replace=False)
    jg = JP.gather_pool_blocks(jp, jnp.asarray(src, jnp.int32), batch_axis=2)
    tg = TP.gather_pool_blocks(tp, torch.as_tensor(src), batch_axis=2)
    assert sorted(tg) == sorted(jg)
    for f in jg:
        np.testing.assert_array_equal(tg[f].numpy(), np.asarray(jg[f]))
    jm = JP.gather_slot_meta(jp, 1, batch_axis=2)
    tm = TP.gather_slot_meta(tp, 1, batch_axis=2)
    for f in jm:
        np.testing.assert_array_equal(tm[f].numpy(), np.asarray(jm[f]))
    jp = JP.scatter_pool_blocks(jp, jnp.asarray(dst, jnp.int32), jg,
                                batch_axis=2)
    jp = JP.scatter_slot_meta(jp, 2, jm, batch_axis=2)
    TP.scatter_pool_blocks(tp, torch.as_tensor(dst), tg, batch_axis=2)
    TP.scatter_slot_meta(tp, 2, tm, batch_axis=2)
    _assert_caches_equal(tp, jp)
    # the gathers are copies: writing the pool leaves them as they were
    tp.pk.zero_()
    np.testing.assert_array_equal(tg["pk"].numpy(), np.asarray(jg["pk"]))


@pytest.mark.parametrize("n_drop", [0, 1, 2, 5])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_degrade_slot_groups_equal_jax(seed, n_drop):
    """`degrade_slot_groups` on random tables, slot positions and lengths
    (ties in age broken as JAX's stable argsort breaks them): table row,
    scores, slot positions and length of every slot equal JAX's, bit for
    bit; the drop block is never mapped."""
    jspec, tspec, jp, tp, nb = _random_pair(QSPEC, seed)
    for slot in range(3):
        jp = JP.degrade_slot_groups(jp, jspec, slot, n_drop, batch_axis=2)
        TP.degrade_slot_groups(tp, tspec, slot, n_drop, batch_axis=2)
        _assert_caches_equal(tp, jp)
    assert not (tp.block_tbl == nb).any()


def test_degrade_slot_groups_tied_ages_equal_jax():
    """Equal ages across candidate groups: the stable rank keeps table
    order among them, as JAX does."""
    jspec, tspec, jp, tp, _ = _random_pair(QSPEC, 7)
    G = QSPEC["group"]
    sp = np.asarray(jp.slot_pos).copy()
    sp[..., G:] = 5                         # every non-sink group age 5
    jp = jp._replace(slot_pos=jnp.asarray(sp),
                     length=jnp.full_like(jp.length, sp.shape[-1]))
    tp.slot_pos.copy_(torch.from_numpy(sp))
    tp.length.fill_(sp.shape[-1])
    jp = JP.degrade_slot_groups(jp, jspec, 0, 2, batch_axis=2)
    TP.degrade_slot_groups(tp, tspec, 0, 2, batch_axis=2)
    _assert_caches_equal(tp, jp)


# ---------------------------------------------------------------------------
# End to end against the JAX engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_model():
    jcfg = jax_reduced(jax_get_config("paper-llama-7b"), num_layers=2)
    cfg = reduced(get_config("paper-llama-7b"), num_layers=2)
    jp = JM.init_params(jax.random.key(0), jcfg)
    return jcfg, jp, cfg, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            cfg)


def _prompts(vocab, n, seed, size=32):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=size).astype(np.int32)
            for _ in range(n)]


def _templated(vocab, n, L, seed=1, shared_frac=0.5):
    rng = np.random.default_rng(seed)
    m = int(L * shared_frac)
    shared = rng.integers(0, vocab, size=m).astype(np.int32)
    return [np.concatenate([shared, rng.integers(
        0, vocab, size=L - m).astype(np.int32)]) for _ in range(n)]


def _serve(model, pname, prompts, *, jax_side=False, max_new=10,
           budget=BUDGET, fault_plan=None, **kw):
    """(engine, result) of one `generate_continuous` run of `prompts`
    through the JAX engine or the port's."""
    jcfg, jp, cfg, p = model
    kw.setdefault("prompt_len", max(len(t) for t in prompts))
    kw.setdefault("buckets", (kw["prompt_len"],))
    if jax_side:
        if fault_plan is not None:
            kw["fault_plan"] = JP.FaultPlan(**dataclasses.asdict(fault_plan))
        eng = JaxEngine(jcfg, jp, jax_presets(budget, WINDOW)[pname],
                        max_new=max_new, use_kernels=False, seed=0, **kw)
        R = JaxRequest
    else:
        eng = Engine(cfg, p, presets(budget, WINDOW)[pname],
                     max_new=max_new, device="cpu", fault_plan=fault_plan,
                     **kw)
        R = Request
    res = eng.generate_continuous([R(tokens=t, max_new=max_new)
                                   for t in prompts])
    return eng, res


def _streams(res):
    return [r.tokens.tolist() for r in sorted(res.results,
                                              key=lambda r: r.uid)]


TIER_KEYS = ("spills", "fetches", "drops", "bytes_spilled", "bytes_fetched",
             "refused_spills", "refused_fetches", "delayed_fetches",
             "host_blocks", "host_entries", "host_resident", "n_spills",
             "n_fetches", "bytes_moved", "grants_stripped", "block_bytes",
             "fp16_block_bytes")


def _assert_equal_jax(eng, got, jeng, want, what=""):
    """Streams, finish reasons, preemption / retry / swap counts per
    request, decode steps, the tier's counts and bytes, the degrade
    counts, and a clean final audit in both engines."""
    g = sorted(got.results, key=lambda r: r.uid)
    w = sorted(want.results, key=lambda r: r.uid)
    assert _streams(got) == _streams(want), what
    for f in ("finish_reason", "n_preemptions", "n_retries", "n_spills",
              "n_fetches", "bytes_moved"):
        assert [getattr(r, f) for r in g] == [getattr(r, f) for r in w], \
            (what, f)
    assert got.decode_steps == want.decode_steps, what
    assert (got.tier is None) == (want.tier is None), what
    if got.tier is not None:
        # the port's pools carry one drop block: bytes per block agree
        assert {k: got.tier[k] for k in TIER_KEYS} == \
            {k: want.tier[k] for k in TIER_KEYS}, what
        assert got.tier["pressure"] == want.tier["pressure"], what
    if eng.pressure is not None:
        assert eng.pressure.stats == jeng.pressure.stats, what
    assert eng.last_audit["clean"] and jeng.last_audit["clean"], what
    assert eng.last_audit == jeng.last_audit, what


def _both_engines(model, pname, prompts, **kw):
    """The port's (engine, result), held equal to the JAX engine's."""
    eng, got = _serve(model, pname, prompts, **kw)
    jeng, want = _serve(model, pname, prompts, jax_side=True, **kw)
    _assert_equal_jax(eng, got, jeng, want, f"{pname} {kw}")
    return eng, got


PAGED = dict(paged=True, block_len=8)
CHUNKED = dict(PAGED, chunked_prefill=True, chunk_len=16)


@pytest.mark.parametrize("opts", [PAGED, CHUNKED], ids=["paged", "chunked"])
@pytest.mark.parametrize("pname", ["full", "kivi2"])
def test_tiering_streams_equal_jax(small_model, pname, opts):
    """tests/test_tiering.py:221: forced preemptions spill the victims'
    blocks to host and restore them at re-admission; the streams equal
    the JAX engine's and the port's unpreempted run's, and nothing is
    replayed."""
    prompts = _prompts(small_model[2].vocab_size, 3, seed=1)
    kw = dict(slots=2, **opts)
    _, ref = _serve(small_model, pname, prompts, **kw)
    eng, res = _both_engines(small_model, pname, prompts, tiering=True,
                             preempt_at=((3, 0), (5, 1)), audit_every=2,
                             **kw)
    assert _streams(res) == _streams(ref)
    assert res.tier["n_spills"] >= 1 and res.tier["n_fetches"] >= 1
    assert res.tier["fetches"] == res.tier["spills"] - \
        res.tier["refused_fetches"]
    assert res.replayed_tokens == 0 and res.recomputed_uids == []
    assert sum(r.n_spills for r in res.results) == res.tier["n_spills"]
    assert res.tier["host_entries"] == 0


def test_tiering_with_sharing_equals_jax(small_model):
    """tests/test_tiering.py:259: preempt-to-host of slots holding
    adopted blocks under the prefix cache."""
    prompts = _templated(small_model[2].vocab_size, 5, 64)
    kw = dict(prompt_len=64, max_new=8, slots=2, budget=64, **CHUNKED)
    _, ref = _serve(small_model, "full", prompts, **kw)
    eng, res = _both_engines(small_model, "full", prompts, tiering=True,
                             prefix_sharing=True,
                             preempt_at=((3, 0), (5, 1)), **kw)
    assert _streams(res) == _streams(ref)
    assert res.prefix["warm_hits"] >= 1 and res.tier["n_spills"] >= 1


@pytest.mark.parametrize("chunked", [False, True])
def test_tiering_oversubscribed_pool_equals_jax(small_model, chunked):
    """tests/test_tiering.py:279: a pool too small for the working set
    completes everything with the tier on, streams equal to an
    uncontended run."""
    prompts = _prompts(small_model[2].vocab_size, 4, seed=3)
    kw = dict(slots=3, block_growth="lazy", **(CHUNKED if chunked
                                               else PAGED))
    eng, res = _both_engines(small_model, "full", prompts, pool_blocks=10,
                             preemption=True, tiering=True, audit_every=3,
                             **kw)
    assert all(r.finish_reason == "length" for r in res.results)
    assert res.tier["n_spills"] >= 1
    _, wide = _serve(small_model, "full", prompts, **kw)
    assert _streams(res) == _streams(wide)


def test_prefix_demotion_warm_hit_equals_jax(small_model):
    """tests/test_tiering.py:303: under reclaim pressure retired prefix
    blocks demote to host instead of being freed, and a later request
    with the same prefix pages them back (promote)."""
    vocab, L, new = small_model[2].vocab_size, 64, 8
    rng = np.random.default_rng(7)
    shared = rng.integers(0, vocab, size=L // 2).astype(np.int32)

    def tail():
        return rng.integers(0, vocab, size=L - L // 2).astype(np.int32)

    def fill():
        return rng.integers(0, vocab, size=L).astype(np.int32)

    prompts = [np.concatenate([shared, tail()]),
               np.concatenate([shared, tail()]),
               fill(), fill(), fill(), fill(),
               np.concatenate([shared, tail()])]
    kw = dict(prompt_len=L, max_new=new, slots=2, budget=64,
              prefix_sharing=True, block_growth="lazy", pool_blocks=24,
              preemption=True, **CHUNKED)
    eng, res = _both_engines(small_model, "full", prompts, tiering=True,
                             **kw)
    _, off = _serve(small_model, "full", prompts, **kw)
    assert _streams(res) == _streams(off)
    idx = eng._share_state["index"]
    assert idx.demoted >= 1 and idx.promoted >= 1
    assert res.tier["fetches"] >= 1


def test_tiering_validation(small_model):
    """tests/test_tiering.py:355, with the JAX engine's messages."""
    _, _, cfg, p = small_model
    pol = presets(BUDGET, WINDOW)["full"]
    kw = dict(prompt_len=32, max_new=8, slots=2, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        Engine(cfg, p, pol, tiering=True, **kw)
    with pytest.raises(ValueError, match="speculative"):
        Engine(cfg, p, pol, tiering=True, paged=True, block_len=8,
               speculative=True, gamma=2, **kw)
    with pytest.raises(ValueError, match="tiering"):
        Engine(cfg, p, pol, paged=True, block_len=8, host_blocks=16, **kw)


# ---- swap-path faults (tests/test_faults.py:372-431) ---------------------

def test_swap_fetch_refusal_falls_back_to_recompute(small_model):
    prompts = _prompts(small_model[2].vocab_size, 3, seed=1)
    _, ref = _serve(small_model, "full", prompts, slots=2, **PAGED)
    eng, res = _both_engines(
        small_model, "full", prompts, slots=2, tiering=True,
        preempt_at=((3, 0), (5, 1)),
        fault_plan=TP.FaultPlan(fail_fetches=(0,)), **PAGED)
    assert _streams(res) == _streams(ref)
    assert eng.host_tier.stats["refused_fetches"] >= 1
    assert res.replayed_tokens > 0 and res.recomputed_uids
    assert all(r.finish_reason == "length" for r in res.results)


def test_swap_fetch_delay_is_timed_not_fatal(small_model):
    prompts = _prompts(small_model[2].vocab_size, 3, seed=1)
    _, ref = _serve(small_model, "full", prompts, slots=2, **PAGED)
    eng, res = _both_engines(
        small_model, "full", prompts, slots=2, tiering=True,
        preempt_at=((3, 0), (5, 1)),
        fault_plan=TP.FaultPlan(delay_fetches=(0, 1), fetch_delay_s=0.01),
        **PAGED)
    assert _streams(res) == _streams(ref)
    assert eng.host_tier.stats["delayed_fetches"] >= 1
    assert res.tier["fetch_stall_s"] >= 0.01


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_swap_fault_soak_equals_jax(small_model, seed):
    """A seeded refusal storm on the swap path while an oversubscribed
    pool churns: every request completes, streams equal the fault-free
    tiering run's and the JAX engine's, the two tiers count the same
    fetch calls."""
    prompts = _prompts(small_model[2].vocab_size, 4, seed=3)
    kw = dict(slots=3, block_growth="lazy", pool_blocks=10, preemption=True,
              tiering=True, audit_every=4, **PAGED)
    _, calm = _serve(small_model, "full", prompts, **kw)
    eng, res = _both_engines(
        small_model, "full", prompts,
        fault_plan=TP.FaultPlan(seed=seed, fetch_fail_rate=0.3), **kw)
    assert _streams(res) == _streams(calm)
    assert all(r.finish_reason == "length" for r in res.results)
    assert eng.host_tier.fetch_calls >= 1


# ---- degradation (tests/test_faults.py:299-331) --------------------------

@pytest.mark.parametrize("chunked", [False, True])
def test_degradation_under_pressure_equals_jax(small_model, chunked):
    """Above the high-water mark resident kivi2 slots drop their oldest
    flushed groups (released through the scheduler seam) before any
    preemption; everything completes, streams, degrade counts and blocks
    dropped equal the JAX engine's, and audits (the device table's
    included) stay clean."""
    prompts = _prompts(small_model[2].vocab_size, 6, seed=5)
    eng, res = _both_engines(
        small_model, "kivi2", prompts, max_new=16, slots=3,
        block_growth="lazy", preemption=True, degrade=True,
        degrade_high=0.5, degrade_low=0.3, audit_every=3,
        **(CHUNKED if chunked else PAGED))
    assert all(r.finish_reason == "length" for r in res.results)
    st = eng.pressure.stats
    assert st["degrades"] >= 1 and st["blocks_dropped"] >= 1


def test_degrade_validation(small_model):
    """tests/test_faults.py:317, with the JAX engine's messages; and
    degradation refuses the speculative loop as JAX does."""
    _, _, cfg, p = small_model
    pol = presets(BUDGET, WINDOW)["kivi2"]
    kw = dict(prompt_len=32, max_new=8, slots=2, device="cpu", paged=True,
              block_len=8)
    with pytest.raises(ValueError, match="lazy"):
        Engine(cfg, p, pol, degrade=True, **kw)
    with pytest.raises(ValueError, match="quantized|grouped"):
        Engine(cfg, p, presets(BUDGET, WINDOW)["full"],
               block_growth="lazy", degrade=True, **kw)
    with pytest.raises(ValueError, match="speculative"):
        Engine(cfg, p, pol, block_growth="lazy", degrade=True,
               speculative=True, gamma=2, **kw)
    with pytest.raises(ValueError, match="paged"):
        Engine(cfg, p, pol, prompt_len=32, max_new=8, slots=2,
               device="cpu", fault_plan=TP.FaultPlan())
