"""The port's self-speculative decoding against the JAX package on the CPU
(reduced granite-8b / paper-llama-7b, 2 layers, f32, the same weights
through `repro_torch.bridge`): masked appends, `append_segment` and
`truncate_rows` field for field (integers exact, floats within 1e-6:
the same f32 quantization arithmetic on both sides); `verify_step`'s
tokens and acceptance exact, its logits within 1e-4 and its committed
cache against the JAX cache; the verify kernel's plain version against
the Pallas kernel in interpret mode within 1e-5; and speculative engine
streams token-equal to the JAX speculative engine's and to the port's
plain streams."""
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
from repro.core.cache import CacheSpec as JaxSpec
from repro.core.policy import presets as jax_presets
from repro.kernels.flash_prefill import ops as jax_fp
from repro.nn import model as JM
from repro.serving import Engine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.bridge import (layer_kv_from_numpy, paged_kv_from_numpy,
                                params_from_numpy)
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import cache as TC
from repro_torch.core import paging as TP
from repro_torch.core.cache import CacheSpec
from repro_torch.core.policy import presets
from repro_torch.kernels.flash_prefill.ref import flash_verify_ref
from repro_torch.nn import model as M
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request
from repro_torch.serving.speculative import (CacheMirror,
                                             resolve_draft_policy)

F_ATOL = 1e-6
LOGIT_TOL = 1e-4
ATTN_TOL = 1e-5
_j_append = jax.jit(JC.append_token, static_argnums=(1,))
_j_segment = jax.jit(JC.append_segment, static_argnums=(1,))
_j_truncate = jax.jit(JC.truncate_rows, static_argnums=(1,))


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def assert_cache_equal(got, want, what=""):
    """Every field of a dense or paged cache (the port's pools minus
    their drop block): integers exact, floats within F_ATOL."""
    for f in type(got)._fields:
        g, w = _np(getattr(got, f)), np.asarray(getattr(want, f))
        if f in TP.POOL_FIELDS:
            axis = g.ndim - (3 if f.startswith("pv_") else 4)
            g = np.take(g, range(g.shape[axis] - 1), axis=axis)
        assert g.shape == w.shape, (what, f, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {f}")
        else:
            np.testing.assert_allclose(g, w.astype(np.float32), atol=F_ATOL,
                                       rtol=0, err_msg=f"{what} {f}")


# ---------------------------------------------------------------------------
# Cache level: masked appends, segments, rollback
# ---------------------------------------------------------------------------

H, D = 2, 16
STORES = {
    # dense h2o at a budget below prompt + segment: evictions mid-segment
    "h2o": dict(budget=24, policy="h2o", window=0, sinks=2,
                recent_protect=4),
    # uncompressed headroom: fresh rows only
    "full": dict(budget=64, policy="none", window=0, sinks=2),
    # KIVI ring: a flush on sub-step 0 of a full ring
    "kivi2": dict(budget=32, window=8, bits=2, group=8, policy="streaming",
                  sinks=2),
}


def _layer(kind, B=3, S_p=32, seed=0):
    rng = np.random.default_rng(seed)
    k, v = (rng.standard_normal((B, S_p, H, D)).astype(np.float32)
            for _ in range(2))
    mass = rng.random((B, S_p)).astype(np.float32)
    jspec = JaxSpec(**STORES[kind])
    jlc = JC.compress_prompt(jspec, jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(mass), dtype=jnp.float32)
    return (jspec, jlc, CacheSpec(**STORES[kind]),
            layer_kv_from_numpy(jax.tree.map(np.asarray, jlc)))


def _seg(B, n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, n, H, D)).astype(np.float32)


@pytest.mark.parametrize("kind", sorted(STORES))
def test_masked_append_token(kind):
    """One masked append: masked rows keep every field; a quantized row
    flushes only where need & mask (row 1 is full and masked)."""
    jspec, jlc, spec, tlc = _layer(kind)
    one = _seg(3, 1, 1)[:, 0]
    mask = np.asarray([True, False, True])
    want = _j_append(jlc, jspec, jnp.asarray(one), jnp.asarray(one),
                           mask=jnp.asarray(mask))
    TC.append_token(tlc, spec, torch.tensor(one), torch.tensor(one),
                    mask=torch.tensor(mask))
    assert_cache_equal(tlc, want, kind)
    if spec.quantized:
        assert tlc.rlen.tolist() == [1, spec.window, 1]


@pytest.mark.parametrize("kind", sorted(STORES))
def test_append_segment_ragged(kind):
    """A 5-row segment with ragged valid lengths (5, 0, 3): bit-equal to
    the JAX scan of masked appends, with host flush flags from the mirror
    arithmetic (only sub-step 0 flushes a full ring)."""
    jspec, jlc, spec, tlc = _layer(kind)
    seg = _seg(3, 5, 2)
    vl = np.asarray([5, 0, 3], np.int32)
    want = _j_segment(jlc, jspec, jnp.asarray(seg), jnp.asarray(seg),
                             valid_len=jnp.asarray(vl))
    ring_full = [spec.quantized and t == 0 for t in range(5)]
    TC.append_segment(tlc, spec, torch.tensor(seg), torch.tensor(seg),
                      valid_len=torch.tensor(vl), ring_full=ring_full)
    assert_cache_equal(tlc, want, kind)


@pytest.mark.parametrize("kind", sorted(STORES))
def test_truncate_rows(kind):
    """Roll a segment back (at a ring boundary for the quantized store:
    the segment follows a flushing append), then append across the next
    flush boundary: the port tracks the JAX cache at every step."""
    jspec, jlc, spec, tlc = _layer(kind, seed=3)
    steps = [(_seg(3, 1, 4), None), (_seg(3, 5, 5), np.asarray([5, 3, 1]))]
    for seg, vl in steps:
        kw = {} if vl is None else dict(valid_len=jnp.asarray(vl, jnp.int32))
        jlc = _j_segment(jlc, jspec, jnp.asarray(seg),
                                jnp.asarray(seg), **kw)
        TC.append_segment(tlc, spec, torch.tensor(seg), torch.tensor(seg),
                          valid_len=None if vl is None else torch.tensor(vl))
    drop = np.asarray([4, 2, 0], np.int32)
    jlc = _j_truncate(jlc, jspec, jnp.asarray(drop))
    TC.truncate_rows(tlc, spec, torch.tensor(drop))
    assert_cache_equal(tlc, jlc, kind + " truncated")
    seg = _seg(3, 9, 6)
    jlc = _j_segment(jlc, jspec, jnp.asarray(seg), jnp.asarray(seg))
    TC.append_segment(tlc, spec, torch.tensor(seg), torch.tensor(seg))
    assert_cache_equal(tlc, jlc, kind + " re-appended")


@pytest.mark.parametrize("kind", ["full", "kivi2"])
def test_paged_masked_segment_and_truncate(kind):
    """The paged store: ragged segment through the block table (masked
    rows write the drop block), then rollback, against the JAX pool."""
    jspec, jlc, spec, _ = _layer(kind, B=2)
    B, bl = 2, 8
    S = jspec.main_store_len(32)
    n_max = S // bl
    jp = JP.stacked_paged_kv(jspec, 1, B, 32, H, D, n_blocks=B * n_max + 2,
                             block_len=bl, dtype=jnp.float32)
    ids = np.random.default_rng(7).permutation(B * n_max + 2)[:B * n_max]
    for slot in range(B):
        one = jax.tree.map(
            lambda x: x[None] if x.ndim == 0 else x[None, slot:slot + 1], jlc)
        jp = JP.insert_request_paged(
            jp, slot, one, jnp.asarray(ids[slot * n_max:(slot + 1) * n_max],
                                       jnp.int32), batch_axis=1)
    jp = jax.tree.map(lambda x: x[0], jp)
    tp = paged_kv_from_numpy(jax.tree.map(np.asarray, jp))
    seg = _seg(B, 4, 8)
    vl = np.asarray([4, 2], np.int32)
    jp = _j_segment(jp, jspec, jnp.asarray(seg), jnp.asarray(seg),
                           valid_len=jnp.asarray(vl))
    TC.append_segment(tp, spec, torch.tensor(seg), torch.tensor(seg),
                      valid_len=torch.tensor(vl))
    assert_cache_equal(tp, jp, kind + " paged segment")
    drop = np.asarray([3, 1], np.int32)
    jp = _j_truncate(jp, jspec, jnp.asarray(drop))
    TC.truncate_rows(tp, spec, torch.tensor(drop))
    assert_cache_equal(tp, jp, kind + " paged truncated")


def test_accumulate_scores_gate():
    jspec, jlc, spec, tlc = _layer("h2o")
    mass = np.random.default_rng(9).random((3, 24)).astype(np.float32)
    gate = np.asarray([True, False, True])
    want = JC.accumulate_scores(jlc, jspec, jnp.asarray(mass),
                                gate=jnp.asarray(gate))
    TC.accumulate_scores(tlc, spec, torch.tensor(mass),
                         gate=torch.tensor(gate))
    np.testing.assert_array_equal(tlc.scores.numpy(), np.asarray(want.scores))


def test_cache_mirror_tracks_device_state():
    """The mirror's length / rlen / pos track the cache through appends
    across flush boundaries and truncates; its flush flags drive the
    appends (no device read)."""
    _, _, spec, tlc = _layer("kivi2", B=1)
    mir = CacheMirror(spec, np.asarray([32]), 32, n_slots=1)
    mir.admit(0, 32)
    assert (mir.length[0, 0], mir.rlen[0], mir.pos[0]) == \
        (int(tlc.length[0]), int(tlc.rlen[0]), int(tlc.pos[0]))
    rng = np.random.default_rng(7)
    for n_app, n_trunc in [(1, 0), (5, 2), (8, 0), (3, 3), (9, 1)]:
        seg = torch.tensor(rng.standard_normal((1, n_app, H, D)),
                           dtype=torch.float32)
        flags = [mir.flushes(0, t) for t in range(n_app)]
        TC.append_segment(tlc, spec, seg, seg, ring_full=flags)
        mir.append(0, n_app)
        TC.truncate_rows(tlc, spec, torch.tensor([n_trunc]))
        mir.truncate(0, n_trunc)
        assert int(tlc.rlen[0]) == mir.rlen[0]
        assert int(tlc.length[0]) == mir.length[0, 0]
        assert int(tlc.pos[0]) == mir.pos[0]


def test_draft_policy_resolution():
    cfg = reduced(get_config("paper-llama-7b"))
    base = presets(budget=64, window=16)["h2o"].spec
    d = resolve_draft_policy("window:48", cfg, base, 128, 32)
    assert d.cfg.sliding_window == 48 and d.name == "window:48"
    assert d.spec.budget == 160 and d.spec.bits == 16
    d2 = resolve_draft_policy("kivi2:40:8", cfg, base, 128, 32)
    assert (d2.spec.bits, d2.spec.budget, d2.spec.window) == (2, 40, 8)
    d3 = resolve_draft_policy("kivi4", cfg, base, 128, 32)
    assert (d3.spec.bits, d3.spec.budget, d3.spec.window) == (4, 64, 16)
    assert resolve_draft_policy("same", cfg, base, 128, 32).spec == base
    for bad in ("medusa", "window:0"):
        with pytest.raises(ValueError):
            resolve_draft_policy(bad, cfg, base, 128, 32)


# ---------------------------------------------------------------------------
# The verify kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [0, 5])
def test_flash_verify_ref_matches_pallas(window):
    """Ragged segment positions, empty cache rows (-1, bias -1e30), one
    all-masked query row (q_pos below every key), Gq = 2, L = 5."""
    rng = np.random.default_rng(11 + window)
    B, L, Hq, Hkv, Dh, Tk = 2, 5, 4, 2, 64, 40
    q = rng.standard_normal((B, L, Hq, Dh)).astype(np.float32)
    k, v = (rng.standard_normal((B, Tk, Hkv, Dh)).astype(np.float32)
            for _ in range(2))
    kv_pos = np.tile(np.arange(Tk, dtype=np.int32), (B, 1))
    kv_pos[1, 30:] = -1
    bias = np.where(kv_pos >= 0, 0.0, -1e30).astype(np.float32)
    q_pos = np.asarray([[30, 31, 32, 33, 34], [-5, 26, 27, 28, 29]],
                       np.int32)
    want = jax_fp.flash_verify(*map(jnp.asarray, (q, k, v, kv_pos, bias,
                                                  q_pos)),
                               window=window, interpret=True)
    got = flash_verify_ref(*map(torch.tensor, (q, k, v, kv_pos, bias,
                                               q_pos)), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL,
                               rtol=ATTN_TOL)


# ---------------------------------------------------------------------------
# verify_step against the JAX model
# ---------------------------------------------------------------------------


def _model(arch):
    jcfg = jax_reduced(jax_get_config(arch), num_layers=2)
    cfg = reduced(get_config(arch), num_layers=2)
    jp = JM.init_params(jax.random.key(0), jcfg)
    return jcfg, jp, cfg, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            cfg)


@pytest.fixture(scope="module")
def granite():
    """The verify-step arch (the engine tests below run paper-llama-7b)."""
    return _model("granite-8b")


def _verify_with_logits(jp, jcfg, jc, toks, vl, jspec):
    """JAX `verify_step`, also returning the [B, L, V] logits it argmaxes
    (captured at its `_logits` call while the jit traces it)."""
    box, orig = [], JM._logits

    def keep(*a, **kw):
        box.append(orig(*a, **kw))
        return box[-1]

    JM._logits = keep
    try:
        y, acc, jc = JM.verify_step(jp, jcfg, jc, toks, vl, jspec)
    finally:
        JM._logits = orig
    return y, acc, jc, box[-1]


_j_prefill = jax.jit(JM.prefill, static_argnums=(1, 3))
_j_decode = jax.jit(JM.decode_step, static_argnums=(1, 4))
_j_verify = jax.jit(_verify_with_logits, static_argnums=(1, 5))


# h2o reads the mass, so its verify takes the reference route either way
@pytest.mark.parametrize("pname,use_kernels", [
    ("full", True), ("full", False), ("h2o", False), ("kivi2", True),
    ("kivi2", False)], ids=str)
def test_verify_step_matches_jax(granite, pname, use_kernels):
    """Batch-3 cache after a 40-token prefill and one decode step (the
    quantized ring is then one row past a flush); a 5-row segment with
    ragged valid lengths (5, 1, 0) whose drafts are the target's own
    greedy tokens for row 0 up to a planted mismatch. y and accepted
    exact, logits within 1e-4, the committed cache against JAX's."""
    jcfg, jp, cfg, p = granite
    # the JAX side on the same route (its Pallas kernels in interpret
    # mode): the kernel route records zero prefill mass for `full`/`kivi2`
    jcfg = jcfg.replace(use_kernels=use_kernels)
    cfg = cfg.replace(use_kernels=use_kernels)
    spec = presets(16, 8)[pname].spec
    jspec = jax_presets(16, 8)[pname].spec
    if not spec.compressed:
        spec, jspec = CacheSpec(budget=64), JaxSpec(budget=64)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (3, 40))
    jl, jc = _j_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, jspec)
    tl, tc = M.prefill(p, cfg, {"tokens": torch.tensor(toks)}, spec)
    nxt = np.asarray(jnp.argmax(jl, -1))[:, None]
    jl, jc = _j_decode(jp, jcfg, jc, jnp.asarray(nxt), jspec)
    M.decode_step(p, cfg, tc, torch.tensor(nxt), spec,
                  ring_full=spec.quantized)
    seg = np.random.default_rng(6).integers(0, cfg.vocab_size, (3, 5))
    seg[:, 0] = np.asarray(jnp.argmax(jl, -1))
    vl = np.asarray([5, 1, 0], np.int32)
    # row 0's drafts: the target's own continuation for 2 tokens, then off
    for i in (1, 2, 3):
        probe = np.asarray(_j_verify(jp, jcfg, jc, jnp.asarray(seg),
                                     jnp.asarray(vl), jspec)[0])
        seg[0, i] = probe[0, i - 1] + (i == 3)
    y_j, acc_j, jc, logits_j = _j_verify(jp, jcfg, jc, jnp.asarray(seg),
                                         jnp.asarray(vl), jspec)
    seen = {}
    orig = M._logits

    def keep(*a, **kw):
        seen["logits"] = orig(*a, **kw)
        return seen["logits"]

    M._logits = keep
    try:
        ring_full = [spec.quantized and t == 0 for t in range(5)]
        y_t, acc_t, tc = M.verify_step(p, cfg, tc, torch.tensor(seg),
                                       torch.tensor(vl), spec,
                                       ring_full=ring_full)
    finally:
        M._logits = orig
    assert acc_t.tolist() == np.asarray(acc_j).tolist() == [2, 0, 0]
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    np.testing.assert_allclose(seen["logits"].numpy(), np.asarray(logits_j),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    jattn = jax.tree.map(np.asarray, jc.attn)
    for f in TC.LayerKV._fields:
        g, w = getattr(tc.attn, f).numpy(), np.asarray(getattr(jattn, f))
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            np.testing.assert_allclose(g, w, atol=LOGIT_TOL, rtol=LOGIT_TOL,
                                       err_msg=f)


# ---------------------------------------------------------------------------
# Engine streams: the JAX speculative engine and the port's plain engine
# ---------------------------------------------------------------------------

L_PROMPT, NEW, N_REQ, SLOTS = 64, 16, 5, 2


@pytest.fixture(scope="module")
def llama():
    """The arch of tests/test_speculative.py (2-layer paper-llama-7b)."""
    return _model("paper-llama-7b")


def _prompts(vocab):
    rng = np.random.default_rng(1)
    return rng.integers(0, vocab, size=(N_REQ, L_PROMPT)).astype(np.int32)


def _run(model, pname, *, jax_engine=False, eos=None, **kw):
    jcfg, jp, cfg, p = model
    args = dict(prompt_len=L_PROMPT, max_new=NEW, slots=SLOTS, block_len=8)
    if jax_engine:
        eng = JaxEngine(jcfg, jp, jax_presets(32, 8)[pname],
                        use_kernels=False, **args, **kw)
        R = JaxRequest
    else:
        eng = Engine(cfg, p, presets(32, 8)[pname], device="cpu", **args,
                     **kw)
        R = Request
    res = eng.generate_continuous(
        [R(tokens=x, max_new=NEW, eos_id=eos if i == 1 else None)
         for i, x in enumerate(_prompts(cfg.vocab_size))])
    if eng.paged:
        assert eng.last_audit is not None and eng.last_audit["clean"]
    return res


def _assert_streams(got, want, label):
    assert len(got.results) == len(want.results)
    for g, w in zip(got.results, want.results):
        np.testing.assert_array_equal(g.tokens, w.tokens, err_msg=label)
        assert g.finish_reason == w.finish_reason, label


SPEC_FIELDS = ("rounds", "verify_steps", "plain_steps", "drafted",
               "accepted", "committed", "draft_policy", "gamma")


def _assert_spec_stats(got, want, label):
    """The port's SpecStats equal the JAX engine's field by field: the
    drafter's proposals (and so its cache views, prefill, masked decode,
    catch-up and rollback) are held to the JAX drafter's, which equal
    token streams alone would not show."""
    g = {f: getattr(got.spec, f) for f in SPEC_FIELDS}
    w = {f: getattr(want.spec, f) for f in SPEC_FIELDS}
    assert g == w, label


FAST_GRID = [("full", False, "same"), ("kivi2", False, "window:32"),
             ("h2o", True, "same")]


@pytest.mark.parametrize("pname,paged,draft", FAST_GRID, ids=str)
def test_spec_streams_equal_jax_and_plain(llama, pname, paged, draft):
    kw = dict(paged=paged, speculative=True, gamma=3, draft_policy=draft)
    got = _run(llama, pname, **kw)
    jres = _run(llama, pname, jax_engine=True, **kw)
    _assert_streams(got, jres, f"{pname}/{draft} vs the JAX speculative "
                    "engine")
    _assert_spec_stats(got, jres, f"{pname}/{draft} SpecStats vs JAX")
    _assert_streams(got, _run(llama, pname, paged=paged),
                    f"{pname}/{draft} vs the port's plain engine")
    st = got.spec
    assert st.rounds == st.verify_rounds + st.plain_rounds
    if pname == "h2o":
        # dense compressed at budget: depth cap 0, every round plain
        assert st.verify_steps == 0 and st.plain_steps > 0
        assert st.verify_rounds == 0 and st.draft_calls == 0
    else:
        assert st.verify_steps > 0 and st.draft_calls > 0
    if draft == "same":
        assert st.acceptance_rate == (1.0 if st.drafted else 0.0)


def test_spec_chunked_and_early_exit(llama):
    """Chunked admissions interleaved with verify rounds, and an EOS in
    the middle of a committed segment: the stream stops where plain
    decode and the JAX speculative engine stop."""
    probe = _run(llama, "kivi2")
    eos = int(probe.results[1].tokens[3])
    kw = dict(eos=eos, speculative=True, gamma=3, draft_policy="same",
              chunked_prefill=True, chunk_len=16)
    got = _run(llama, "kivi2", **kw)
    _assert_streams(got, _run(llama, "kivi2", eos=eos),
                    "kivi2 chunked+spec / eos vs plain")
    jres = _run(llama, "kivi2", jax_engine=True, **kw)
    _assert_streams(got, jres,
                    "kivi2 chunked+spec / eos vs the JAX speculative engine")
    _assert_spec_stats(got, jres, "kivi2 chunked+spec / eos SpecStats")
    assert got.results[1].finish_reason == "eos"
    assert got.spec.verify_steps > 0
    kw = dict(paged=True, speculative=True, gamma=4,
              draft_policy="window:32", chunked_prefill=True, chunk_len=16)
    full = _run(llama, "full", **kw)
    _assert_streams(full, _run(llama, "full"), "full paged+chunked+spec")
    _assert_spec_stats(full, _run(llama, "full", jax_engine=True, **kw),
                       "full paged+chunked+spec SpecStats")


def test_spec_kernel_route_on_cpu(llama):
    """use_kernels=True routes verify attention through B5's plain
    version on the CPU (and decode / prefill through B1's / B2's); the
    streams equal the kernel-route plain engine's and the JAX speculative
    engine's, and a gamma-1 'same' drafter commits >= 1 token per verify
    step at acceptance 1.0."""
    kw = dict(speculative=True, gamma=1, draft_policy="same")
    got = _run(llama, "kivi2", use_kernels=True, **kw)
    _assert_streams(got, _run(llama, "kivi2", use_kernels=True),
                    "kivi2 kernel route vs plain")
    _assert_streams(got, _run(llama, "kivi2", jax_engine=True, **kw),
                    "kivi2 kernel route vs the JAX speculative engine")
    st = got.spec
    assert st.verify_steps > 0 and st.acceptance_rate == 1.0
    assert st.committed_per_verify_step >= 1.0


def test_spec_engine_errors(llama):
    jcfg, jp, cfg, p = llama
    pol = presets(32, 8)["full"]
    kw = dict(prompt_len=32, max_new=4, device="cpu")
    with pytest.raises(ValueError, match="gamma"):
        Engine(cfg, p, pol, speculative=True, gamma=0, **kw)
    with pytest.raises(ValueError, match="greedy"):
        Engine(cfg, p, pol, speculative=True, sampler=lambda x: x, **kw)
    with pytest.raises(ValueError, match="generate_continuous"):
        Engine(cfg, p, pol, speculative=True, **kw).generate(
            np.zeros((2, 32), np.int64))
