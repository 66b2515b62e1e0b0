"""NACL / Keyformer noise, the layer-budget signals and the engine's seeded
generator, against the JAX package on the CPU.

  * function level: `select_victim`, `accumulate_scores`,
    `compress_prompt` and a 20-step append sequence under nacl /
    keyformer equal the JAX functions bit for bit in f32 when the port's
    draw function (`cache.gumbel`) hands out JAX's own draws,
    `jax.random.gumbel(key, shape)` for the key the JAX function gets.
    One exception, Keyformer's accumulated scores: its softmax runs
    `log` and `exp`, which torch's and XLA's CPU kernels round apart by
    one f32 ulp on ~10-15 % of inputs, and XLA sums in another order; so
    those scores are held within KEYFORMER_RTOL, and every selection
    they drive (kept rows, victims, positions, K / V) exactly;
  * model level (reduced paper-llama-7b, 2 layers, f32, the same weights
    through `repro_torch.bridge`): prefill and 6 decode steps with JAX's
    per-layer keys, split as `repro.nn.model` splits them and replayed
    through `cache.gumbel` by monkeypatch: greedy tokens equal, logits
    within 1e-5;
  * engine level, dense and paged: one seed gives one stream under
    noise, and nacl / keyformer at temperature / tau 0 (neither package
    draws) give the JAX engine's streams;
  * `attention_entropy_signal` / `layer_cosine_signal` within 1e-6 of
    JAX's, and `allocator_signal` gives the JAX engine's layer budgets
    for squeeze and zigzag.
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
from repro.core import budgets as JB
from repro.core import cache as JC
from repro.core.policy import presets as jax_presets
from repro.nn import model as JM
from repro.serving import Engine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import budgets as TB
from repro_torch.core import cache as TC
from repro_torch.core.policy import presets
from repro_torch.nn import model as M
from repro_torch.serving import sampler as sampler_lib
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request

NOISY = ("nacl", "keyformer")
BUDGET, WINDOW = 16, 8
LOGIT_TOL = 1e-5          # model level, f32
KEYFORMER_RTOL = 1e-6     # Keyformer's softmaxed scores: a few f32 ulps
SIGNAL_TOL = 1e-6
_j_prefill = jax.jit(JM.prefill, static_argnums=(1, 3))
_j_decode = jax.jit(JM.decode_step, static_argnums=(1, 4))


def _t(a):
    return torch.tensor(np.asarray(a))


def _draw(key, shape) -> torch.Tensor:
    return _t(jax.random.gumbel(key, tuple(shape), jnp.float32))


class Replay:
    """Stands in for `repro_torch.core.cache.gumbel`: each call returns
    JAX's draw for the next queued key at the shape asked for."""

    def __init__(self):
        self.keys = []
        self.calls = 0

    def __call__(self, shape, generator, device):
        assert generator is not None
        self.calls += 1
        return _draw(self.keys.pop(0), shape)


@pytest.fixture
def replay(monkeypatch):
    r = Replay()
    monkeypatch.setattr(TC, "gumbel", r)
    return r


def _specs(pname):
    return (presets(BUDGET, WINDOW)[pname].spec,
            jax_presets(BUDGET, WINDOW)[pname].spec)


def _prompt(B, S_p, H=2, D=16, seed=0):
    r = np.random.default_rng(seed)
    k = r.standard_normal((B, S_p, H, D)).astype(np.float32)
    v = r.standard_normal((B, S_p, H, D)).astype(np.float32)
    # masses close together, so the noise decides some ranks
    mass = r.uniform(0.5, 0.6, size=(B, S_p)).astype(np.float32)
    return k, v, mass


def assert_kv_exact(t_lc, j_lc, what="", scores_rtol=0.0):
    """Every leaf bit for bit; with `scores_rtol` the two score leaves
    within it (Keyformer's softmaxed mass)."""
    for f in TC.LayerKV._fields:
        got, want = getattr(t_lc, f).numpy(), np.asarray(getattr(j_lc, f))
        if scores_rtol and f in ("scores", "r_scores"):
            np.testing.assert_allclose(got, want, rtol=scores_rtol, atol=0,
                                       err_msg=f"{what} {f}")
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"{what} {f}")


def _scores_rtol(pname):
    return KEYFORMER_RTOL if pname == "keyformer" else 0.0


def _compress(pname, key, replay, seed=0):
    ts, js = _specs(pname)
    k, v, mass = _prompt(2, 40, seed=seed)
    replay.keys.append(key)
    t = TC.compress_prompt(ts, _t(k), _t(v), _t(mass), dtype=torch.float32,
                           generator=torch.Generator())
    j = JC.compress_prompt(js, jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(mass), key=key, dtype=jnp.float32)
    return t, j


# ---------------------------------------------------------------------------
# function level: the three JAX draw sites, fed JAX's draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pname", NOISY)
def test_compress_prompt_under_noise(pname, replay):
    """The prompt selection of 8 keys equals JAX's leaf for leaf, and the
    noise moves it (the selected rows differ between keys)."""
    picks = set()
    for i in range(8):
        t, j = _compress(pname, jax.random.key(i), replay)
        assert_kv_exact(t, j, f"{pname} key {i}")
        picks.add(tuple(t.slot_pos[0].tolist()))
    assert replay.calls == 8 and not replay.keys
    assert len(picks) > 1


@pytest.mark.parametrize("pname", NOISY)
def test_select_victim_under_noise(pname, replay):
    """NACL: scores + temperature * g ranks the victims, as JAX's; the
    victim moves with the key. Keyformer draws nothing here."""
    t, j = _compress(pname, jax.random.key(100), replay)
    ts, js = _specs(pname)
    victims = set()
    for i in range(16):
        key = jax.random.key(200 + i)
        got = TC.select_victim(t, ts, _draw(key, t.scores.shape))
        want = JC.select_victim(j, js, key)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        victims.add(tuple(got.tolist()))
    assert (len(victims) > 1) == (pname == "nacl")


@pytest.mark.parametrize("pname", NOISY)
def test_accumulate_scores_under_noise(pname, replay):
    """Keyformer: softmax((log(max(mass, 1e-9)) + g) / tau) replaces the
    main store's mass, within KEYFORMER_RTOL of JAX's; nacl adds the
    plain mass, bit for bit."""
    t, j = _compress(pname, jax.random.key(300), replay)
    ts, js = _specs(pname)
    r = np.random.default_rng(5)
    for i in range(4):
        key = jax.random.key(400 + i)
        am = r.uniform(size=(2, t.scores.shape[1] + t.rk.shape[1]))
        am = am.astype(np.float32)
        TC.accumulate_scores(t, ts, _t(am), noise=_draw(key, t.scores.shape))
        j = JC.accumulate_scores(j, js, jnp.asarray(am), key=key)
        assert_kv_exact(t, j, f"{pname} step {i}", _scores_rtol(pname))


@pytest.mark.parametrize("pname", NOISY)
def test_append_sequence_under_noise(pname, replay):
    """20 appends, each with its step's score accumulation, one key a
    step serving both (as `block_decode` hands one key to both): dense
    evictions pick the same victims, every leaf equal bit for bit
    (Keyformer's scores within KEYFORMER_RTOL)."""
    t, j = _compress(pname, jax.random.key(500), replay)
    ts, js = _specs(pname)
    r = np.random.default_rng(7)
    for step in range(20):
        key = jax.random.key(600 + step)
        g = _draw(key, t.scores.shape)
        kn = r.standard_normal((2, 2, 16)).astype(np.float32)
        vn = r.standard_normal((2, 2, 16)).astype(np.float32)
        TC.append_token(t, ts, _t(kn), _t(vn), noise=g)
        j = JC.append_token(j, js, jnp.asarray(kn), jnp.asarray(vn), key=key)
        am = r.uniform(size=(2, t.scores.shape[1] + t.rk.shape[1]))
        am = am.astype(np.float32)
        TC.accumulate_scores(t, ts, _t(am), noise=g)
        j = JC.accumulate_scores(j, js, jnp.asarray(am), key=key)
        assert_kv_exact(t, j, f"{pname} step {step}", _scores_rtol(pname))


def test_no_generator_no_draw(replay):
    """Without a generator (or at temperature / tau 0) nothing is drawn
    and the policies rank by the plain mass, as h2o does."""
    for pname in NOISY:
        ts, _ = _specs(pname)
        assert TC.policy_noise(ts, (2, 4), None, "cpu") is None
        cold = dataclasses.replace(ts, nacl_temperature=0.0,
                                   keyformer_tau=0.0)
        assert TC.policy_noise(cold, (2, 4), torch.Generator(), "cpu") is None
    h2o = presets(BUDGET, WINDOW)["h2o"].spec
    assert TC.policy_noise(h2o, (2, 4), torch.Generator(), "cpu") is None
    assert replay.calls == 0


def test_gumbel_draws_are_standard_gumbel():
    """The real draw function: f32, finite, on the generator's device,
    deterministic per seed, with the standard Gumbel's mean (Euler's
    constant) and variance (pi^2 / 6) over 200k draws."""
    g = TC.gumbel((200_000,), torch.Generator().manual_seed(0), "cpu")
    assert g.dtype == torch.float32 and torch.isfinite(g).all()
    again = TC.gumbel((200_000,), torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(g, again)
    assert abs(g.mean().item() - 0.5772157) < 0.01
    assert abs(g.var().item() - np.pi ** 2 / 6) < 0.02


# ---------------------------------------------------------------------------
# model level: prefill + 6 decode steps with JAX's per-layer keys
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def llama():
    jcfg = jax_reduced(jax_get_config("paper-llama-7b"), num_layers=2)
    cfg = reduced(get_config("paper-llama-7b"), num_layers=2)
    jp = JM.init_params(jax.random.key(0), jcfg)
    return jcfg, jp, cfg, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            cfg)


N_STEPS = 6


@pytest.mark.parametrize("use_kernels", [True, False],
                         ids=["kernel-plain", "reference"])
@pytest.mark.parametrize("pname", NOISY)
def test_model_prefill_and_decode_under_replayed_keys(llama, replay, pname,
                                                      use_kernels):
    """The JAX model splits each call's key into one key per layer
    (`jax.random.split(key, n_layers)`, layer order); the port draws once
    per layer per call from its generator, in layer order. With JAX's
    draws replayed, the two models pick the same rows at every prefill
    selection and eviction: greedy tokens equal over 6 steps (evictions
    from the first step on), logits within 1e-5."""
    jcfg, jp, cfg, p = llama
    cfg = cfg.replace(use_kernels=use_kernels)
    ts, js = _specs(pname)
    L = cfg.num_layers
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 40))
    gen = torch.Generator()
    key = jax.random.key(11)
    key, k0 = jax.random.split(key)
    replay.keys.extend(jax.random.split(k0, L))
    jl, jc = _j_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, js, key=k0)
    tl, tc = M.prefill(p, cfg, {"tokens": torch.tensor(toks)}, ts,
                       generator=gen)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL, err_msg="prefill")
    for step in range(N_STEPS):
        fed = np.asarray(jnp.argmax(jl, -1))[:, None]
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), fed[:, 0])
        key, kt = jax.random.split(key)
        replay.keys.extend(jax.random.split(kt, L))
        jl, jc = _j_decode(jp, jcfg, jc, jnp.asarray(fed), js, key=kt)
        tl, _ = M.decode_step(p, cfg, tc, torch.tensor(fed), ts,
                              generator=gen)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL,
                                   err_msg=f"decode step {step}")
        np.testing.assert_array_equal(tc.attn.slot_pos.numpy(),
                                      np.asarray(jc.attn.slot_pos),
                                      err_msg=f"kept rows, step {step}")
    assert replay.calls == L * (1 + N_STEPS) and not replay.keys


# ---------------------------------------------------------------------------
# engine level
# ---------------------------------------------------------------------------

BUCKETS = (32, 48)
MAX_NEW = 8


def _requests(R, vocab, n=3):
    rng = np.random.default_rng(1)
    return [R(tokens=rng.integers(0, vocab, size=BUCKETS[i % 2]).astype(
        np.int32), max_new=MAX_NEW) for i in range(n)]


def _streams(res):
    return [r.tokens.tolist() for r in sorted(res.results,
                                              key=lambda r: r.uid)]


PAGED = dict(paged=True, block_len=8)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("pname", NOISY)
def test_engine_same_seed_same_streams(llama, pname, paged):
    """Two engines on one seed draw the same noise in the same order (the
    double-buffered loop dispatches in a fixed order): equal streams,
    with the temperature sampler drawing from the same generator."""
    jcfg, jp, cfg, p = llama
    kw = dict(prompt_len=max(BUCKETS), max_new=MAX_NEW, slots=2,
              buckets=BUCKETS, device="cpu", seed=5,
              sampler=sampler_lib.temperature(0.8, top_k=8),
              **(PAGED if paged else {}))
    pol = presets(BUDGET, WINDOW)[pname]
    a = Engine(cfg, p, pol, **kw).generate_continuous(
        _requests(Request, cfg.vocab_size))
    b = Engine(cfg, p, pol, **kw).generate_continuous(
        _requests(Request, cfg.vocab_size))
    assert _streams(a) == _streams(b)
    assert all(r.n_tokens == MAX_NEW for r in a.results)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("pname", NOISY)
def test_engine_without_noise_equals_jax(llama, pname, paged):
    """nacl at temperature 0, keyformer at tau 0: neither package draws,
    and the streams equal the JAX engine's token for token."""
    jcfg, jp, cfg, p = llama
    field = "nacl_temperature" if pname == "nacl" else "keyformer_tau"
    pols = []
    for pre in (presets, jax_presets):
        pol = pre(BUDGET, WINDOW)[pname]
        pols.append(dataclasses.replace(
            pol, spec=dataclasses.replace(pol.spec, **{field: 0.0})))
    kw = dict(prompt_len=max(BUCKETS), max_new=MAX_NEW, slots=2,
              buckets=BUCKETS, **(PAGED if paged else {}))
    got = Engine(cfg, p, pols[0], device="cpu", **kw).generate_continuous(
        _requests(Request, cfg.vocab_size))
    want = JaxEngine(jcfg, jp, pols[1], use_kernels=False,
                     **kw).generate_continuous(
        _requests(JaxRequest, cfg.vocab_size))
    assert _streams(got) == _streams(want)
    assert got.decode_steps == want.decode_steps


# ---------------------------------------------------------------------------
# layer-budget signals
# ---------------------------------------------------------------------------


def test_signals_equal_jax():
    r = np.random.default_rng(0)
    mass = r.uniform(size=(4, 3, 40)).astype(np.float32)
    mass[1, 0, :5] = 0.0                    # zero entries: the p > 0 guard
    np.testing.assert_allclose(
        TB.attention_entropy_signal(_t(mass)).numpy(),
        np.asarray(JB.attention_entropy_signal(jnp.asarray(mass))),
        atol=SIGNAL_TOL, rtol=0)
    x_in = r.standard_normal((4, 2, 8, 16)).astype(np.float32)
    x_out = (0.5 * x_in + r.standard_normal(x_in.shape)).astype(np.float32)
    np.testing.assert_allclose(
        TB.layer_cosine_signal(_t(x_in), _t(x_out)).numpy(),
        np.asarray(JB.layer_cosine_signal(jnp.asarray(x_in),
                                          jnp.asarray(x_out))),
        atol=SIGNAL_TOL, rtol=0)


@pytest.mark.parametrize("pname", ["squeeze", "zigzag"])
def test_allocator_signal_layer_budgets_equal_jax(pname):
    """The measured signals (here from the signal functions on random
    inputs, 6 layers) replace the allocators' defaults, in the JAX
    engine's setdefault order: the same layer budgets."""
    jcfg = jax_reduced(jax_get_config("paper-llama-7b"), num_layers=6)
    cfg = reduced(get_config("paper-llama-7b"), num_layers=6)
    jp = JM.init_params(jax.random.key(0), jcfg)
    p = params_from_numpy(jax.tree.map(np.asarray, jp), cfg)
    r = np.random.default_rng(1)
    if pname == "squeeze":
        x_in = r.standard_normal((6, 1, 8, 16)).astype(np.float32)
        # early layers the most similar: the reverse of the default ramp
        scale = np.linspace(3.0, 0.5, 6).reshape(6, 1, 1, 1)
        x_out = (x_in * scale
                 + r.standard_normal(x_in.shape)).astype(np.float32)
        sig = dict(cos_sim=TB.layer_cosine_signal(_t(x_in),
                                                  _t(x_out)).numpy())
    else:
        mass = r.uniform(size=(6, 2, 40)) ** r.uniform(1, 8, (6, 1, 1))
        sig = dict(uncertainty=TB.attention_entropy_signal(
            _t(mass.astype(np.float32))).numpy())
    kw = dict(prompt_len=48, max_new=4, slots=2, allocator_signal=sig)
    got = Engine(cfg, p, presets(64, WINDOW)[pname], device="cpu", **kw)
    want = JaxEngine(jcfg, jp, jax_presets(64, WINDOW)[pname], **kw)
    default = Engine(cfg, p, presets(64, WINDOW)[pname], device="cpu",
                     prompt_len=48, max_new=4, slots=2)
    np.testing.assert_array_equal(got.layer_budgets, want.layer_budgets)
    assert not np.array_equal(got.layer_budgets, default.layer_budgets)
