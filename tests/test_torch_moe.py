"""The port's mixture-of-experts decoders (mixtral-8x22b, kimi-k2-1t-a32b)
against the JAX package on the CPU.

`nn.moe.moe_apply` (capacity sort dispatch) and `moe_apply_dense` (the
soft-dispatch oracle) equal JAX's on the same inputs: outputs within
1e-5, drop fractions exact, expert loads within 1e-7 (the two softmaxes
sum in different orders, an ulp apart), including kimi's real 384
experts / top 8 at capacity 1.25, where a decode step's 8 tokens get one
row an expert. The configs' fields and sizes equal JAX's. At each
config's real head group (reduced, 2 layers, f32, D 128, the same
weights through `repro_torch.bridge`; mixtral's window cut to 64 as
`reduced` does, prompts past it) `Engine.generate_continuous` streams
are token-equal to the JAX engine's for full, h2o and kivi2, dense and
paged (monolithic admission), and with capacity 1.25 over more experts
than slots, where drops couple the slots of a step. Chunked prefill,
prefix sharing and speculative decoding refuse experts with JAX's
messages, and the serving CLI serves both archs with the JAX CLI's
streams."""
import dataclasses
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny shapes; JAX's threads share the cores

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import base as JB
from repro.core.policy import presets as jax_presets
from repro.launch import serve as jax_serve
from repro.nn import model as JM
from repro.nn import moe as JMoE
from repro.serving import Engine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import base as TB
from repro_torch.core.policy import presets
from repro_torch.launch import serve
from repro_torch.nn import model as M
from repro_torch.nn import moe as TMoE
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import Request

MOE_ARCHS = ("mixtral-8x22b", "kimi-k2-1t-a32b")
# reduced at each config's real Gq and D (2 KV heads where the real one
# has 8)
REAL_GQ = {"mixtral-8x22b": dict(num_heads=12, num_kv_heads=2,
                                 head_dim=128),                  # Gq 6
           "kimi-k2-1t-a32b": dict(num_heads=16, num_kv_heads=2,
                                   head_dim=128)}                # Gq 8
BUDGET, WINDOW, L_PROMPT, NEW, N_REQ = 32, 8, 96, 6, 5
OUT_TOL = 1e-5


# ---------------------------------------------------------------------------
# The MoE FFN
# ---------------------------------------------------------------------------


def _moe_pair(E, Dm, F, seed=0):
    """(jax params, port params) of one MoE FFN."""
    jp = JMoE.moe_init(jax.random.key(seed), Dm, F, E, jnp.float32)
    return jp, {n: torch.from_numpy(np.array(v)) for n, v in jp.items()}


MOE_CASES = {
    # tests/test_moe.py's drop-free case: dispatch == dense
    "drop-free": dict(E=4, k=2, Dm=32, F=64, shape=(2, 16), cf=4.0),
    # tests/test_moe.py's tight factor on identical tokens
    "identical-cf0.5": dict(E=4, k=2, Dm=32, F=64, shape=(1, 32), cf=0.5,
                            ones=True),
    # kimi's real routing at a decode step of 8 slots: cap 1, drops
    "kimi-384x8-decode": dict(E=384, k=8, Dm=64, F=32, shape=(8, 1),
                              cf=1.25),
    # mixtral's 8 experts top 2 at capacity 1.25: cap 3 over 16 rows
    "mixtral-8x2-cf1.25": dict(E=8, k=2, Dm=64, F=32, shape=(8, 2),
                               cf=1.25),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_apply_equals_jax(case):
    c = MOE_CASES[case]
    rng = np.random.default_rng(1)
    x = (np.ones((*c["shape"], c["Dm"]), np.float32) if c.get("ones")
         else rng.standard_normal((*c["shape"], c["Dm"])).astype(np.float32))
    jp, tp = _moe_pair(c["E"], c["Dm"], c["F"])
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    jy, ja = JMoE.moe_apply(jp, xj, top_k=c["k"], capacity_factor=c["cf"])
    ty, ta = TMoE.moe_apply(tp, xt, top_k=c["k"], capacity_factor=c["cf"])
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=OUT_TOL,
                               rtol=OUT_TOL)
    assert float(ta.drop_fraction) == float(ja.drop_fraction)
    np.testing.assert_allclose(ta.expert_load.numpy(),
                               np.asarray(ja.expert_load), atol=1e-7, rtol=0)
    for f in ("load_balance_loss", "router_z_loss"):
        np.testing.assert_allclose(float(getattr(ta, f)),
                                   float(getattr(ja, f)), rtol=1e-5)
    N = int(np.prod(c["shape"]))
    cap = TMoE.capacity(N, c["k"], c["E"], c["cf"])
    if case == "kimi-384x8-decode":
        assert cap == 1 and float(ta.drop_fraction) > 0
    if case == "drop-free":
        assert float(ta.drop_fraction) == 0.0
    if case == "identical-cf0.5":
        assert float(ta.drop_fraction) > 0.0
    # the oracle
    jy, ja = JMoE.moe_apply_dense(jp, xj, top_k=c["k"])
    dy, da = TMoE.moe_apply_dense(tp, xt, top_k=c["k"])
    np.testing.assert_allclose(dy.numpy(), np.asarray(jy), atol=OUT_TOL,
                               rtol=OUT_TOL)
    assert float(da.drop_fraction) == 0.0
    if float(ta.drop_fraction) == 0.0:
        np.testing.assert_allclose(ty.numpy(), dy.numpy(), atol=1e-4,
                                   rtol=1e-4)


def test_moe_drop_fraction_is_the_host_count():
    """The drop fraction equals what the host counts from the routing:
    assignments past each expert's `capacity` rows, in token order."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((8, 1, 64)).astype(np.float32))
    _, tp = _moe_pair(384, 64, 32)
    _, aux = TMoE.moe_apply(tp, x, top_k=8, capacity_factor=1.25)
    _, _, _, top_idx = TMoE._route(tp, x, 8)
    cap = TMoE.capacity(8, 8, 384, 1.25)
    seen: dict = {}
    dropped = 0
    for e in top_idx.reshape(-1).tolist():
        seen[e] = seen.get(e, 0) + 1
        dropped += seen[e] > cap
    assert float(aux.drop_fraction) == pytest.approx(dropped / 64, abs=1e-7)


# ---------------------------------------------------------------------------
# The configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_config_fields_and_sizes_equal_jax(arch):
    cfg, jcfg = TB.get_config(arch), JB.get_config(arch)
    for f in dataclasses.fields(TB.ModelConfig):
        if f.name == "dtype":
            assert cfg.dtype == torch.bfloat16 and jcfg.dtype == jnp.bfloat16
        elif f.name == "moe":
            assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(jcfg.moe)
        elif f.name != "use_kernels":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.is_moe and jcfg.is_moe
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert cfg.active_param_count() < cfg.param_count()
    for bpe in (2.0, 0.25):
        assert cfg.kv_bytes_per_token(bpe) == jcfg.kv_bytes_per_token(bpe)
    assert [cfg.ffn_kind(i) for i in range(cfg.num_layers)] == \
        [jcfg.ffn_kind(i) for i in range(jcfg.num_layers)]
    assert [cfg.layer_kind(i) for i in range(cfg.num_layers)] == \
        [jcfg.layer_kind(i) for i in range(jcfg.num_layers)]
    assert M.sb_layout(cfg) == JM.sb_layout(jcfg)
    assert M.ssm_positions(cfg) == JM.ssm_positions(jcfg) == []
    over = REAL_GQ[arch]
    r, jr = TB.reduced(cfg, **over), JB.reduced(jcfg, **over)
    assert dataclasses.asdict(r.moe) == dataclasses.asdict(jr.moe)
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
              "vocab_size", "head_dim", "sliding_window", "arch_type"):
        assert getattr(r, f) == getattr(jr, f), f
    assert r.param_count() == jr.param_count()
    assert r.active_param_count() == jr.active_param_count()


def test_moe_archs_registered_in_jax_order():
    port = TB.all_configs()
    assert list(port) == [a for a in JB.ARCH_IDS if a in port] == TB.ARCH_IDS
    assert set(MOE_ARCHS) <= set(port)
    jall = JB.all_configs()
    for a in MOE_ARCHS:
        assert port[a] is TB.get_config(a)
        assert port[a].param_count() == jall[a].param_count()


def test_bridge_keeps_router_f32_in_bf16_model():
    jcfg = JB.reduced(JB.get_config("mixtral-8x22b"), dtype=jnp.bfloat16)
    cfg = TB.reduced(TB.get_config("mixtral-8x22b"), dtype=torch.bfloat16)
    jp = JM.init_params(jax.random.key(0), jcfg)
    p = params_from_numpy(jax.tree.map(np.asarray, jp), cfg)
    moe = p["blocks"]["sub0"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert jp["blocks"]["sub0"]["moe"]["router"].dtype == jnp.float32
    for n in ("gate", "up", "down"):
        assert moe[n].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        moe["router"].numpy(), np.asarray(jp["blocks"]["sub0"]["moe"]["router"]))
    assert p["blocks"]["sub0"]["attn"]["wq"]["w"].dtype == torch.bfloat16


def test_init_params_builds_the_jax_moe_tree():
    """The port's random init: the JAX tree's leaves, shapes and dtypes
    (router f32 in a bf16 model, experts one draw each)."""
    jcfg = JB.reduced(JB.get_config("kimi-k2-1t-a32b"), dtype=jnp.bfloat16)
    cfg = TB.reduced(TB.get_config("kimi-k2-1t-a32b"), dtype=torch.bfloat16)
    jp = jax.eval_shape(lambda: JM.init_params(jax.random.key(0), jcfg))
    p = M.init_params(cfg, seed=0, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    flat_t = {}

    def walk(t, pre):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, pre + (k,))
            else:
                flat_t[pre + (k,)] = v
    walk(p, ())
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        key = tuple(k.key for k in path)
        t = flat_t[key]
        assert tuple(t.shape) == tuple(leaf.shape), key
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), key
    gate = p["blocks"]["sub0"]["moe"]["gate"]
    assert not torch.equal(gate[0, 0], gate[0, 1])   # experts drawn apart
    std = float(gate.float().std())
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5


# ---------------------------------------------------------------------------
# The gates: chunked prefill, prefix sharing and speculation refuse MoE
# ---------------------------------------------------------------------------


def _verdict(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


ENGINE_GATES = {"chunked": dict(chunked_prefill=True, chunk_len=16),
                "prefix": dict(paged=True, prefix_sharing=True),
                "speculative": dict(speculative=True, gamma=2,
                                    draft_policy="same")}


_GATE_MODELS: dict = {}


@pytest.mark.parametrize("gate", sorted(ENGINE_GATES))
@pytest.mark.parametrize("arch", TB.ARCH_IDS)
def test_engine_gates_give_jax_verdict(arch, gate):
    """Every config the port knows: `_check_chunkable` and the engine
    options built on it refuse exactly where JAX refuses, with its
    message (the speculative gate is the chunking gate, prefixed)."""
    if arch not in _GATE_MODELS:
        jcfg = JB.reduced(JB.get_config(arch))
        cfg = TB.reduced(TB.get_config(arch))
        jp = JM.init_params(jax.random.key(0), jcfg)
        _GATE_MODELS[arch] = (jcfg, jp, cfg, params_from_numpy(
            jax.tree.map(np.asarray, jp), cfg))
    jcfg, jp, cfg, p = _GATE_MODELS[arch]
    assert _verdict(lambda: M._check_chunkable(cfg)) == \
        _verdict(lambda: JM._check_chunkable(jcfg))
    assert _verdict(lambda: M._check_speculable(cfg)) == \
        _verdict(lambda: JM._check_speculable(jcfg))
    kw = dict(prompt_len=64, max_new=4, slots=2, **ENGINE_GATES[gate])
    want = _verdict(lambda: JaxEngine(jcfg, jp, jax_presets(32, 8)["full"],
                                      **kw))
    got = _verdict(lambda: Engine(cfg, p, presets(32, 8)["full"],
                                  device="cpu", **kw))
    assert got == want
    assert (want is not None) == cfg.is_moe


# ---------------------------------------------------------------------------
# The engine at the configs' real Gq / D
# ---------------------------------------------------------------------------


_MODELS: dict = {}


def _model(key):
    """(jax cfg, jax params, port cfg, port params), built once. `key`:
    an arch, or (arch, "drops"): capacity 1.25 over 8 experts top 2."""
    if key not in _MODELS:
        arch = key if isinstance(key, str) else key[0]
        jcfg = JB.reduced(JB.get_config(arch), **REAL_GQ[arch])
        cfg = TB.reduced(TB.get_config(arch), **REAL_GQ[arch])
        if not isinstance(key, str):
            jcfg = jcfg.replace(moe=dataclasses.replace(
                jcfg.moe, num_experts=8, capacity_factor=1.25))
            cfg = cfg.replace(moe=dataclasses.replace(
                cfg.moe, num_experts=8, capacity_factor=1.25))
        jp = JM.init_params(jax.random.key(0), jcfg)
        _MODELS[key] = (jcfg, jp, cfg, params_from_numpy(
            jax.tree.map(np.asarray, jp), cfg))
    return _MODELS[key]


def _run(model, pname, *, jax_side, **kw):
    jcfg, jp, cfg, p = model
    args = dict(prompt_len=L_PROMPT, max_new=NEW, slots=2, block_len=8,
                buckets=(L_PROMPT - 16, L_PROMPT), **kw)
    if jax_side:
        eng = JaxEngine(jcfg, jp, jax_presets(BUDGET, WINDOW)[pname],
                        use_kernels=False, **args)
        R = JaxRequest
    else:
        eng = Engine(cfg, p, presets(BUDGET, WINDOW)[pname], device="cpu",
                     **args)
        R = Request
    rng = np.random.default_rng(5)
    lens = [L_PROMPT if i % 2 == 0 else L_PROMPT - 16 for i in range(N_REQ)]
    res = eng.generate_continuous([
        R(tokens=rng.integers(0, cfg.vocab_size, size=n).astype(np.int32),
          max_new=NEW) for n in lens])
    if eng.paged and not jax_side:
        assert eng.last_audit is not None and eng.last_audit["clean"]
    return res


def _assert_streams(got, want, label):
    assert [r.uid for r in got.results] == [r.uid for r in want.results]
    for g, w in zip(got.results, want.results):
        np.testing.assert_array_equal(g.tokens, w.tokens, err_msg=label)
        assert g.finish_reason == w.finish_reason, label
    assert got.decode_steps == want.decode_steps, label


MODES = {"dense": {}, "paged": dict(paged=True)}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("pname", ["full", "h2o", "kivi2"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_streams_equal_jax(arch, pname, mode):
    model = _model(arch)
    cfg = model[2]
    assert L_PROMPT > cfg.sliding_window or not cfg.sliding_window
    want = _run(model, pname, jax_side=True, **MODES[mode])
    got = _run(model, pname, jax_side=False, **MODES[mode])
    _assert_streams(got, want, f"{arch} {pname} {mode}")
    assert got.cache_physical_bytes == want.cache_physical_bytes


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_capacity_drops_couple_slots_as_in_jax(arch, mode, monkeypatch):
    """Capacity 1.25 over 8 experts, top 2, 2 slots: a decode step routes
    4 assignments into 1 row an expert, so two slots that pick one expert
    drop a token, and a prefill bucket drops past ceil(0.3125 T) rows."""
    model = _model((arch, "drops"))
    assert TMoE.capacity(2, 2, 8, 1.25) == 1
    want = _run(model, "kivi2", jax_side=True, **MODES[mode])
    drops = {"decode": [], "prefill": []}
    apply = TMoE.moe_apply

    def counted(p, x, **kw):
        y, aux = apply(p, x, **kw)
        drops["decode" if x.shape[1] == 1 else "prefill"].append(
            float(aux.drop_fraction))
        return y, aux

    monkeypatch.setattr(TMoE, "moe_apply", counted)
    got = _run(model, "kivi2", jax_side=False, **MODES[mode])
    _assert_streams(got, want, f"{arch} drops {mode}")
    assert max(drops["decode"]) > 0 and max(drops["prefill"]) > 0


# ---------------------------------------------------------------------------
# The serving CLI
# ---------------------------------------------------------------------------


def _cli_args(arch):
    return ["--arch", arch, "--reduced", "--policy", "h2o", "--budget", "32",
            "--window", "8", "--requests", "3", "--max-new", "4",
            "--slots", "2", "--continuous", "--buckets", "80,96"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_cli_serves_moe_with_jax_streams(arch, monkeypatch, capsys):
    """`--arch mixtral-8x22b / kimi-k2-1t-a32b --reduced --continuous`:
    the port's CLI on the JAX CLI's weights gives the JAX CLI's streams;
    `--chunked-prefill` and `--prefix-sharing` refuse with JAX's
    message."""
    got_j = {}

    class Capture(jax_serve.Engine):
        def generate_continuous(self, *a, **k):
            got_j["res"] = super().generate_continuous(*a, **k)
            return got_j["res"]

    monkeypatch.setattr(jax_serve, "Engine", Capture)
    monkeypatch.setattr(sys, "argv", ["serve", *_cli_args(arch),
                                      "--use-kernels", "off"])
    jax_serve.main()
    jcfg = JB.reduced(JB.get_config(arch))
    cfg = TB.reduced(TB.get_config(arch))
    jp = JM.init_params(jax.random.key(0), jcfg)
    monkeypatch.setattr(serve.M, "init_params",
                        lambda c, seed, device: params_from_numpy(
                            jax.tree.map(np.asarray, jp), cfg, device))
    _, res = serve.main(_cli_args(arch) + ["--device", "cpu"])
    want = got_j["res"]
    assert len(res.results) == len(want.results) == 3
    for g, w in zip(res.results, want.results):
        np.testing.assert_array_equal(g.tokens, w.tokens)
    out = capsys.readouterr().out
    assert "requests=3" in out
    for flag in (["--chunked-prefill", "--chunk-len", "16"],
                 ["--paged", "--prefix-sharing"]):
        want_msg = _verdict(lambda: JM._check_chunkable(jcfg))
        with pytest.raises(ValueError) as e:
            serve.main(_cli_args(arch) + ["--device", "cpu", *flag])
        assert str(e.value) == want_msg
