"""The port's Mamba-2 (SSD) mixer, its state and the state quantizer, and
mamba2-130m, against the JAX package on the CPU.

Everything runs in f32 on the same numpy inputs (JAX parameters cross
over through `repro_torch.bridge`). `ssd_chunked` equals JAX's within
1e-5 + 1e-5 |ref| (the same dual form; einsum orders differ) and both
equal the sequential recurrence within the JAX test's 2e-4 + 1e-3 |ref|,
at whole and ragged chunks and with a carried state. `_causal_conv`,
`mamba2_forward` and `mamba2_decode_step` equal JAX's within 1e-5; the
quantizer's codes equal JAX's exactly, its scales and zeros within 1e-7.
Reduced mamba2's model-level prefill + decode logits equal JAX's within
1e-4 (the bound of tests/test_torch_configs.py), and the serving engine
refuses it with a ValueError where the JAX engine fails with a TypeError
at its first admission."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny shapes; JAX's threads share the cores

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import base as JB
from repro.core import cache as JC
from repro.core import quantization as JQ
from repro.core.policy import presets as jax_presets
from repro.nn import model as JM
from repro.nn import ssm as JS
from repro.serving import Engine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.bridge import (model_cache_from_numpy, params_from_numpy,
                                ssm_state_from_numpy)
from repro_torch.configs import base as TB
from repro_torch.core import cache as TC
from repro_torch.core import quantization as TQ
from repro_torch.core.cache import CacheSpec, SSMState
from repro_torch.core.policy import presets
from repro_torch.launch import serve
from repro_torch.nn import model as M
from repro_torch.nn import ssm as TS
from repro_torch.serving.engine import Engine

ARCH = "mamba2-130m"
PORT_TOL = dict(atol=1e-5, rtol=1e-5)       # port vs JAX, same dual form
NAIVE_TOL = dict(atol=2e-4, rtol=1e-3)      # tests/test_ssm.py's bound
LOGIT_TOL = 1e-4


def naive_ssd(x, dt, A, B_, C_, h=None):
    """Sequential f32 recurrence (numpy, float64 accumulate)."""
    Bsz, T, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    rep = H // G
    Bh, Ch = np.repeat(B_, rep, axis=2), np.repeat(C_, rep, axis=2)
    h = np.zeros((Bsz, H, P, N)) if h is None else np.array(h, np.float64)
    ys = np.zeros((Bsz, T, H, P))
    for t in range(T):
        da = np.exp(dt[:, t] * A[None])
        h = h * da[:, :, None, None] + np.einsum(
            "bh,bhn,bhp->bhpn", dt[:, t], Bh[:, t], x[:, t])
        ys[:, t] = np.einsum("bhn,bhpn->bhp", Ch[:, t], h)
    return ys, h


def _ssd_inputs(seed, Bsz, T, H, P, G, N):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((Bsz, T, H, P)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((Bsz, T, H)) - 1)).astype(f)
    A = (-np.exp(rng.standard_normal(H) * 0.5)).astype(f)
    B_ = (rng.standard_normal((Bsz, T, G, N)) * 0.3).astype(f)
    C_ = (rng.standard_normal((Bsz, T, G, N)) * 0.3).astype(f)
    return x, dt, A, B_, C_


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


SSD_CASES = {"whole-32/8": (32, 8), "whole-64/16": (64, 16),
             "ragged-40/16": (40, 16), "ragged-37/32": (37, 32),
             "shorter-than-chunk-5/8": (5, 8)}


@pytest.mark.parametrize("case", sorted(SSD_CASES))
@pytest.mark.parametrize("carry", [False, True], ids=["zero", "carried"])
def test_ssd_chunked_equals_jax_and_recurrence(case, carry):
    T, chunk = SSD_CASES[case]
    x, dt, A, B_, C_ = _ssd_inputs(T, 2, T, 4, 8, 2, 16)
    h0 = (np.random.default_rng(9).standard_normal((2, 4, 8, 16))
          .astype(np.float32) if carry else None)
    y, fin = TS.ssd_chunked(*_t(x, dt, A, B_, C_), chunk,
                            init_state=None if h0 is None else _t(h0)[0])
    jy, jfin = JS.ssd_chunked(*map(jnp.asarray, (x, dt, A, B_, C_)), chunk,
                              init_state=None if h0 is None
                              else jnp.asarray(h0))
    assert y.dtype == fin.dtype == torch.float32
    assert y.shape == (2, T, 4, 8) and fin.shape == (2, 4, 8, 16)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **PORT_TOL)
    np.testing.assert_allclose(fin.numpy(), np.asarray(jfin), **PORT_TOL)
    ny, nfin = naive_ssd(x, dt, A, B_, C_, h0)
    np.testing.assert_allclose(y.numpy(), ny, **NAIVE_TOL)
    np.testing.assert_allclose(fin.numpy(), nfin, **NAIVE_TOL)


def test_ssd_split_with_carry_equals_one_pass():
    """Two halves with the state carried == one pass (tests/test_ssm.py's
    continuation case, on the port)."""
    x, dt, A, B_, C_ = _ssd_inputs(1, 1, 64, 2, 4, 1, 8)
    xt, dtt, At, Bt, Ct = _t(x, dt, A, B_, C_)
    y_full, fin_full = TS.ssd_chunked(xt, dtt, At, Bt, Ct, 16)
    y1, s1 = TS.ssd_chunked(xt[:, :32], dtt[:, :32], At, Bt[:, :32],
                            Ct[:, :32], 16)
    y2, s2 = TS.ssd_chunked(xt[:, 32:], dtt[:, 32:], At, Bt[:, 32:],
                            Ct[:, 32:], 16, init_state=s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, atol=2e-4,
                               rtol=1e-3)
    torch.testing.assert_close(s2, fin_full, atol=2e-4, rtol=1e-3)


@pytest.fixture(scope="module")
def mixer():
    """(jax cfg, jax mixer params, port cfg, port mixer params) of reduced
    mamba2's mixer (H 16, P 32, N 32, chunk 32), f32."""
    jcfg = JB.reduced(JB.get_config(ARCH))
    cfg = TB.reduced(TB.get_config(ARCH))
    jp = JS.ssm_init(jax.random.key(3), jcfg)
    return jcfg, jp, cfg, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            cfg)


@pytest.mark.parametrize("T", [1, 3, 20])
@pytest.mark.parametrize("init", [False, True], ids=["zero", "carried"])
def test_causal_conv_equals_jax(mixer, T, init):
    jcfg, jp, cfg, p = mixer
    rng = np.random.default_rng(T)
    C = TS.conv_dim(cfg)
    assert C == JS.conv_dim(jcfg)
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    st = (rng.standard_normal((2, cfg.ssm.d_conv - 1, C)).astype(np.float32)
          if init else None)
    y, s = TS._causal_conv(torch.from_numpy(x), p["conv_w"], p["conv_b"],
                           None if st is None else torch.from_numpy(st))
    jy, js = JS._causal_conv(jnp.asarray(x), jp["conv_w"], jp["conv_b"],
                             None if st is None else jnp.asarray(st))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **PORT_TOL)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("T", [1, 20, 45])
@pytest.mark.parametrize("carry", [False, True], ids=["zero", "carried"])
def test_mamba2_forward_equals_jax(mixer, T, carry):
    """Whole and ragged chunks (T 45 over chunk 32; T 1 and 20 shorter
    than one chunk), from the zero state and from a carried one."""
    jcfg, jp, cfg, p = mixer
    rng = np.random.default_rng(T + 100)
    x = rng.standard_normal((2, T, cfg.d_model)).astype(np.float32)
    jst = tst = None
    if carry:
        _, jst = JS.mamba2_forward(jp, jnp.asarray(x[:, ::-1].copy()), jcfg)
        tst = ssm_state_from_numpy(jax.tree.map(np.asarray, jst))
    y, st = TS.mamba2_forward(p, torch.from_numpy(x), cfg, tst)
    jy, jst2 = JS.mamba2_forward(jp, jnp.asarray(x), jcfg, jst)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **PORT_TOL)
    assert isinstance(st, SSMState) and st._fields == jst2._fields
    for f in SSMState._fields:
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   np.asarray(getattr(jst2, f)), **PORT_TOL)


def test_mamba2_decode_step_equals_jax_and_continues_prefill(mixer):
    """Eight decode steps after a 33-token forward equal JAX's steps
    (outputs and states within 1e-5), and the step continues the prefill:
    its output equals a one-token-longer forward's last within 2e-3
    (tests/test_ssm.py's bound)."""
    jcfg, jp, cfg, p = mixer
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 41, cfg.d_model)).astype(np.float32)
    y_full, st_full = TS.mamba2_forward(p, torch.from_numpy(x), cfg)
    _, st = TS.mamba2_forward(p, torch.from_numpy(x[:, :33]), cfg)
    _, jst = JS.mamba2_forward(jp, jnp.asarray(x[:, :33]), jcfg)
    for t in range(33, 41):
        conv0 = st.conv.clone()
        y, st_new = TS.mamba2_decode_step(p, torch.from_numpy(x[:, t:t + 1]),
                                          st, cfg)
        assert torch.equal(st.conv, conv0)            # the input untouched
        jy, jst = JS.mamba2_decode_step(jp, jnp.asarray(x[:, t:t + 1]), jst,
                                        jcfg)
        st = st_new
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **PORT_TOL)
        np.testing.assert_allclose(st.state.numpy(), np.asarray(jst.state),
                                   **PORT_TOL)
        np.testing.assert_allclose(st.conv.numpy(), np.asarray(jst.conv),
                                   **PORT_TOL)
    torch.testing.assert_close(y[:, 0], y_full[:, -1], atol=2e-3, rtol=0)
    torch.testing.assert_close(st.state, st_full.state, atol=2e-3, rtol=0)


# ---------------------------------------------------------------------------
# The state, its surgery and its quantizer
# ---------------------------------------------------------------------------


def test_ssm_state_fields_and_init_equal_jax():
    assert SSMState._fields == JC.SSMState._fields == ("conv", "state")
    j = JC.init_ssm_state(3, 40, 4, 6, 8, 16, dtype=jnp.bfloat16)
    t = TC.init_ssm_state(3, 40, 4, 6, 8, 16, dtype=torch.bfloat16,
                          lead=(2, 5))
    assert t.conv.shape == (2, 5, *j.conv.shape)
    assert t.state.shape == (2, 5, *j.state.shape)
    assert t.conv.dtype == torch.bfloat16 and t.state.dtype == torch.float32
    assert not t.conv.any() and not t.state.any()


def test_insert_and_reset_slot_tree_equal_jax():
    """In place on [n_sb, nS, B, ...] stacks, batch axis 2, as JAX's
    functional scatter / clear."""
    rng = np.random.default_rng(0)
    live = [rng.standard_normal((2, 3, 4, 3, 10)).astype(np.float32),
            rng.standard_normal((2, 3, 4, 2, 5, 6)).astype(np.float32)]
    one = [a[:, :, :1] * 0 + rng.standard_normal(a[:, :, :1].shape)
           .astype(np.float32) for a in live]
    jl = JC.SSMState(*map(jnp.asarray, live))
    tl = SSMState(*_t(*live))
    jl = JC.insert_request_tree(jl, 2, JC.SSMState(*map(jnp.asarray, one)),
                                batch_axis=2)
    out = TC.insert_request_tree(tl, 2, SSMState(*_t(*one)), batch_axis=2)
    assert out is tl
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jl = JC.reset_slot_tree(jl, 1, batch_axis=2)
    TC.reset_slot_tree(tl, 1, batch_axis=2)
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_quantize_ssm_state_equals_jax(bits):
    st = (np.random.default_rng(bits).standard_normal((2, 4, 8, 16)) * 5
          ).astype(np.float32)
    st[0, 1, 2] = 3.0                           # a constant row: zero range
    q = TQ.quantize_ssm_state(torch.from_numpy(st), bits=bits)
    jq = JQ.quantize_ssm_state(jnp.asarray(st), bits=bits)
    np.testing.assert_array_equal(q.q.numpy(), np.asarray(jq.q))
    np.testing.assert_allclose(q.scale.numpy(), np.asarray(jq.scale),
                               atol=1e-7, rtol=0)
    np.testing.assert_array_equal(q.zero.numpy(), np.asarray(jq.zero))
    assert q.scale.shape == (2, 4, 8, 1)
    deq = TQ.dequantize_ssm_state(q)
    assert deq.dtype == torch.float32
    np.testing.assert_allclose(deq.numpy(),
                               np.asarray(JQ.dequantize_ssm_state(jq)),
                               atol=1e-5, rtol=0)
    assert float((deq - torch.from_numpy(st)).abs().max()) <= \
        float(q.scale.max()) / 2 + 1e-5


def test_quantized_state_decode_tracks_exact(mixer):
    """tests/test_ssm_state_quant.py on the port: an int8 state quantized
    after every step stays within 5% of the exact decode."""
    jcfg, jp, cfg, p = mixer
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32))
    _, st = TS.mamba2_forward(p, x[:, :8], cfg)
    st_e = st_q = st
    err = ref = 0.0
    for t in range(8, 24):
        y_e, st_e = TS.mamba2_decode_step(p, x[:, t:t + 1], st_e, cfg)
        y_q, st_q = TS.mamba2_decode_step(p, x[:, t:t + 1], st_q, cfg)
        st_q = SSMState(st_q.conv, TQ.dequantize_ssm_state(
            TQ.quantize_ssm_state(st_q.state, bits=8)))
        err = max(err, float((y_e - y_q).abs().max()))
        ref = max(ref, float(y_e.abs().max()))
    assert err / ref < 0.05, (err, ref)


# ---------------------------------------------------------------------------
# The init scheme and the model
# ---------------------------------------------------------------------------


def test_init_params_follows_the_jax_ssm_scheme():
    """The port's random init of a Mamba-2 mixer: A_log exactly log(1..H),
    D ones, dt_bias the inverse softplus of draws in [dt_min, dt_max]
    (each layer its own), conv_b zeros, the gated norm ones, A_log / D /
    dt_bias f32 in a bf16 model; conv_w std ~ 1/sqrt(d_conv)."""
    cfg = TB.reduced(TB.get_config(ARCH), num_layers=3, dtype=torch.bfloat16)
    s = M.init_params(cfg, seed=0, device="cpu")["blocks"]["sub0"]["ssm"]
    H = cfg.ssm_heads
    for n in ("A_log", "D", "dt_bias"):
        assert s[n].dtype == torch.float32 and s[n].shape == (3, H)
    assert torch.equal(s["A_log"][1], torch.log(torch.arange(
        1, H + 1, dtype=torch.float32)))
    assert torch.equal(s["D"], torch.ones(3, H))
    dt = torch.nn.functional.softplus(s["dt_bias"])
    assert float(dt.min()) >= cfg.ssm.dt_min * (1 - 1e-4)
    assert float(dt.max()) <= cfg.ssm.dt_max * (1 + 1e-4)
    assert not torch.equal(s["dt_bias"][0], s["dt_bias"][1])
    assert not s["conv_b"].any() and s["conv_b"].dtype == torch.bfloat16
    assert torch.equal(s["norm"]["scale"].float(), torch.ones(3, cfg.d_inner))
    std = float(s["conv_w"].float().std())
    assert abs(std - cfg.ssm.d_conv ** -0.5) < 0.1 * cfg.ssm.d_conv ** -0.5


@pytest.fixture(scope="module")
def model():
    jcfg = JB.reduced(JB.get_config(ARCH))
    cfg = TB.reduced(TB.get_config(ARCH))
    jp = JM.init_params(jax.random.key(0), jcfg)
    return jcfg, jp, cfg, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            cfg)


def test_model_prefill_and_decode_equal_jax(model):
    """Reduced mamba2 (2 layers, tied head, no FFN): prefill of a ragged
    45-token prompt (chunk 32) and 5 greedy decode steps; logits within
    1e-4, the cache has no attention part, its SSM stacks [2, 1, B, ...]
    equal JAX's; a decode step from a JAX-built cache (`bridge`) also
    continues JAX's."""
    jcfg, jp, cfg, p = model
    assert M.sb_layout(cfg) == JM.sb_layout(jcfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 45))
    spec, jspec = CacheSpec(budget=64), JC.CacheSpec(budget=64)
    lg, c = M.prefill(p, cfg, {"tokens": torch.as_tensor(toks)}, spec)
    jlg, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, jspec)
    assert c.attn is None and jc.attn is None
    assert c.ssm.state.shape == jc.ssm.state.shape == (2, 1, 2, 16, 32, 32)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=LOGIT_TOL,
                               rtol=0)
    bc = model_cache_from_numpy(jax.tree.map(np.asarray, jc))
    for _ in range(5):
        tok = np.asarray(jnp.argmax(jlg, -1))[:, None]
        lg, c = M.decode_step(p, cfg, c, torch.as_tensor(tok), spec)
        blg, bc = M.decode_step(p, cfg, bc, torch.as_tensor(tok), spec)
        jlg, jc = JM.decode_step(jp, jcfg, jc, jnp.asarray(tok), jspec)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg),
                                   atol=LOGIT_TOL, rtol=0)
        np.testing.assert_allclose(blg.numpy(), np.asarray(jlg),
                                   atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(c.ssm.state.numpy(), np.asarray(jc.ssm.state),
                               atol=1e-5, rtol=1e-5)


def test_decode_refuses_append_mask_as_jax(model):
    jcfg, jp, cfg, p = model
    c = M.init_cache(cfg, CacheSpec(budget=16), 2, 16, device="cpu")
    assert c.attn is None and c.ssm.conv.shape[:3] == (2, 1, 2)
    with pytest.raises(ValueError) as e:
        M.decode_step(p, cfg, c, torch.zeros(2, 1, dtype=torch.long),
                      CacheSpec(budget=16),
                      append_mask=torch.ones(2, dtype=torch.bool))
    jc = JM.init_cache(jcfg, JC.CacheSpec(budget=16), 2, 16)
    with pytest.raises(ValueError) as je:
        JM.decode_step(jp, jcfg, jc, jnp.zeros((2, 1), jnp.int32),
                       JC.CacheSpec(budget=16),
                       append_mask=jnp.ones(2, bool))
    assert str(e.value) == str(je.value)


def test_engine_refuses_mamba2_where_jax_fails(model):
    """No attention layer: the port's engine refuses at construction (a
    deliberate difference), the JAX engine builds and then fails at the
    first admission with the reshape of its empty budget array."""
    jcfg, jp, cfg, p = model
    kw = dict(prompt_len=32, max_new=4, slots=2)
    with pytest.raises(ValueError, match="needs an attention layer"):
        Engine(cfg, p, presets(32, 8)["full"], device="cpu", **kw)
    jeng = JaxEngine(jcfg, jp, jax_presets(32, 8)["full"], use_kernels=False,
                     **kw)
    with pytest.raises(TypeError, match="reshape"):
        jeng.generate_continuous([JaxRequest(
            tokens=np.zeros(32, np.int32), max_new=4)])


def test_cli_refuses_mamba2():
    """`--arch mamba2-130m --reduced` passes the config through and the
    engine refuses it with its message."""
    with pytest.raises(ValueError, match="needs an attention layer"):
        serve.main(["--arch", ARCH, "--reduced", "--policy", "full",
                    "--requests", "2", "--prompt-len", "16", "--max-new",
                    "2", "--slots", "2", "--continuous", "--device", "cpu"])
