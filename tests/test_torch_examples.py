"""The port's example twins (`examples/torch_*.py`) against the JAX package's
examples on the CPU: each JAX example runs its own `main` (its Engine,
`copy_accuracy` and jitted train step wrapped to record what they
return), and its twin's work function gets the same parameters through
`repro_torch.bridge` (f32 throughout; the reduced and tiny configs are
f32):

  * quickstart and serve_compressed: equal compression ratios and equal
    greedy token streams per policy (serve_compressed's nacl with its
    Gumbel draws set to zeros in both packages: each package draws from
    its own bit generator, and tests/test_torch_noise.py holds the port
    to JAX's draws);
  * longcontext_needle: equal `copy_accuracy` per (policy, budget, depth)
    on the parameters the JAX example trains for a few steps;
  * train_tiny: per-step ce, loss and grad norm within LOSS_TOL
    (tests/test_torch_train.py's), and the twin's checkpoint read by the
    JAX package's `load_pytree` into f32 leaves equal to the twin's
    state and within the train-step tolerance of the JAX example's.
"""
import importlib.util
import os
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny shapes; JAX's threads share the cores

import jax
import jax.numpy as jnp
import numpy as np

from repro.checkpoint import load_pytree as jax_load
from repro.configs import base as JB
from repro.data.synthetic import lm_batches as jax_batches
from repro.nn import model as JM
from repro.optim import cosine_schedule as jax_cosine
from repro.optim import wsd_schedule as jax_wsd
from repro.train import loop as JL
from repro_torch import bridge
from repro_torch.configs import base as TB
from repro_torch.core import cache as TC
from repro_torch.optim.optimizers import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
LOSS_TOL = 1e-5                        # tests/test_torch_train.py
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)  # its one-step params tolerance


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bridged(jp, cfg):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, jp), cfg)


def _recording_engine(mod, got):
    class Recording(mod.Engine):
        def generate(self, *a, **k):
            res = super().generate(*a, **k)
            got[self.policy.name] = res
            return res
    return Recording


class _JitRecorder:
    """Stands in for the `jax` module of a JAX example: `jit` wraps the
    compiled step so each call's StepMetrics are kept as floats."""

    def __init__(self):
        self.metrics = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kw):
        f = jax.jit(fn, **kw)

        def step(state, batch):
            state, m = f(state, batch)
            self.metrics.append(type(m)(*(float(v) for v in m)))
            return state, m
        return step


def _assert_streams_equal(jres, tres, names):
    for name in names:
        assert tres[name].compression_ratio == pytest.approx(
            jres[name].compression_ratio, rel=1e-12), name
        np.testing.assert_array_equal(tres[name].tokens,
                                      np.asarray(jres[name].tokens),
                                      err_msg=name)


def test_quickstart_twin_equals_jax(monkeypatch):
    jq, tq = _load("quickstart"), _load("torch_quickstart")
    got = {}
    monkeypatch.setattr(jq, "Engine", _recording_engine(jq, got))
    jq.main()
    jcfg = JB.reduced(JB.get_config("paper-llama-7b"), num_layers=4)
    cfg = TB.reduced(TB.get_config("paper-llama-7b"), num_layers=4)
    out = tq.run(cfg, _bridged(JM.init_params(jax.random.key(0), jcfg), cfg),
                 CPU)
    assert tuple(got) == tq.POLICIES == tuple(out)
    _assert_streams_equal(got, out, tq.POLICIES)
    assert out["h2o+kivi2"].compression_ratio > 1


SERVE_ARGV = ["--requests", "4", "--prompt-len", "64", "--max-new", "6",
              "--budget", "32"]


def test_serve_compressed_twin_equals_jax(monkeypatch):
    js, ts = _load("serve_compressed"), _load("torch_serve_compressed")
    got = {}
    with monkeypatch.context() as m:
        # no Gumbel noise in either package for nacl; traces made with
        # the real draw are dropped first and the zero-draw ones after
        m.setattr(js, "Engine", _recording_engine(js, got))
        m.setattr(sys, "argv", ["serve_compressed.py", *SERVE_ARGV])
        m.setattr(jax.random, "gumbel",
                  lambda key, shape, dtype=jnp.float32: jnp.zeros(shape,
                                                                  dtype))
        m.setattr(TC, "gumbel",
                  lambda shape, generator, device: torch.zeros(
                      shape, device=device))
        jax.clear_caches()
        try:
            js.main()
            cfg = TB.reduced(TB.get_config("paper-llama-7b"), num_layers=4)
            jp = JM.init_params(jax.random.key(0), JB.reduced(
                JB.get_config("paper-llama-7b"), num_layers=4))
            out = ts.run(cfg, _bridged(jp, cfg), CPU, requests=4,
                         prompt_len=64, max_new=6, budget=32)
        finally:
            jax.clear_caches()
    names = ts.DEFAULT_POLICIES.split(",")
    assert list(got) == names == list(out)
    _assert_streams_equal(got, out, names)
    # the quantized and layer-budget presets compress past eviction alone
    assert out["kivi2"].compression_ratio > out["h2o"].compression_ratio > 1


def test_serve_compressed_twin_cli_runs_on_cpu(capsys):
    ts = _load("torch_serve_compressed")
    out = ts.main(["--policies", "full,pyramid", "--requests", "2",
                   "--prompt-len", "32", "--max-new", "3", "--budget", "16",
                   "--device", "cpu"])
    text = capsys.readouterr().out
    assert "arch=paper-llama-7b (reduced) requests=2" in text
    assert "pyramid      attention" in text
    assert set(out) == {"full", "pyramid"}


def test_needle_twin_equals_jax(monkeypatch):
    jn, tn = _load("longcontext_needle"), _load("torch_longcontext_needle")
    calls = []

    def recording(cfg, params, spec, prompt, value, layer_budgets=None):
        acc = jn_copy(cfg, params, spec, prompt, value, layer_budgets)
        calls.append((params, acc))
        return acc

    jn_copy = jn.copy_accuracy
    monkeypatch.setattr(jn, "copy_accuracy", recording)
    monkeypatch.setattr(sys, "argv", ["longcontext_needle.py",
                                      "--train-steps", "4", "--length", "96"])
    jn.main()
    cfg = tn.tiny_config()
    table = tn.run(cfg, _bridged(calls[0][0], cfg), CPU, length=96)
    assert len(table) == len(calls) == 8
    assert [a for _, a in calls] == list(table.values())
    assert all(0.0 <= a <= 1.0 for a in table.values())


def test_needle_twin_trains_like_jax():
    """The twin's own training loop against JAX's on the same weights:
    the third step's ce within LOSS_TOL."""
    tn = _load("torch_longcontext_needle")
    cfg = tn.tiny_config()
    jcfg = JB.reduced(JB.get_config("paper-llama-7b"), num_layers=4,
                      d_model=256, num_heads=4, num_kv_heads=4, d_ff=512,
                      vocab_size=512)
    jp = JM.init_params(jax.random.key(0), jcfg)
    rec = _JitRecorder()
    init, step = JL.make_train_step(jcfg, jax_cosine(3e-3, 10, 200))
    st, jstep, data = init(jp), rec.jit(step), jax_batches(jcfg, 8, 128,
                                                           seed=0)
    for _ in range(3):
        st, _ = jstep(st, {k: jnp.asarray(v) for k, v in next(data).items()})
    _, ce = tn.train(cfg, _bridged(jp, cfg), CPU, 3)
    np.testing.assert_allclose(ce, rec.metrics[-1].ce_loss, rtol=LOSS_TOL)


def test_train_tiny_twin_equals_jax(monkeypatch, tmp_path):
    jt, tt = _load("train_tiny"), _load("torch_train_tiny")
    rec = _JitRecorder()
    monkeypatch.setattr(jt, "jax", rec)
    steps, batch, seq = 3, 2, 32
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    monkeypatch.setattr(sys, "argv", [
        "train_tiny.py", "--steps", str(steps), "--batch", str(batch),
        "--seq", str(seq), "--ckpt", jdir])
    jt.main()
    cfg = tt.preset_config("tiny")
    jcfg = JB.reduced(JB.get_config("paper-llama-7b"), num_layers=4,
                      d_model=256, num_heads=4, num_kv_heads=4, d_ff=512,
                      vocab_size=512)
    jp = JM.init_params(jax.random.key(0), jcfg)
    state, hist = tt.run(cfg, _bridged(jp, cfg), CPU, steps=steps,
                         batch=batch, seq=seq, ckpt=tdir)
    assert len(hist) == len(rec.metrics) == steps
    for got, want in zip(hist, rec.metrics):
        for f in ("loss", "ce_loss", "grad_norm", "lr"):
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       rtol=LOSS_TOL, atol=1e-7, err_msg=f)
    assert hist[-1].ce_loss < hist[0].ce_loss
    # the twin's checkpoint through the JAX package's loader
    lr = jax_wsd(3e-3, warmup=20, stable=steps // 2, decay=steps // 3)
    template = JL.make_train_step(jcfg, lr)[0](jp)
    loaded = jax_load(template, tdir)
    leaves = jax.tree.leaves(loaded.params)
    assert leaves and all(x.dtype == jnp.float32 for x in leaves)
    for got, want in zip(leaves, tree_leaves(state.params)):
        np.testing.assert_array_equal(np.asarray(got), want.numpy())
    assert int(loaded.step) == steps
    for got, want in zip(leaves,
                         jax.tree.leaves(jax_load(template, jdir).params)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   **PARAM_TOL)
