"""The port's training path against the JAX package on the CPU (reduced
configs, f32, the same weights through `repro_torch.bridge`, the same
numpy batches):

  * `train_forward` logits within 1e-4 and the MoE aux losses within
    1e-5 for every config of `ARCH_IDS`;
  * `loss_fn` within 1e-5 and every leaf's gradient within GRAD_TOL of
    that leaf's largest |JAX gradient| for granite-8b, seamless and
    mixtral;
  * `clip_by_global_norm`, `adamw` and `apply_updates` fed JAX's
    gradients (f32 and bf16 params), both schedules at steps 0..N, and
    one whole `make_train_step` step (metrics within LOSS_TOL, params
    within 1e-5, the first moment within GRAD_TOL) for granite-8b,
    seamless, mixtral-8x22b, mamba2-130m and jamba-v0.1-52b;
  * the port's own two-step smoke for the other configs, and
    `train_forward` differentiable with `use_kernels=True` while every
    kernel wrapper raises if called;
  * checkpoints: f32 round trips across the two packages both ways with
    equal manifests, and a bf16 state that JAX's loader cannot restore
    and the port's restores bit for bit.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # tiny shapes; JAX's threads share the cores

import jax
import jax.numpy as jnp
import numpy as np

from repro.checkpoint import load_pytree as jax_load
from repro.checkpoint import save_pytree as jax_save
from repro.configs import base as JB
from repro.nn import model as JM
from repro.optim import adamw as jax_adamw
from repro.optim import apply_updates as jax_apply
from repro.optim import clip_by_global_norm as jax_clip
from repro.optim import cosine_schedule as jax_cosine
from repro.optim import wsd_schedule as jax_wsd
from repro.train import loop as JL
from repro_torch import bridge
from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.configs import base as TB
from repro_torch.data.synthetic import lm_batches
from repro_torch.kernels.decode_qattn import ops as dq_ops
from repro_torch.kernels.flash_prefill import ops as fp_ops
from repro_torch.kernels.kvquant import ops as kvq_ops
from repro_torch.launch import train as train_cli
from repro_torch.nn import model as M
from repro_torch.optim import (adamw, apply_updates, clip_by_global_norm,
                               cosine_schedule, wsd_schedule)
from repro_torch.optim.optimizers import (adamw_step_, clip_scale,
                                          global_norm, tree_leaves, tree_map)
from repro_torch.train import loop as TL

LOGIT_TOL = 1e-4
AUX_TOL = 1e-5
LOSS_TOL = 1e-5
# a leaf's gradient against JAX's: |got - want| <= GRAD_TOL * max|want|
# (f32 sums in another order; the largest entries set the scale)
GRAD_TOL = 1e-4
OPT_TOL = dict(rtol=1e-6, atol=1e-7)
BATCH, SEQ = 2, 16
_MODELS: dict = {}


def _model(arch):
    if arch not in _MODELS:
        jcfg = JB.reduced(JB.get_config(arch))
        cfg = TB.reduced(TB.get_config(arch))
        jp = JM.init_params(jax.random.key(0), jcfg)
        _MODELS[arch] = (jcfg, jp, cfg, bridge.params_from_numpy(
            jax.tree.map(np.asarray, jp), cfg))
    return _MODELS[arch]


def _batch(cfg, seed=0):
    return next(lm_batches(cfg, BATCH, SEQ, seed=seed))


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _flat(tree):
    """JAX-ordered (path, numpy) pairs of a nested dict."""
    return [(jax.tree_util.keystr(k), np.asarray(v)) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _assert_tree_close(got, want, scaled=None, **tol):
    """Leaf by leaf; `scaled`: |got - want| <= scaled * max|want| of the
    leaf instead of `tol`."""
    g, w = _flat(tree_map(lambda t: t.detach().numpy(), got)), _flat(want)
    assert [k for k, _ in g] == [k for k, _ in w]
    for (k, a), (_, b) in zip(g, w):
        if scaled is not None:
            tol = dict(atol=scaled * np.abs(b).max(), rtol=0)
        np.testing.assert_allclose(a, b, err_msg=k, **tol)


def test_synthetic_stream_is_the_jax_one():
    from repro.data.synthetic import lm_batches as jax_batches
    from repro.data.synthetic import needle_prompt as jax_needle
    from repro_torch.data.synthetic import needle_prompt
    cfg = TB.reduced(TB.get_config("seamless-m4t-large-v2"))
    jcfg = JB.reduced(JB.get_config("seamless-m4t-large-v2"))
    a, b = lm_batches(cfg, 2, 40, seed=3), jax_batches(jcfg, 2, 40, seed=3)
    for _ in range(2):
        x, y = next(a), next(b)
        assert sorted(x) == sorted(y) == ["src_embeds", "tokens"]
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    for got, want in zip(needle_prompt(500, 64, seed=2),
                         jax_needle(500, 64, seed=2)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", JB.ARCH_IDS)
def test_train_forward_equals_jax(arch):
    """Logits [B, S, V] f32 and the MoE aux losses (zeros without MoE);
    the encoder-decoder reads the batch's frames."""
    jcfg, jp, cfg, p = _model(arch)
    b = _batch(cfg)
    jl, jaux = JM.train_forward(jp, jcfg, _jbatch(b))
    with torch.no_grad():
        tl, aux = M.train_forward(p, cfg, _tbatch(b))
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    for got, want in zip(aux, jaux):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=AUX_TOL, rtol=AUX_TOL)
    assert (float(aux.lb_loss) > 0) == cfg.is_moe


def _jax_value_and_grad(jcfg, jp, b):
    (loss, (ce, aux)), grads = jax.value_and_grad(
        JL.loss_fn, has_aux=True)(jp, jcfg, _jbatch(b))
    return loss, ce, aux, grads


@pytest.mark.parametrize("arch", ["granite-8b", "seamless-m4t-large-v2",
                                  "mixtral-8x22b"])
def test_loss_and_grads_equal_jax(arch):
    jcfg, jp, cfg, p = _model(arch)
    b = _batch(cfg, seed=1)
    loss, ce, aux, grads = _jax_value_and_grad(jcfg, jp, b)
    (tloss, (tce, taux)), tgrads = TL.value_and_grad(p, cfg, _tbatch(b))
    np.testing.assert_allclose(float(tloss), float(loss), rtol=LOSS_TOL)
    np.testing.assert_allclose(float(tce), float(ce), rtol=LOSS_TOL)
    if cfg.is_moe:
        assert float(loss) > float(ce)
        np.testing.assert_allclose(float(taux.lb_loss), float(aux.lb_loss),
                                   rtol=AUX_TOL)
    assert all(np.abs(np.asarray(g)).max() > 0
               for g in jax.tree.leaves(grads))
    _assert_tree_close(tgrads, grads, scaled=GRAD_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_adamw_apply_equal_jax(dtype):
    """JAX's granite gradients fed to both packages: the clip (norm and
    clipped leaves), two AdamW steps (updates and f32 moments; decay on
    2-D leaves only) and the update applied in f32 and cast back."""
    jcfg, jp, cfg, p = _model("granite-8b")
    _, _, _, grads = _jax_value_and_grad(jcfg, jp, _batch(cfg, seed=2))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = jax.tree.map(lambda a: a.astype(jdt), jp)
    grads = jax.tree.map(lambda a: a.astype(jdt), grads)
    p = tree_map(lambda t: t.to(tdt), p)
    tg = bridge.params_from_numpy(jax.tree.map(np.asarray, grads),
                                  cfg.replace(dtype=tdt))
    for max_norm in (1e-3, 1e3):
        jc, jn = jax_clip(grads, max_norm)
        tc, tn = clip_by_global_norm(tg, max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        _assert_tree_close(tc, jax.tree.map(lambda a: a.astype(jnp.float32),
                                            jc), **OPT_TOL)
    jinit, jupd = jax_adamw(0.9, 0.95, weight_decay=0.1)
    tinit, tupd = adamw(0.9, 0.95, weight_decay=0.1)
    js, ts = jinit(jp), tinit(p)
    assert all(t.dtype == torch.float32 for t in tree_leaves(ts.mu))
    for lr in (3e-4, 1e-3):
        ju, js = jupd(jc, js, jp, jnp.float32(lr))
        tu, ts = tupd(tc, ts, p, torch.tensor(lr))
        _assert_tree_close(tu, ju, **OPT_TOL)
        _assert_tree_close(ts.mu, js.mu, **OPT_TOL)
        _assert_tree_close(ts.nu, js.nu, **OPT_TOL)
        assert int(ts.step) == int(js.step)
        jp, p = jax_apply(jp, ju), apply_updates(p, tu)
        assert all(t.dtype == tdt for t in tree_leaves(p))
        _assert_tree_close(tree_map(lambda t: t.float(), p),
                           jax.tree.map(lambda a: a.astype(jnp.float32), jp),
                           rtol=1e-6, atol=1e-6 if dtype == "float32"
                           else 0)
    # the train step's in-place form: the same bits as clip + adamw +
    # apply_updates, its grad leaves consumed
    p0 = tree_map(lambda t: t.to(tdt), _model("granite-8b")[3])
    pf, sf = p0, tinit(p0)
    tc, tn = clip_by_global_norm(tg, 1e-3)
    for lr in (3e-4, 1e-3):
        u, sf = tupd(tc, sf, pf, torch.tensor(lr))
        pf = apply_updates(pf, u)
    pi, si = tree_map(torch.clone, p0), tinit(p0)
    for lr in (3e-4, 1e-3):
        g = tree_map(torch.clone, tg)
        si = adamw_step_(pi, g, si, torch.tensor(lr),
                         grad_scale=clip_scale(global_norm(tg), 1e-3))
        assert all(x is None for x in tree_leaves(g))
    for a, b in zip(tree_leaves(pi) + tree_leaves(si.mu) + tree_leaves(si.nu),
                    tree_leaves(pf) + tree_leaves(sf.mu) + tree_leaves(sf.nu)):
        assert torch.equal(a, b)
    assert int(si.step) == 2
    # no decay on a norm: zero grads move a matrix, not a norm scale
    zero = tree_map(torch.zeros_like, p)
    u, _ = tupd(zero, tinit(p), p, torch.tensor(1e-3))
    assert float(u["final_norm"]["scale"].abs().max()) == 0
    assert float(u["blocks"]["sub0"]["mlp"]["up"]["w"].abs().max()) > 0


@pytest.mark.parametrize("kind", ["cosine", "wsd"])
def test_schedules_equal_jax(kind):
    if kind == "cosine":
        mk = dict(peak_lr=3e-4, warmup=3, total=20)
        got, want = cosine_schedule(**mk), jax_cosine(**mk)
    else:
        mk = dict(peak_lr=3e-4, warmup=2, stable=10, decay=6)
        got, want = wsd_schedule(**mk), jax_wsd(**mk)
    for step in range(24):
        g, w = got(step), want(step)
        assert g.dtype == torch.float32
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6, atol=0,
                                   err_msg=str(step))
        np.testing.assert_allclose(float(got(torch.tensor(step))), float(g),
                                   rtol=0)


@pytest.mark.parametrize("arch", ["granite-8b", "seamless-m4t-large-v2",
                                  "mixtral-8x22b", "mamba2-130m",
                                  "jamba-v0.1-52b"])
def test_train_step_equals_jax(arch):
    """One whole step of `make_train_step` (the state through
    `bridge.train_state_from_numpy`): metrics, new params and moments."""
    jcfg, jp, cfg, p = _model(arch)
    lr = (3e-4, 2, 10)
    jinit, jstep = JL.make_train_step(jcfg, jax_cosine(*lr))
    tinit, tstep = TL.make_train_step(cfg, cosine_schedule(*lr))
    b = _batch(cfg, seed=4)
    jst, jm = jstep(jinit(jp), _jbatch(b))
    st, m = tstep(tinit(tree_map(torch.clone, p)), _tbatch(b))   # donated
    for f in ("loss", "ce_loss", "lb_loss", "z_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(getattr(m, f)),
                                   float(getattr(jm, f)), rtol=LOSS_TOL,
                                   atol=1e-7, err_msg=f)
    assert int(st.step) == int(jst.step) == 1
    _assert_tree_close(st.params, jst.params, rtol=1e-5, atol=1e-6)
    # the first moment is 0.1 x the clipped grads: GRAD_TOL of each leaf
    _assert_tree_close(st.opt.mu, jst.opt.mu, scaled=GRAD_TOL)
    # the JAX state through the bridge steps like the port's own
    bst = bridge.train_state_from_numpy(jax.tree.map(np.asarray, jst), cfg)
    _, bm = tstep(bst, _tbatch(_batch(cfg, seed=5)))
    _, jm2 = jstep(jst, _jbatch(_batch(cfg, seed=5)))
    np.testing.assert_allclose(float(bm.loss), float(jm2.loss),
                               rtol=LOSS_TOL)


@pytest.mark.parametrize("arch", [a for a in JB.ARCH_IDS if a not in
                                  ("granite-8b", "seamless-m4t-large-v2")])
def test_train_step_smoke(arch):
    """The port alone, its own random weights: two steps of the WSD
    schedule are finite, the grad norm positive, the params move."""
    cfg = TB.reduced(TB.get_config(arch))
    p = M.init_params(cfg, seed=0, device="cpu")
    init, step = TL.make_train_step(cfg, wsd_schedule(1e-3, 0, 1, 1))
    st = init(tree_map(torch.clone, p))   # the step updates it in place
    data = lm_batches(cfg, BATCH, SEQ, seed=0)
    for _ in range(2):
        st, m = step(st, _tbatch(next(data)))
        assert all(np.isfinite(float(v)) for v in m)
        assert float(m.grad_norm) > 0
    moved = [not torch.equal(a, b) for a, b in
             zip(tree_leaves(st.params), tree_leaves(p))]
    assert all(moved), sum(moved)


def test_train_forward_launches_no_kernel(monkeypatch):
    """`use_kernels=True` (the serving default) and every CUDA kernel
    wrapper made to raise: the training forward and its backward never
    reach them, as the JAX training forward never reaches `pallas_call`."""
    def boom(*a, **k):
        raise AssertionError("a kernel wrapper was called")

    for mod in (fp_ops, dq_ops, kvq_ops):
        for name in dir(mod):
            if callable(getattr(mod, name)) and not name.startswith("_") \
                    and getattr(getattr(mod, name), "__module__", "") \
                    == mod.__name__:
                monkeypatch.setattr(mod, name, boom)
    for arch in ("granite-8b", "seamless-m4t-large-v2"):
        cfg = TB.reduced(TB.get_config(arch), use_kernels=True,
                         remat="block")
        p = M.init_params(cfg, seed=0, device="cpu")
        (loss, _), grads = TL.value_and_grad(p, cfg, _tbatch(_batch(cfg)))
        assert np.isfinite(float(loss))
        assert all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))
    with pytest.raises(AssertionError, match="kernel wrapper"):
        fp_ops.flash_attention(None, None, None)


def test_remat_changes_no_number():
    cfg = TB.reduced(TB.get_config("seamless-m4t-large-v2"))
    p = M.init_params(cfg, seed=1, device="cpu")
    b = _tbatch(_batch(cfg))
    (l0, _), g0 = TL.value_and_grad(p, cfg, b)
    (l1, _), g1 = TL.value_and_grad(p, cfg.replace(remat="block"), b)
    assert float(l0) == float(l1)
    for a, c in zip(tree_leaves(g0), tree_leaves(g1)):
        torch.testing.assert_close(a, c, rtol=0, atol=0)


def _manifest(d):
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)


def test_checkpoint_round_trips_across_packages(tmp_path):
    """f32 TrainStates: the port's file restores in JAX and JAX's in the
    port, leaf for leaf; the two manifests are equal (and so are the
    shard arrays), shard splitting included."""
    jcfg, jp, cfg, p = _model("seamless-m4t-large-v2")
    jinit, jstep = JL.make_train_step(jcfg, jax_cosine(3e-4, 0, 4))
    jst, _ = jstep(jinit(jp), _jbatch(_batch(cfg)))
    st = bridge.train_state_from_numpy(jax.tree.map(np.asarray, jst), cfg)
    for shard in (2 << 30, 1 << 20):
        jd, td = tmp_path / f"jax{shard}", tmp_path / f"port{shard}"
        jax_save(jst, str(jd), shard_bytes=shard)
        save_pytree(st, str(td), shard_bytes=shard)
        assert _manifest(jd) == _manifest(td)
        n = 1 + max(e["shard"] for e in _manifest(td)["leaves"])
        assert (n > 1) == (shard < 2 << 30)
        for i in range(n):
            a = np.load(jd / f"shard_{i:04d}.npz")
            b = np.load(td / f"shard_{i:04d}.npz")
            assert a.files == b.files
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
        back = jax_load(jst, str(td))
        for (k, x), (_, y) in zip(_flat(back), _flat(jst)):
            np.testing.assert_array_equal(x, y, err_msg=k)
        got = load_pytree(st, str(jd))
        assert type(got) is TL.TrainState
        for x, y in zip(tree_leaves(got.params) + [got.step, got.opt.step],
                        tree_leaves(st.params) + [st.step, st.opt.step]):
            assert torch.equal(x, y)


def test_bf16_checkpoint_restores_where_jax_cannot(tmp_path):
    """A bf16 TrainState saved by JAX (bf16 leaves as `|V2` with dtype
    "bfloat16"): JAX's loader raises (ROADMAP C5); the port's restores
    every leaf bit for bit, and writes the same files itself."""
    jcfg = JB.reduced(JB.get_config("granite-8b"), dtype=jnp.bfloat16)
    cfg = TB.reduced(TB.get_config("granite-8b"), dtype=torch.bfloat16)
    jp = JM.init_params(jax.random.key(0), jcfg)
    jinit, _ = JL.make_train_step(jcfg, jax_cosine(3e-4, 0, 4))
    jst = jinit(jp)
    jax_save(jst, str(tmp_path / "j"))
    assert any(e["dtype"] == "bfloat16" for e in
               _manifest(tmp_path / "j")["leaves"])
    with pytest.raises(ValueError, match="No cast function"):
        jax_load(jst, str(tmp_path / "j"))
    template = bridge.train_state_from_numpy(
        jax.tree.map(np.asarray, jst), cfg)
    template = template._replace(
        params=tree_map(torch.zeros_like, template.params))
    got = load_pytree(template, str(tmp_path / "j"))
    for (k, want), t in zip(_flat(jst.params), tree_leaves(got.params)):
        assert t.dtype == torch.bfloat16, k
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy(), np.asarray(want).view(np.int16),
            err_msg=k)
    save_pytree(got, str(tmp_path / "t"))
    assert _manifest(tmp_path / "t") == _manifest(tmp_path / "j")
    a, b = (np.load(tmp_path / d / "shard_0000.npz") for d in ("j", "t"))
    for k in a.files:
        assert a[k].dtype == b[k].dtype
        assert a[k].tobytes() == b[k].tobytes(), k


def test_train_cli(tmp_path, capsys):
    """`launch/train.py`: JAX's print lines, a checkpoint that JAX's
    loader restores into a JAX TrainState of the same config, and
    `--mesh host` (one gloo rank, a 1 x 1 mesh) giving the un-meshed
    run's losses and grad norms within 1e-5 and a checkpoint of the same
    leaves. Not bit for bit: on DTensors the embedding's gradient is
    F.embedding's backward (`sharding.embed_lookup`), on plain tensors
    index_put's, which sum a repeated token's rows in another order."""
    ck = str(tmp_path / "ck")
    st, hist = train_cli.main(["--arch", "granite-8b", "--reduced",
                               "--steps", "3", "--batch", "2", "--seq",
                               "16", "--schedule", "wsd", "--ckpt", ck,
                               "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("step     0  loss=") and "lr=" in out[0]
    assert out[1].startswith("step     2  loss=")
    assert out[2] == f"saved {ck}"
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert int(st.step) == 3
    jcfg = JB.reduced(JB.get_config("granite-8b"))
    jinit, _ = JL.make_train_step(jcfg, jax_wsd(3e-4, 0, 1, 1))
    back = jax_load(jinit(JM.init_params(jax.random.key(0), jcfg)), ck)
    for (k, x), t in zip(_flat(back.params), tree_leaves(st.params)):
        np.testing.assert_array_equal(x, t.numpy(), err_msg=k)
    assert int(back.step) == 3
    ck2 = str(tmp_path / "ck_mesh")
    _, hist2 = train_cli.main(["--arch", "granite-8b", "--reduced",
                               "--steps", "3", "--batch", "2", "--seq",
                               "16", "--schedule", "wsd", "--ckpt", ck2,
                               "--device", "cpu", "--mesh", "host"])
    assert capsys.readouterr().out.splitlines()[2] == f"saved {ck2}"
    np.testing.assert_allclose([h["loss"] for h in hist2],
                               [h["loss"] for h in hist], rtol=0, atol=1e-5)
    np.testing.assert_allclose([h["grad_norm"] for h in hist2],
                               [h["grad_norm"] for h in hist], rtol=1e-5)
    with open(os.path.join(ck, "manifest.json")) as f, \
            open(os.path.join(ck2, "manifest.json")) as g:
        assert f.read() == g.read()
