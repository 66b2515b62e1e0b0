"""The port's model on DTensors against itself unsharded and against the
JAX package, on 4 gloo ranks (spawned, `file://` rendezvous) over a
(data 2, model 2) mesh, f32, the JAX package's `tests/test_sharding.py`
trio (reduced granite-8b, jamba-v0.1-52b, kimi-k2-1t-a32b) on JAX's
weights through `repro_torch.bridge`:

  * a sharded train step: loss within 1e-5 of the unsharded port step's
    and of JAX's unsharded loss; the first AdamW moments (0.1 x the
    clipped gradient) within 1e-8 of the unsharded step's; the updated
    params within 1e-5 at lr 1e-5 (AdamW's first update is
    lr * g / (|g| + eps): a gradient within eps of zero may change its
    sign under another summation order, so the params' bound scales
    with lr);
  * a sharded `prefill` and two `decode_step`s give the unsharded
    logits within 1e-5, under JAX's test spec (streaming, budget 32,
    window 8, group 8) and under h2o, whose attention mass is summed
    over the two tp ranks' heads: every rank keeps the positions the
    unsharded cache keeps, and the two ranks of a data row the same;
  * one train state, distributed and saved, writes the manifest and the
    leaf bytes of the unsharded save of that state, and loads back into
    its sharded template.

Also here: the SSD's gradient is finite in the port where the JAX
package's is NaN (ROADMAP C).
"""
import json
import os
import pickle
import tempfile
import time
import traceback

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import base as JB
from repro.nn import model as JM
from repro.optim import cosine_schedule as jax_cosine
from repro.train import loop as JL

ARCHS = ["granite-8b", "jamba-v0.1-52b", "kimi-k2-1t-a32b"]
WORLD = 4
B, T, PROMPT = 4, 32, 24
LR = 1e-5


def _batch(vocab, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (B, T)).astype(np.int32)


def _worker(rank, path, data_path, out_path):
    torch.set_num_threads(1)
    import torch.distributed as dist
    res = {}
    try:
        dist.init_process_group("gloo", init_method=f"file://{path}",
                                rank=rank, world_size=WORLD)
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch import bridge
        from repro_torch.checkpoint import load_pytree, save_pytree
        from repro_torch.configs.base import get_config, reduced
        from repro_torch.core.cache import CacheSpec
        from repro_torch.nn import model as M
        from repro_torch.nn import sharding as shd
        from repro_torch.optim import cosine_schedule
        from repro_torch.optim.optimizers import tree_leaves
        from repro_torch.train.loop import make_train_step

        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        with open(data_path, "rb") as f:
            data = pickle.load(f)

        def place(t):
            return shd.distribute_leaf(
                t, (("data",),) + (None,) * (t.dim() - 1), mesh)

        for arch in ARCHS:
            cfg = reduced(get_config(arch)).replace(use_kernels=False)
            tok = torch.from_numpy(data[arch]["tokens"])

            def fresh():
                return bridge.params_from_numpy(data[arch]["params"], cfg)

            def dist_params():
                p = fresh()
                return shd.distribute_tree(p, shd.param_pspecs(p, cfg, mesh),
                                           mesh)

            init_state, step = make_train_step(
                cfg, cosine_schedule(LR, 0, 10))
            ref, m_ref = step(init_state(fresh()), {"tokens": tok})
            got, m = step(init_state(dist_params()), {"tokens": place(tok)})
            full = shd.full_tree(got)
            r = {"loss": float(m.loss.full_tensor()),
                 "loss_ref": float(m_ref.loss),
                 "param_err": max(float((a - b).abs().max()) for a, b in zip(
                     tree_leaves(full.params), tree_leaves(ref.params))),
                 "mu_err": max(float((a - b).abs().max()) for a, b in zip(
                     tree_leaves(full.opt.mu), tree_leaves(ref.opt.mu)))}

            for pol in ("streaming", "h2o"):
                spec = CacheSpec(budget=32, window=8 if pol == "streaming"
                                 else 0, sinks=2, policy=pol, group=8)
                p = fresh()
                _, c_ref = M.prefill(p, cfg, {"tokens": tok[:, :PROMPT]},
                                     spec)
                for t in (PROMPT, PROMPT + 1):
                    lg_ref, c_ref = M.decode_step(p, cfg, c_ref,
                                                  tok[:, t:t + 1], spec)
                dp = dist_params()
                _, dc = M.prefill(dp, cfg, {"tokens": place(tok[:, :PROMPT])},
                                  spec)
                for t in (PROMPT, PROMPT + 1):
                    lg, dc = M.decode_step(dp, cfg, dc,
                                           place(tok[:, t:t + 1]), spec)
                r[pol] = {
                    "logit_err": float((lg.full_tensor() - lg_ref)
                                       .abs().max()),
                    "slot_pos_equal": bool(torch.equal(
                        dc.attn.slot_pos.full_tensor(), c_ref.attn.slot_pos)),
                    "local_slot_pos": dc.attn.slot_pos.to_local().tolist(),
                }
            res[arch] = r

        # checkpoint: one state, unsharded (rank 0) and sharded (all)
        cfg = reduced(get_config("granite-8b")).replace(use_kernels=False)
        init_state, _ = make_train_step(cfg, cosine_schedule(LR, 0, 10))
        p = bridge.params_from_numpy(data["granite-8b"]["params"], cfg)
        d_plain, d_shard = (os.path.join(os.path.dirname(out_path), n)
                            for n in ("plain", "sharded"))
        if rank == 0:
            save_pytree(init_state(p), d_plain)
        dp = shd.distribute_tree(p, shd.param_pspecs(p, cfg, mesh), mesh)
        st = init_state(dp)
        save_pytree(st, d_shard)
        back = load_pytree(st, d_shard)
        res["ckpt_load"] = all(
            a.placements == b.placements and torch.equal(a.to_local(),
                                                         b.to_local())
            for a, b in zip(tree_leaves(back.params), tree_leaves(dp)))
    except Exception:  # noqa: BLE001 — reported to the test
        res["error"] = traceback.format_exc()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(f"{out_path}.{rank}", "w") as f:
        json.dump(res, f)


@pytest.fixture(scope="module")
def sharded():
    """Every rank's results (one spawn serves the file's tests) and the
    JAX losses."""
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp()
    data, jax_loss = {}, {}
    for arch in ARCHS:
        jcfg = JB.reduced(JB.get_config(arch))
        jp = JM.init_params(jax.random.key(0), jcfg)
        tok = _batch(jcfg.vocab_size)
        data[arch] = {"params": jax.tree.map(np.asarray, jp), "tokens": tok}
        init_state, step = JL.make_train_step(jcfg, jax_cosine(LR, 0, 10))
        _, m = step(init_state(jp), {"tokens": jnp.asarray(tok)})
        jax_loss[arch] = float(m.loss)
    data_path = os.path.join(tmp, "data.pkl")
    with open(data_path, "wb") as f:
        pickle.dump(data, f)
    out = os.path.join(tmp, "out")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, os.path.join(tmp, "rdv"),
                                               data_path, out))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 240
    for p in procs:
        p.join(timeout=max(deadline - time.monotonic(), 1))
    if any(p.is_alive() for p in procs):
        for p in procs:
            p.kill()
        pytest.fail("the ranks did not finish in 240 s")
    ranks = []
    for r in range(WORLD):
        with open(f"{out}.{r}") as f:
            ranks.append(json.load(f))
    for r, res in enumerate(ranks):
        assert "error" not in res, f"rank {r}:\n{res['error']}"
    return ranks, jax_loss, tmp


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_equals_unsharded_and_jax(sharded, arch):
    ranks, jax_loss, _ = sharded
    for res in ranks:
        r = res[arch]
        assert abs(r["loss"] - r["loss_ref"]) <= 1e-5
        assert abs(r["loss"] - jax_loss[arch]) <= 1e-5
        assert r["mu_err"] <= 1e-8
        assert r["param_err"] <= 1e-5


@pytest.mark.parametrize("policy", ["streaming", "h2o"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_decode_equals_unsharded(sharded, arch, policy):
    ranks, _, _ = sharded
    for res in ranks:
        r = res[arch][policy]
        assert r["logit_err"] <= 1e-5
        assert r["slot_pos_equal"]
    # the ranks of one data row (mesh (2, 2): ranks 2i, 2i + 1) hold the
    # same rows and keep the same positions
    for i in (0, 2):
        assert (ranks[i][arch][policy]["local_slot_pos"]
                == ranks[i + 1][arch][policy]["local_slot_pos"])


def test_sharded_checkpoint_equals_unsharded(sharded):
    ranks, _, tmp = sharded
    plain, shard = (os.path.join(tmp, n) for n in ("plain", "sharded"))
    with open(os.path.join(plain, "manifest.json")) as f:
        m_plain = f.read()
    with open(os.path.join(shard, "manifest.json")) as f:
        assert f.read() == m_plain
    shards = sorted(n for n in os.listdir(plain) if n.endswith(".npz"))
    assert shards == sorted(n for n in os.listdir(shard)
                            if n.endswith(".npz"))
    for n in shards:
        a, b = np.load(os.path.join(plain, n)), np.load(os.path.join(shard, n))
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes()
    assert all(r["ckpt_load"] for r in ranks)


def test_ssd_gradient_finite_where_jax_is_nan():
    """ROADMAP C: the SSD's intra-chunk decay exp(cum_l - cum_s) overflows
    above the diagonal once a chunk's decay is steep; JAX masks it after
    the exp, so its gradient there is 0 * inf = NaN. The port masks the
    exponent first. On the port's seed-0 reduced mamba2 weights (fed to
    both packages) and a batch whose steps overflow (rng seed 2; seed 1
    does not) the losses agree and only JAX's gradient is NaN."""
    from repro_torch.configs import base as TB
    from repro_torch.nn import model as M
    from repro_torch.train import loop as TL
    jcfg = JB.reduced(JB.get_config("mamba2-130m"))
    cfg = TB.reduced(TB.get_config("mamba2-130m"))
    p = M.init_params(cfg, seed=0, device="cpu")
    jp = TL.tree_map(lambda t: jnp.asarray(t.numpy()), p)
    tok = _batch(jcfg.vocab_size, seed=2)
    (jloss, _), jg = jax.value_and_grad(JL.loss_fn, has_aux=True)(
        jp, jcfg, {"tokens": jnp.asarray(tok)})
    jgn = float(jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                             for g in jax.tree.leaves(jg))))
    (loss, _), grads = TL.value_and_grad(p, cfg,
                                         {"tokens": torch.from_numpy(tok)})
    gn = float(torch.sqrt(sum(g.float().square().sum()
                              for g in TL.tree_leaves(grads))))
    assert abs(float(loss) - float(jloss)) <= 1e-5
    assert np.isnan(jgn)
    assert np.isfinite(gn) and gn > 0
