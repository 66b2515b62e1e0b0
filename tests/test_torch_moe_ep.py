"""The port's expert-parallel MoE (`nn.moe_ep`) on 4 gloo ranks over a
(data 1, model 4) mesh, f32, params and tokens drawn with numpy:

  * drop-free (capacity_factor = E) it equals `moe_apply_dense` within
    1e-5, with exactly one all-reduce (the combine) recorded;
  * at capacity_factor 1.25 (assignments dropped) it equals the JAX
    package's `moe_apply_expert_parallel` run on 8 placeholder devices
    in a subprocess (as tests/test_moe_ep.py runs it; a (2, 4) mesh with
    the tokens replicated, so ep is 4 in both) within 1e-5;
  * with experts that the mesh does not divide it raises as JAX does.
"""
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")

WORLD = 4
DM, F, E, TOPK = 32, 64, 8, 2
XSHAPE = (4, 8, DM)

_JAX = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.nn.moe_ep import moe_apply_expert_parallel
d = np.load(sys.argv[1])
p = {k: jnp.asarray(d[k]) for k in ("router", "gate", "up", "down")}
mesh = jax.make_mesh((2, 4), ("data", "model"))
y = moe_apply_expert_parallel(p, jnp.asarray(d["x"]), top_k=2, mesh=mesh,
                              capacity_factor=1.25)
np.save(sys.argv[2], np.asarray(y))
"""


def _draw(path):
    rng = np.random.default_rng(0)
    p = {"router": rng.standard_normal((DM, E)) / np.sqrt(DM),
         "gate": rng.standard_normal((E, DM, F)) / np.sqrt(DM),
         "up": rng.standard_normal((E, DM, F)) / np.sqrt(DM),
         "down": rng.standard_normal((E, F, DM)) / np.sqrt(F),
         "x": rng.standard_normal(XSHAPE)}
    np.savez(path, **{k: v.astype(np.float32) for k, v in p.items()})


def _worker(rank, rdv, data, out):
    import torch.distributed as dist
    torch.set_num_threads(1)
    res = {}
    try:
        dist.init_process_group("gloo", init_method=f"file://{rdv}",
                                rank=rank, world_size=WORLD)
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.launch.dryrun import DeviceCounter
        from repro_torch.nn import moe as MoE
        from repro_torch.nn.moe_ep import moe_apply_expert_parallel
        mesh = init_device_mesh("cpu", (1, WORLD),
                                mesh_dim_names=("data", "model"))
        d = np.load(data)
        p = {k: torch.from_numpy(d[k]) for k in ("router", "gate", "up",
                                                 "down")}
        x = torch.from_numpy(d["x"])
        counter = DeviceCounter()
        with counter:
            y = moe_apply_expert_parallel(p, x, top_k=TOPK, mesh=mesh,
                                          capacity_factor=float(E))
        dense, _ = MoE.moe_apply_dense(p, x, top_k=TOPK)
        y125 = moe_apply_expert_parallel(p, x, top_k=TOPK, mesh=mesh,
                                         capacity_factor=1.25)
        res = {"err_dense": float((y - dense).abs().max()),
               "collectives": {k: v["count"] for k, v in
                               counter.collectives.items()},
               "y125": y125.tolist()}
        try:
            moe_apply_expert_parallel({**p, "router": p["router"][:, :6]},
                                      x, top_k=TOPK, mesh=mesh)
            res["raised"] = False
        except AssertionError:
            res["raised"] = True
    except Exception:  # noqa: BLE001 — reported to the test
        res["error"] = traceback.format_exc()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(f"{out}.{rank}", "w") as f:
        json.dump(res, f)


@pytest.fixture(scope="module")
def ep_results():
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp()
    data = os.path.join(tmp, "data.npz")
    _draw(data)
    ctx = mp.get_context("spawn")
    out = os.path.join(tmp, "out")
    procs = [ctx.Process(target=_worker, args=(r, os.path.join(tmp, "rdv"),
                                               data, out))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    jax_out = os.path.join(tmp, "y_jax.npy")
    proc = subprocess.run([sys.executable, "-c", _JAX, data, jax_out],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    deadline = time.monotonic() + 180
    for p in procs:
        p.join(timeout=max(deadline - time.monotonic(), 1))
    if any(p.is_alive() for p in procs):
        for p in procs:
            p.kill()
        pytest.fail("the ranks did not finish in 180 s")
    assert proc.returncode == 0, proc.stderr[-3000:]
    ranks = []
    for r in range(WORLD):
        with open(f"{out}.{r}") as f:
            ranks.append(json.load(f))
    for r, res in enumerate(ranks):
        assert "error" not in res, f"rank {r}:\n{res['error']}"
    return ranks, np.load(jax_out)


def test_drop_free_expert_parallel_equals_dense(ep_results):
    ranks, _ = ep_results
    for res in ranks:
        assert res["err_dense"] <= 1e-5
        assert res["collectives"]["all-reduce"] == 1
        assert sum(res["collectives"].values()) == 1


def test_expert_parallel_equals_jax_at_capacity_1_25(ep_results):
    ranks, y_jax = ep_results
    for res in ranks:
        np.testing.assert_allclose(np.asarray(res["y125"]), y_jax,
                                   rtol=0, atol=1e-5)


def test_expert_parallel_refuses_indivisible_experts(ep_results):
    ranks, _ = ep_results
    assert all(res["raised"] for res in ranks)
