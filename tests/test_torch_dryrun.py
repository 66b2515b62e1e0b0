"""The port's dry run (`launch.dryrun`) against the JAX package's:

  * every kind (train, prefill, decode) runs ``ok`` for the reduced
    granite-8b, jamba-v0.1-52b and kimi-k2-1t-a32b on a fake 8-rank
    (data 2, model 4) mesh, at small input shapes;
  * `param_count` and `arg_bytes_total` equal JAX's `cfg.param_count()`
    and `tree_bytes` of the same workload;
  * `dot_flops_per_device` is held to JAX's `analyze_hlo` of the same
    workload lowered on 8 placeholder devices (one subprocess): never
    below it, and within DOT_FLOPS_RATIO of it per kind. The port counts
    more where it repeats over tp what GSPMD splits: these reduced
    configs have 2 kv heads on a 4-wide tp axis, so each rank's
    attention sees whole heads (GSPMD splits head_dim and all-reduces
    the partial scores; readings 1.03-1.14 forward); in training DTensor
    also computes the LM head's logits whole on every tp rank, where
    GSPMD keeps the vocabulary sharded through the log-softmax (readings
    1.15-1.78);
  * the CLI's lines and exit code, with one full-size production-mesh
    run (granite-8b decode_32k on 256 fake ranks) and one failure;
  * `perf_moe`'s expert-parallel combine moves less than the DTensor
    dispatch.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax
from functools import partial

from repro.configs import base as JB
from repro.launch import specs as JSP
from repro.nn import model as JM
from repro.utils import tree_bytes
from repro_torch.configs.base import InputShape, get_config, reduced
from repro_torch.launch import dryrun as DR
from repro_torch.launch import perf, perf_moe

ARCHS = ["granite-8b", "jamba-v0.1-52b", "kimi-k2-1t-a32b"]
SHAPES = [("train_t", 64, 8, "train"), ("prefill_t", 64, 8, "prefill"),
          ("decode_t", 64, 8, "decode")]
DOT_FLOPS_RATIO = {"train": 1.8, "prefill": 1.2, "decode": 1.2}

_JAX = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from functools import partial
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.base import get_config, reduced, InputShape
from repro.core.cache import CacheSpec
from repro.launch.dryrun import analyze_hlo
from repro.launch.specs import batch_specs
from repro.nn import model as M, sharding as shd
from repro.optim import cosine_schedule
from repro.optim.optimizers import AdamState
from repro.train.loop import TrainState, make_train_step
from repro.utils import tree_bytes

mesh = jax.make_mesh((2, 4), ("data", "model"))
out = {}
for arch in sys.argv[1].split(","):
    cfg = reduced(get_config(arch))
    ps = jax.eval_shape(partial(M.init_params, cfg=cfg), jax.random.key(0))
    psh = jax.tree.map(lambda s: NamedSharding(mesh, s),
                       shd.param_pspecs(ps, cfg, mesh))

    def sh(t):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                            is_leaf=lambda x: isinstance(x, P))

    for s in json.loads(sys.argv[2]):
        shape = InputShape(*s)
        wl = batch_specs(cfg, shape, mesh)
        if wl.kind == "train":
            init_state, step = make_train_step(
                cfg, cosine_schedule(3e-4, 100, 10_000))
            st = jax.eval_shape(init_state, ps)
            ssh = TrainState(psh, AdamState(NamedSharding(mesh, P()), psh,
                                            psh), NamedSharding(mesh, P()))
            low = jax.jit(step, in_shardings=(ssh, sh(wl.in_specs[0]))
                          ).lower(st, wl.args[0])
        elif wl.kind == "prefill":
            spec = CacheSpec(budget=shape.seq_len, policy="none")
            low = jax.jit(lambda p, b: M.prefill(p, cfg, b, spec),
                          in_shardings=(psh, sh(wl.in_specs[0]))
                          ).lower(ps, wl.args[0])
        else:
            spec = wl.cache_spec
            low = jax.jit(lambda p, c, t: M.decode_step(p, cfg, c, t, spec),
                          in_shardings=(psh, sh(wl.in_specs[0]),
                                        sh(wl.in_specs[1]))
                          ).lower(ps, *wl.args)
        st_ = analyze_hlo(low.compile().as_text(), 8)
        out[f"{arch}/{shape.name}"] = {
            "dot_flops": st_["dot_flops_per_device"],
            "arg_bytes": int(tree_bytes(wl.args)) + int(tree_bytes(ps))}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX, ",".join(ARCHS), json.dumps(SHAPES)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port = {}
    for arch in ARCHS:
        for s in SHAPES:
            port[f"{arch}/{s[0]}"] = DR.run_one(
                arch, s[0], cfg=reduced(get_config(arch)),
                shape=InputShape(*s), mesh_dims=((2, 4), ("data", "model")))
    out, err = jax_proc.communicate(timeout=300)
    assert jax_proc.returncode == 0, err[-3000:]
    return port, json.loads(out.strip().splitlines()[-1])


def test_every_kind_runs_ok(runs):
    port, _ = runs
    for key, rec in port.items():
        assert rec["status"] == "ok", key
        assert rec["kind"] == key.split("/")[1].split("_")[0]
        assert rec["n_devices"] == 8 and rec["mesh"] == "2x4"
        assert rec["lower_s"] >= 0
        for k in ("compile_s", "bytes_accessed_per_device",
                  "memory_analysis"):
            assert rec[k] is None
        assert sum(c["count"] for c in rec["collectives"].values()) > 0


def test_param_count_and_arg_bytes_equal_jax(runs):
    port, jx = runs
    for key, rec in port.items():
        arch = key.split("/")[0]
        jcfg = JB.reduced(JB.get_config(arch))
        assert rec["param_count"] == jcfg.param_count()
        assert rec["active_param_count"] == jcfg.active_param_count()
        assert rec["arg_bytes_total"] == jx[key]["arg_bytes"], key


def test_dot_flops_held_to_jax(runs):
    port, jx = runs
    for key, rec in port.items():
        ratio = rec["dot_flops_per_device"] / jx[key]["dot_flops"]
        assert 1.0 <= ratio <= DOT_FLOPS_RATIO[rec["kind"]], (key, ratio)


def test_cli_full_size_production_mesh(tmp_path, capsys):
    rc = DR.main(["--arch", "granite-8b", "--shape", "decode_32k",
                  "--out", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    assert lines[-1] == "done; failures=0"
    assert lines[-2].startswith("[ok] granite-8b__decode_32k__single "
                                "flops/dev=")
    rec = json.loads((tmp_path / "granite-8b__decode_32k__single.json")
                     .read_text())
    assert rec["n_devices"] == 256 and rec["mesh"] == "16x16"
    jcfg = JB.get_config("granite-8b")
    wl = JSP.batch_specs(jcfg, JB.INPUT_SHAPES["decode_32k"],
                         jax.sharding.AbstractMesh((16, 16),
                                                   ("data", "model")))
    ps = jax.eval_shape(partial(JM.init_params, cfg=jcfg), jax.random.key(0))
    assert rec["arg_bytes_total"] == tree_bytes(wl.args) + tree_bytes(ps)
    assert rec["param_count"] == jcfg.param_count()
    t = perf.terms(rec)
    assert t["dominant"] in ("compute", "memory", "collective")
    assert t["step_s_lower_bound"] > 0 and 0 < t["useful_ratio"] <= 1.0


def test_cli_counts_failures(tmp_path, capsys):
    rc = DR.main(["--arch", "no-such-arch", "--shape", "decode_32k",
                  "--out", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 1
    assert lines == ["[FAIL] no-such-arch__decode_32k__single",
                     "done; failures=1"]
    rec = json.loads((tmp_path / "no-such-arch__decode_32k__single.json")
                     .read_text())
    assert rec["status"] == "FAIL" and "KeyError" in rec["error"]


def test_perf_moe_expert_parallel_moves_less():
    res = perf_moe.run()
    ep, dispatch = res["expert_parallel"], res["dtensor_dispatch"]
    assert set(ep[1]) == {"all-reduce"}
    # one [8 tokens x 7168] f32 partial per rank, weighted 15/16
    assert ep[1]["all-reduce"] == 8 * 7168 * 4 * 15 / 16
    assert dispatch[0] > ep[0]
