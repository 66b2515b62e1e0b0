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
  * `memory_analysis` and `bytes_accessed_per_device` against JAX's
    compiled memory analysis and cost analysis of the same lowering:
    `argument_size_in_bytes` (the local shards of params, state, batch,
    cache) equal; `temp_size_in_bytes` within TEMP_RATIO and the bytes
    within BYTES_RATIO per kind. The port's temp holds the step's
    outputs (XLA's excludes them: the prefill's cache and logits are
    outputs) and every unfused intermediate eager PyTorch keeps where
    XLA's buffer assignment fuses and reuses (jamba's plain SSD
    materializes its [B, c, L, L, H] chunk matrices: readings 1.09-2.01
    train, 1.99-4.21 prefill); a decode step updates the cache in place,
    where this lowering (no donation) writes a new cache beside the old
    (readings 0.71-1.75). The port's bytes are unfused: each op reads and
    writes its operands where an XLA fusion reads them once, and the
    decode step dequantizes, materializes and biases the whole store op
    by op (readings 2.05-3.04 train, 2.19-5.83 prefill, 4.83-6.89
    decode);
  * `launch.reanalyze` re-derives each run's dot FLOPs, collectives and
    bytes from its saved op log exactly, and restores them in a JSON
    whose numbers were zeroed;
  * the CLI's lines and exit code, with one full-size production-mesh
    run (granite-8b decode_32k on 256 fake ranks, its op log written)
    and one failure;
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
from repro_torch.launch import perf, perf_moe, reanalyze

ARCHS = ["granite-8b", "jamba-v0.1-52b", "kimi-k2-1t-a32b"]
SHAPES = [("train_t", 64, 8, "train"), ("prefill_t", 64, 8, "prefill"),
          ("decode_t", 64, 8, "decode")]
DOT_FLOPS_RATIO = {"train": 1.8, "prefill": 1.2, "decode": 1.2}
TEMP_RATIO = {"train": (1.0, 2.2), "prefill": (1.8, 4.6),
              "decode": (0.6, 1.9)}
BYTES_RATIO = {"train": (1.8, 3.4), "prefill": (2.0, 6.4),
               "decode": (4.3, 7.6)}
MEM_KEYS = ("argument_size_in_bytes", "output_size_in_bytes",
            "alias_size_in_bytes", "temp_size_in_bytes",
            "generated_code_size_in_bytes")
LOGS: dict = {}     # the port runs' op logs, by run key

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
        comp = low.compile()
        st_ = analyze_hlo(comp.as_text(), 8)
        mem = comp.memory_analysis()
        cost = comp.cost_analysis()
        cost = cost[0] if isinstance(cost, list) else cost
        out[f"{arch}/{shape.name}"] = {
            "dot_flops": st_["dot_flops_per_device"],
            "arg_bytes": int(tree_bytes(wl.args)) + int(tree_bytes(ps)),
            "memory": {k: int(getattr(mem, k)) for k in (
                "argument_size_in_bytes", "temp_size_in_bytes")},
            "bytes_accessed": float(cost["bytes accessed"])}
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
            key = f"{arch}/{s[0]}"
            LOGS[key] = []
            port[key] = DR.run_one(
                arch, s[0], cfg=reduced(get_config(arch)),
                shape=InputShape(*s), mesh_dims=((2, 4), ("data", "model")),
                op_log=LOGS[key])
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
        assert rec["compile_s"] is None
        mem = rec["memory_analysis"]
        assert tuple(mem) == MEM_KEYS and mem["generated_code_size_in_bytes"] \
            == 0 and all(isinstance(v, int) for v in mem.values())
        assert mem["temp_size_in_bytes"] > 0
        assert rec["bytes_accessed_per_device"] > 0
        # the step writes the cache (and in training the params and
        # moments) in place: those outputs alias the arguments
        assert (mem["alias_size_in_bytes"] > 0) == (rec["kind"] != "prefill")
        assert mem["alias_size_in_bytes"] <= min(
            mem["argument_size_in_bytes"], mem["output_size_in_bytes"])
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


def test_argument_size_equals_jax(runs):
    port, jx = runs
    for key, rec in port.items():
        assert rec["memory_analysis"]["argument_size_in_bytes"] == \
            jx[key]["memory"]["argument_size_in_bytes"], key


def test_temp_and_bytes_held_to_jax(runs):
    port, jx = runs
    for key, rec in port.items():
        t = rec["memory_analysis"]["temp_size_in_bytes"] / \
            jx[key]["memory"]["temp_size_in_bytes"]
        b = rec["bytes_accessed_per_device"] / jx[key]["bytes_accessed"]
        lo, hi = TEMP_RATIO[rec["kind"]]
        assert lo <= t <= hi, (key, t)
        lo, hi = BYTES_RATIO[rec["kind"]]
        assert lo <= b <= hi, (key, b)


def test_reanalyze_reproduces_the_runs(runs, tmp_path):
    port, _ = runs
    keys = ("dot_flops_per_device", "collectives",
            "bytes_accessed_per_device")
    for key, rec in port.items():
        tag = key.replace("/", "__")
        log = tmp_path / "ops" / (tag + ".jsonl.gz")
        DR.write_op_log(str(log), LOGS[key])
        assert reanalyze.derive(str(log)) == {k: rec[k] for k in keys}, key
        zeroed = dict(rec, dot_flops_per_device=0.0, flops_per_device=0.0,
                      bytes_accessed_per_device=0.0, collectives={})
        (tmp_path / (tag + ".json")).write_text(json.dumps(zeroed))
    (tmp_path / "failed.json").write_text(json.dumps({"status": "FAIL"}))
    assert reanalyze.main([str(tmp_path)]) == 0
    for key, rec in port.items():
        back = json.loads((tmp_path / (key.replace("/", "__") + ".json"))
                          .read_text())
        assert back == json.loads(json.dumps(rec)), key


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
    log = tmp_path / "ops" / "granite-8b__decode_32k__single.jsonl.gz"
    got = reanalyze.derive(str(log))
    assert got["bytes_accessed_per_device"] == \
        rec["bytes_accessed_per_device"]
    assert got["dot_flops_per_device"] == rec["dot_flops_per_device"]
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
