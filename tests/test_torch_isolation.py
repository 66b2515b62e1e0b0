"""The port stands alone: importing every `repro_torch` module and running
its serving CLI leaves no `jax` and nothing of the JAX package in
`sys.modules`; its entry points default to the card."""
import re
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import repro_torch
from repro_torch import bridge, checkpoint, data, optim, train
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs import (base, chameleon_34b, command_r_plus_104b,
                                 granite_8b, jamba_v0_1_52b, kimi_k2_1t_a32b,
                                 mamba2_130m, minicpm_2b, mixtral_8x22b,
                                 paper_llama_7b, qwen2_5_32b,
                                 seamless_m4t_large_v2)
from repro_torch.data import synthetic
from repro_torch.optim import optimizers, schedules
from repro_torch.train import loop
from repro_torch.core import (budgets, cache, eviction, lexico, paging,
                              policy, quantization, sharing)
from repro_torch.kernels import build
from repro_torch.kernels.decode_qattn import ops as dq_ops
from repro_torch.kernels.decode_qattn import ref as dq_ref
from repro_torch.kernels.flash_prefill import ops as fp_ops
from repro_torch.kernels.flash_prefill import ref as fp_ref
from repro_torch.kernels.kvquant import ops as kvq_ops
from repro_torch.kernels.kvquant import ref as kvq_ref
from repro_torch.launch import dryrun, mesh, perf, perf_moe, serve, specs
from repro_torch.launch import train as train_cli
from repro_torch.nn import (attention, blocks, layers, model, moe, moe_ep,
                            rope, sharding, ssm)
from repro_torch import obs
from repro_torch.obs import metrics, trace
from repro_torch.serving import (adaptive, cacheblend, engine, prefix,
                                 sampler, scheduler, shared_runner,
                                 speculative)

MODULES = [repro_torch, bridge, base, chameleon_34b, command_r_plus_104b,
           granite_8b, jamba_v0_1_52b, kimi_k2_1t_a32b, mamba2_130m,
           minicpm_2b, mixtral_8x22b, paper_llama_7b, qwen2_5_32b, budgets,
           cache, eviction, lexico, paging, policy, quantization, sharing,
           build, dq_ops, dq_ref, fp_ops, fp_ref, kvq_ops, kvq_ref, serve,
           attention, blocks, layers, model, moe, rope, ssm, obs, metrics,
           trace, adaptive,
           cacheblend, engine, prefix, sampler, scheduler, shared_runner,
           speculative, seamless_m4t_large_v2, checkpoint, ckpt_io, data,
           synthetic, optim, optimizers, schedules, train, loop, train_cli,
           sharding, moe_ep, mesh, specs, dryrun, perf, perf_moe]

_CHILD = textwrap.dedent("""
    import importlib, json, os, sys, tempfile
    for name in {names!r}:
        importlib.import_module(name)
    from repro_torch.launch import serve
    tmp = tempfile.mkdtemp()
    t_path, m_path = os.path.join(tmp, "t.json"), os.path.join(tmp, "m.json")
    serve.main(["--arch", "granite-8b", "--reduced", "--policy", "nacl",
                "--budget", "16", "--window", "8", "--requests", "3",
                "--prompt-len", "32", "--max-new", "3", "--slots", "2",
                "--continuous", "--paged", "--device", "cpu",
                "--trace", t_path, "--metrics-json", m_path])
    print("TRACE", len(json.load(open(t_path))["traceEvents"]),
          json.load(open(m_path))["schema"])
    serve.main(["--arch", "granite-8b", "--reduced", "--policy", "keyformer",
                "--budget", "16", "--window", "8", "--requests", "3",
                "--prompt-len", "32", "--max-new", "3", "--slots", "2",
                "--device", "cpu", "--trace", t_path])
    serve.main(["--arch", "granite-8b", "--reduced", "--policy", "h2o+kivi2",
                "--budget", "16", "--window", "8", "--requests", "3",
                "--prompt-len", "32", "--max-new", "3", "--slots", "2",
                "--continuous", "--buckets", "32,48", "--device", "cpu"])
    serve.main(["--arch", "granite-8b", "--reduced", "--policy", "kivi2",
                "--budget", "16", "--window", "8", "--requests", "3",
                "--prompt-len", "32", "--max-new", "3", "--slots", "2",
                "--continuous", "--buckets", "32,48", "--device", "cpu",
                "--paged", "--chunked-prefill", "--chunk-len", "16",
                "--use-kernels", "off"])
    serve.main(["--arch", "granite-8b", "--reduced", "--policy", "full",
                "--requests", "3", "--prompt-len", "32", "--max-new", "4",
                "--slots", "2", "--continuous", "--buckets", "32,48",
                "--device", "cpu", "--speculative", "--gamma", "2",
                "--draft-policy", "window:16"])
    serve.main(["--arch", "granite-8b", "--reduced", "--policy", "kivi2",
                "--budget", "24", "--window", "8", "--requests", "4",
                "--prompt-len", "32", "--max-new", "12", "--slots", "2",
                "--continuous", "--device", "cpu", "--paged",
                "--prefix-sharing", "--shared-prefix", "24"])
    serve.main(["--arch", "paper-llama-7b", "--reduced", "--policy", "kivi2",
                "--budget", "16", "--window", "8", "--requests", "2",
                "--prompt-len", "32", "--max-new", "2", "--slots", "2",
                "--device", "cpu"])
    serve.main(["--arch", "granite-8b", "--reduced", "--policy", "kivi2",
                "--budget", "24", "--window", "8", "--requests", "4",
                "--prompt-len", "32", "--max-new", "12", "--slots", "2",
                "--continuous", "--device", "cpu", "--paged",
                "--block-growth", "lazy", "--preemption", "--degrade",
                "--tiering", "--audit-every", "2"])
    serve.main(["--arch", "chameleon-34b", "--reduced", "--policy", "full",
                "--requests", "2", "--prompt-len", "32", "--max-new", "2",
                "--slots", "2", "--continuous", "--paged",
                "--chunked-prefill", "--chunk-len", "16", "--device", "cpu"])
    serve.main(["--arch", "mixtral-8x22b", "--reduced", "--policy", "kivi2",
                "--budget", "16", "--window", "8", "--requests", "2",
                "--max-new", "2", "--slots", "2", "--continuous",
                "--buckets", "80", "--paged", "--device", "cpu"])
    serve.main(["--arch", "jamba-v0.1-52b", "--reduced", "--policy", "kivi2",
                "--budget", "16", "--window", "8", "--requests", "2",
                "--max-new", "2", "--slots", "2", "--continuous",
                "--buckets", "48", "--paged", "--device", "cpu"])
    import torch
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.core.cache import CacheSpec
    from repro_torch.nn import model as M
    from repro_torch.serving import shared_runner as SR
    cfg = reduced(get_config("qwen2.5-32b"), num_layers=4)
    p = M.init_params(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 16))
    m = SR.calibrate_sharing(p, cfg, toks, 1)
    lg, caches = SR.shared_prefill(p, cfg, {{"tokens": toks}},
                                   CacheSpec(budget=20), m)
    lg, caches = SR.shared_decode_step(p, cfg, caches, lg.argmax(-1)[:, None],
                                       CacheSpec(budget=20), m)
    print("KVSHARER", len(m), sum(c is None for c in caches))
    serve.main(["--arch", "seamless-m4t-large-v2", "--reduced", "--policy",
                "kivi2", "--budget", "16", "--window", "8", "--requests",
                "3", "--prompt-len", "32", "--max-new", "3", "--slots", "2",
                "--device", "cpu"])
    from repro_torch.launch import train as train_cli
    train_cli.main(["--arch", "seamless-m4t-large-v2", "--reduced",
                    "--steps", "2", "--batch", "2", "--seq", "16",
                    "--device", "cpu", "--ckpt", os.path.join(tmp, "ck")])
    train_cli.main(["--arch", "granite-8b", "--reduced", "--steps", "2",
                    "--batch", "2", "--seq", "16", "--device", "cpu",
                    "--mesh", "host", "--ckpt", os.path.join(tmp, "ck2")])
    from repro_torch.launch import dryrun
    dryrun.main(["--arch", "granite-8b", "--shape", "long_500k",
                 "--out", os.path.join(tmp, "dr")])
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith("jax.")
                 or m == "repro" or m.startswith("repro."))
    print("LEAKED", bad)
""")


def test_port_imports_no_jax_and_no_repro():
    names = [m.__name__ for m in MODULES]
    r = subprocess.run([sys.executable, "-c", _CHILD.format(names=names)],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "LEAKED []" in r.stdout, r.stdout
    assert "policy=h2o+kivi2 continuous requests=3" in r.stdout, r.stdout
    assert "policy=kivi2" in r.stdout, r.stdout
    assert "audit clean=True" in r.stdout, r.stdout
    assert "spec[window:16 gamma=2]" in r.stdout, r.stdout
    assert re.search(r"prefix cache: [1-9]\d* warm", r.stdout), r.stdout
    assert re.search(r"pressure: [1-9]\d* degrades", r.stdout), r.stdout
    assert "tier: " in r.stdout, r.stdout
    assert "policy=nacl continuous" in r.stdout, r.stdout
    assert "policy=keyformer" in r.stdout, r.stdout
    assert "policy=full continuous requests=2" in r.stdout, r.stdout
    assert "KVSHARER 1 1" in r.stdout, r.stdout
    assert "saved " in r.stdout and "step     1  loss=" in r.stdout, r.stdout
    assert "policy=kivi2 continuous requests=2 buckets=[80]" in r.stdout, \
        r.stdout
    assert "policy=kivi2 continuous requests=2 buckets=[48]" in r.stdout, \
        r.stdout
    assert re.search(r"TRACE [1-9]\d* repro.obs.metrics/1", r.stdout), \
        r.stdout
    assert re.search(r"saved \S*ck2", r.stdout), r.stdout   # --mesh host
    assert "[ok] granite-8b__long_500k__single flops/dev=" in r.stdout, \
        r.stdout
    assert "done; failures=0" in r.stdout, r.stdout


def test_entry_points_default_to_cuda():
    """No device argument means the card: with no CUDA device the engine
    and the CLI raise instead of running on the CPU."""
    cfg = base.reduced(granite_8b.CONFIG)
    params = model.init_params(cfg, seed=0, device="cpu")
    pol = policy.presets(16, 8)["kivi2"]
    if torch.cuda.is_available():
        assert engine.resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.Engine(cfg, params, pol, prompt_len=32, max_new=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.Engine(cfg, params, pol, prompt_len=32, max_new=4,
                      speculative=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "granite-8b", "--reduced"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--arch", "granite-8b", "--reduced"])


def test_tracer_copy_sampler_and_allocators():
    class Recorder(list):
        def __bool__(self):
            return True

        def instant(self, name, *, tid=0, args=None):
            self.append(name)

        def complete(self, name, t0, t1=None, *, tid=0, args=None):
            self.append(name)

    # the scheduler's lifecycle events go through the tracer seam; the
    # default NULL_TRACER is falsy, so a trace-off run emits nothing
    clock = iter(range(100)).__next__
    rec = Recorder()
    sched = scheduler.Scheduler([4], 1, clock=clock, tracer=rec)
    sched.submit(scheduler.Request(tokens=[1, 2, 3, 4], max_new=2))
    sched.admit_next(0)
    assert sched.record_token(0, 7) is None
    res = sched.retire(0, sched.record_token(0, 8))
    assert rec == ["submit", "admit", "first_token", "queued", "request"]
    assert res.tokens.tolist() == [7, 8] and res.finish_reason == "length"
    assert (res.ttft_s, res.total_s, res.decode_s) == (2, 4, 2)
    assert not trace.NULL_TRACER and scheduler.Scheduler([4], 1).trace is \
        trace.NULL_TRACER
    # argmax ties go to the lower index, as jnp.argmax
    logits = torch.tensor([[0.0, 2.0, 2.0], [3.0, 1.0, 0.0]])
    assert sampler.greedy(logits).tolist() == [1, 0]
    assert budgets.uniform(3, 64, multiple=16).tolist() == [64, 64, 64]
    # packed byte 127 (+128 bias) = codes 3,3,3,3: scale 2, zero -1 -> 5.0
    v = kvq_ref.dequant_v_ref(torch.tensor([[[[-128, 127]]]], dtype=torch.int8),
                              torch.full((1, 1, 1), 2.0),
                              torch.full((1, 1, 1), -1.0), 2, torch.float32)
    assert v.flatten().tolist() == [-1.0] * 4 + [5.0] * 4
