"""Sharding-option iteration driver of the port (counterpart of
`repro.launch.perf`): run ONE (arch x shape x mesh) dry run with a set of
sharding options, print its roofline terms on the H100, and save the
record to experiments/perf_torch/<tag>__<opts>.json.

    PYTHONPATH=src python -m repro_torch.launch.perf --arch qwen2.5-32b \\
        --shape train_4k --opts kv_replicated,weight_gather

The roofline (`terms`) is the port's copy of `benchmarks/roofline.py`'s
with the card's constants (`launch.mesh`: H100 SXM5 80GB at 700 W):

  compute    = dot FLOPs per device / 989e12 (dense bf16)
  memory     = analytic HBM traffic per device / 3.35e12 B/s
  collective = sum over kinds of factor * weighted bytes / 450e9 B/s

The collective term divides by NVLink 4's per-direction rate, where the
JAX package divides by twice its ICI link rate. For an axis that leaves
an 8-GPU HGX node (the production "model" axis is 16 wide) the traffic
crosses the inter-node network, slower than NVLink: the term is then a
lower bound. MODEL_FLOPS = 6 * N_active * tokens (train) or
2 * N_active * tokens (prefill / decode); useful_ratio = MODEL_FLOPS /
(dot FLOPs x n_dev).
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.configs.base import INPUT_SHAPES, get_config
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16
from repro_torch.launch.specs import decode_cache_spec

PERF_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                        "experiments", "perf_torch")

_FACTORS = {"all-gather": 1.0, "reduce-scatter": 1.0, "all-to-all": 1.0,
            "all-reduce": 2.0, "collective-permute": 1.0}


def _tokens(shape: str) -> int:
    s = INPUT_SHAPES[shape]
    return (s.global_batch * s.seq_len if s.kind != "decode"
            else s.global_batch)


def model_flops(rec: dict) -> float:
    mult = 6 if rec["kind"] == "train" else 2
    return mult * rec["active_param_count"] * _tokens(rec["shape"])


def analytic_memory_bytes(rec: dict) -> float:
    """First-order per-device HBM traffic for one step:
      decode : (params touched + KV cache + SSM state) / n_dev, params
               touched = min(total, active x batch) for MoE;
      prefill: (params + 2 x cache write + activations x 6) / n_dev;
      train  : (params (bf16 reads fwd + bwd) + f32 grads + AdamW moments
               r/w + activations x (1 + remat) x 6) / n_dev."""
    cfg = get_config(rec["arch"])
    shp = INPUT_SHAPES[rec["shape"]]
    n_dev = rec["n_devices"]
    N = rec["param_count"]
    Na = rec["active_param_count"]
    B, S = shp.global_batch, shp.seq_len
    L = cfg.num_layers

    if shp.kind == "decode":
        opts = frozenset()
        note = rec.get("note", "")
        if "bits=4" in note:
            opts = frozenset({"kivi4_cache"})
        elif "bits=2" in note:
            opts = frozenset({"kivi2_cache"})
        spec = decode_cache_spec(cfg, shp, opts)
        eff_len = min(spec.budget if spec.budget else S, S) + spec.window
        bytes_per_elt = spec.bits / 8.0 if spec.quantized else 2.0
        cache = cfg.kv_bytes_per_token(bytes_per_elt) * eff_len * B
        if spec.quantized:   # scales / zeros metadata
            cache += cfg.kv_bytes_per_token(4.0) * eff_len * B / spec.group \
                + cfg.num_layers * B * eff_len * cfg.num_kv_heads * 8.0
        if cfg.arch_type in ("ssm", "hybrid"):
            n_ssm = sum(1 for i in range(L) if cfg.layer_kind(i) == "ssm")
            cache += (B * cfg.ssm_heads * cfg.ssm.head_dim * cfg.ssm.d_state
                      * 4 * n_ssm)
        params_touched = min(N, Na * B) * 2.0
        return (params_touched + cache) / n_dev

    acts = B * S * cfg.d_model * L * 2.0          # bf16 residual stream
    if shp.kind == "prefill":
        cache = cfg.kv_bytes_per_token() * S * B
        return (N * 2.0 + 2 * cache + 6 * acts) / n_dev
    param_traffic = N * (2.0 + 2.0) + N * 4.0 + N * 16.0
    remat = 2.0 if cfg.remat == "block" else 1.0
    return (param_traffic + remat * 6 * acts) / n_dev


def terms(rec: dict) -> dict:
    n_dev = rec["n_devices"]
    dot_flops = rec["dot_flops_per_device"]
    compute_s = dot_flops / PEAK_FLOPS_BF16
    memory_s = analytic_memory_bytes(rec) / HBM_BW
    coll_bytes = sum(_FACTORS[k] * v["bytes_weighted_n"]
                     for k, v in rec["collectives"].items())
    coll_s = coll_bytes / NVLINK_BW
    total = dot_flops * n_dev
    mf = model_flops(rec)
    dom = max(("compute", compute_s), ("memory", memory_s),
              ("collective", coll_s), key=lambda t: t[1])[0]
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "kind": rec["kind"],
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": coll_s, "dominant": dom,
        "model_flops": mf, "dot_flops_total": total,
        "useful_ratio": mf / total if total > 0 else 0.0,
        "step_s_lower_bound": max(compute_s, memory_s, coll_s),
    }


def run(arch: str, shape: str, opts: frozenset = frozenset(),
        multi_pod: bool = False) -> dict:
    """The dry run of one workload under the sharding options `opts`
    (the activation hooks and the cache / batch layouts both read
    them)."""
    return DR.run_one(arch, shape, multi_pod=multi_pod, opts=opts,
                      extra_note=f"opts={sorted(opts)}")


def summarize(res: dict) -> str:
    t = terms(res)
    return (f"compute={t['compute_s']:.3e}s memory={t['memory_s']:.3e}s "
            f"collective={t['collective_s']:.3e}s dominant={t['dominant']} "
            f"useful={t['useful_ratio']:.3f} lower={res['lower_s']}s")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--opts", default="",
                    help="comma list: kv_replicated,weight_gather,"
                         "seq_tp_cache,...")
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(PERF_DIR))
    args = ap.parse_args(argv)
    opts = frozenset(o for o in args.opts.split(",") if o)
    res = run(args.arch, args.shape, opts, args.multi)
    os.makedirs(args.out, exist_ok=True)
    tag = (f"{args.arch}__{args.shape}__"
           f"{'multi' if args.multi else 'single'}__"
           f"{'+'.join(sorted(opts)) or 'baseline'}")
    with open(os.path.join(args.out, tag + ".json"), "w") as f:
        json.dump(res, f, indent=1)
    print(tag)
    print(summarize(res))


if __name__ == "__main__":
    main()
