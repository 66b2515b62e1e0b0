"""Serving launcher of the PyTorch port (counterpart of
`repro.launch.serve`): policy-compressed engine, random weights from a
seed, on the card unless ``--device cpu``.

    # wave-based (fixed waves of `slots` requests)
    python -m repro_torch.launch.serve --arch granite-8b --reduced \\
        --policy h2o+kivi2 --budget 64

    # continuous batching: multi-bucket prompts, per-request max-new,
    # EOS/early-exit slot reuse over one persistent cache
    python -m repro_torch.launch.serve --arch granite-8b --reduced \\
        --policy h2o+kivi2 --budget 64 --continuous --buckets 128,256
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs.base import get_config, reduced
from repro_torch.core.policy import presets
from repro_torch.nn import model as M
from repro_torch.serving.engine import Engine, resolve_device
from repro_torch.serving.scheduler import Request


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--policy", default="h2o")
    ap.add_argument("--budget", type=int, default=64)
    ap.add_argument("--window", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching (per-slot request lifecycle)")
    ap.add_argument("--buckets", default="",
                    help="comma-separated prompt buckets for --continuous "
                         "(default: --prompt-len)")
    ap.add_argument("--eos-id", type=int, default=-1,
                    help="EOS token id for --continuous early exit "
                         "(-1: length-based exit only)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    params = M.init_params(cfg, seed=0, device=device)
    pol = presets(budget=args.budget, window=args.window)[args.policy]
    rng = np.random.default_rng(0)

    if args.continuous:
        buckets = sorted({int(b) for b in args.buckets.split(",") if b}
                         or {args.prompt_len})
        eng = Engine(cfg, params, pol, prompt_len=max(buckets),
                     max_new=args.max_new, slots=args.slots, buckets=buckets,
                     device=device)
        eos = args.eos_id if args.eos_id >= 0 else None
        reqs = [
            Request(tokens=rng.integers(0, cfg.vocab_size,
                                        size=buckets[i % len(buckets)]),
                    max_new=int(rng.integers(max(1, args.max_new // 2),
                                             args.max_new + 1)),
                    eos_id=eos)
            for i in range(args.requests)
        ]
        res = eng.generate_continuous(reqs)
        print(f"policy={res.policy_name} continuous "
              f"requests={len(res.results)} buckets={buckets}")
        print(f"prefill_s={res.prefill_seconds:.2f} "
              f"decode_tok/s={res.decode_tokens_per_s:.1f} "
              f"occupancy={res.occupancy:.2f} "
              f"ttft_mean_s={res.ttft_mean_s:.3f}")
        print(f"compression_ratio={res.compression_ratio:.1f}x "
              f"(logical {res.cache_logical_bytes / 2**20:.1f} MiB vs "
              f"full {res.full_cache_bytes / 2**20:.1f} MiB; resident "
              f"{res.cache_physical_bytes / 2**20:.1f} MiB)")
        return

    prompts = rng.integers(0, cfg.vocab_size,
                           size=(args.requests, args.prompt_len))
    eng = Engine(cfg, params, pol, prompt_len=args.prompt_len,
                 max_new=args.max_new, slots=args.slots, device=device)
    res = eng.generate(prompts)
    print(f"policy={res.policy_name}")
    print(f"prefill_s={res.prefill_seconds:.2f} "
          f"decode_tok/s={res.decode_tokens_per_s:.1f}")
    print(f"compression_ratio={res.compression_ratio:.1f}x "
          f"(logical {res.cache_logical_bytes / 2**20:.1f} MiB vs "
          f"full {res.full_cache_bytes / 2**20:.1f} MiB)")


if __name__ == "__main__":
    main()
