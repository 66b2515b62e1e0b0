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

    # ... over a paged block pool, prompts admitted in 64-token segments
    python -m repro_torch.launch.serve --arch granite-8b --reduced \\
        --policy h2o+kivi2 --budget 64 --continuous --buckets 128,256 \\
        --paged --chunked-prefill --chunk-len 64

    # self-speculative decoding: 4 drafts a round against a window view
    python -m repro_torch.launch.serve --arch granite-8b --reduced \\
        --policy full --continuous --speculative --gamma 4 \\
        --draft-policy window:64

    # prefix cache: requests sharing a 96-token template reuse its blocks
    python -m repro_torch.launch.serve --arch granite-8b --reduced \\
        --policy full --continuous --buckets 128 --paged \\
        --prefix-sharing --shared-prefix 96
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
    ap.add_argument("--use-kernels", choices=("on", "off"), default="on",
                    help="on: the CUDA kernels (their plain versions on "
                         "the CPU); off: the materialize / matmul "
                         "reference path")
    ap.add_argument("--paged", action="store_true",
                    help="paged block-table KV cache for --continuous: one "
                         "physical pool shared across slots, block-aware "
                         "admission, blocks recycled on retire")
    ap.add_argument("--block-len", type=int, default=16,
                    help="tokens per pool block (snapped to the store "
                         "shape; quantized stores use the flush group)")
    ap.add_argument("--pool-blocks", type=int, default=0,
                    help="physical pool size in blocks (0 = capacity "
                         "parity with the dense layout); smaller pools "
                         "refuse admission until blocks free up")
    ap.add_argument("--chunked-prefill", action="store_true",
                    help="stream admissions in --chunk-len segments "
                         "between decode steps (--continuous only): "
                         "resident slots keep emitting tokens while a "
                         "prompt loads, token streams unchanged")
    ap.add_argument("--chunk-len", type=int, default=64,
                    help="prompt tokens per prefill segment (snapped "
                         "down to the mass-accumulation group)")
    ap.add_argument("--speculative", action="store_true",
                    help="self-speculative decoding (--continuous only): "
                         "the same weights draft against a cheap cache "
                         "view, one rectangular verify commits accepted "
                         "tokens and rolls rejects back; greedy streams "
                         "equal non-speculative decode")
    ap.add_argument("--gamma", type=int, default=4,
                    help="max draft tokens per verify step (per-slot "
                         "depth is capped to the cache's rollback "
                         "headroom)")
    ap.add_argument("--draft-policy", default="window:64",
                    help="drafter cache view: window:N (sliding-window "
                         "attention over an uncompressed store), "
                         "kivi2[:budget[:window]] / kivi4 / int8 "
                         "(quantized ring), or same (target clone: "
                         "acceptance ceiling)")
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="cross-request prefix cache (--continuous --paged "
                         "only): a radix index over the pool maps repeated "
                         "prompt prefixes read-only into new slots, which "
                         "prefill only their suffix; copy-on-write "
                         "un-shares on divergence, streams unchanged")
    ap.add_argument("--near-hit", type=float, default=0.0,
                    help="CacheBlend recompute fraction in (0, 1] for "
                         "--prefix-sharing with the full policy: a prompt "
                         "overlapping a recent one by >= 0.8 with a short "
                         "exact prefix recomputes only this fraction of "
                         "its tokens instead of a full prefill "
                         "(approximate below 1; 0 disables)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="give every synthetic request the same leading N "
                         "tokens (exercises --prefix-sharing warm hits)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    if args.speculative and not args.continuous:
        ap.error("--speculative requires --continuous (the draft/verify "
                 "loop lives in the continuous engine)")
    if args.prefix_sharing and not (args.continuous and args.paged):
        ap.error("--prefix-sharing requires --continuous --paged (the "
                 "radix index maps pool blocks into block tables)")
    if args.near_hit and not args.prefix_sharing:
        ap.error("--near-hit requires --prefix-sharing")
    if args.prefix_sharing and args.speculative:
        ap.error("--prefix-sharing and --speculative are mutually "
                 "exclusive (the draft cache holds no block tables to "
                 "share)")

    device = resolve_device(args.device)
    use_kernels = args.use_kernels == "on"
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
                     use_kernels=use_kernels, device=device,
                     paged=args.paged, block_len=args.block_len,
                     pool_blocks=args.pool_blocks or None,
                     chunked_prefill=args.chunked_prefill,
                     chunk_len=args.chunk_len, speculative=args.speculative,
                     gamma=args.gamma, draft_policy=args.draft_policy,
                     prefix_sharing=args.prefix_sharing,
                     near_hit=args.near_hit)
        eos = args.eos_id if args.eos_id >= 0 else None
        shared = (rng.integers(0, cfg.vocab_size, size=args.shared_prefix)
                  if args.shared_prefix > 0 else np.zeros(0, np.int64))

        def prompt(L):
            tail = rng.integers(0, cfg.vocab_size,
                                size=max(L - len(shared), 0))
            return np.concatenate([shared[:L], tail])

        reqs = [
            Request(tokens=prompt(buckets[i % len(buckets)]),
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
        if args.paged:
            print(f"paged: pool {res.pool_blocks} blocks, peak "
                  f"{res.pool_peak_blocks}, failed {len(res.failed())}, "
                  f"audit clean={eng.last_audit['clean']}")
        if res.spec is not None:
            print(res.spec.describe())
        if res.prefix is not None:
            p = res.prefix
            print(f"prefix cache: {p['warm_hits']} warm / {p['cold']} cold "
                  f"/ {p['near_hits']} near-hit admissions; "
                  f"{p['ingested_blocks']} blocks indexed, "
                  f"{p['index_blocks']} resident, "
                  f"{p['evicted_blocks']} evicted, "
                  f"{p['cow_copies']} copy-on-write copies")
        return

    prompts = rng.integers(0, cfg.vocab_size,
                           size=(args.requests, args.prompt_len))
    eng = Engine(cfg, params, pol, prompt_len=args.prompt_len,
                 max_new=args.max_new, slots=args.slots,
                 use_kernels=use_kernels, device=device)
    res = eng.generate(prompts)
    print(f"policy={res.policy_name}")
    print(f"prefill_s={res.prefill_seconds:.2f} "
          f"decode_tok/s={res.decode_tokens_per_s:.1f}")
    print(f"compression_ratio={res.compression_ratio:.1f}x "
          f"(logical {res.cache_logical_bytes / 2**20:.1f} MiB vs "
          f"full {res.full_cache_bytes / 2**20:.1f} MiB)")


if __name__ == "__main__":
    main()
