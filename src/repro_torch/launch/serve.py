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

    # overload ladder: lazy block growth on a small pool; a starved slot
    # preempts the least-progressed one, which later resumes by replay
    python -m repro_torch.launch.serve --arch granite-8b --reduced \\
        --policy full --continuous --paged --block-growth lazy \\
        --preemption --pool-blocks 70 --audit-every 4

    # ... with the host-RAM tier: preempted slots spill and restore
    python -m repro_torch.launch.serve --arch granite-8b --reduced \
        --policy full --continuous --paged --block-growth lazy \
        --preemption --pool-blocks 70 --tiering

    # pressure-driven degradation of resident kivi2 slots
    python -m repro_torch.launch.serve --arch granite-8b --reduced \
        --policy kivi2 --budget 32 --window 8 --continuous --paged \
        --block-growth lazy --preemption --degrade

    # a full-width config on the card (no --reduced): qwen2.5-32b, 64
    # layers, kivi2 over a paged pool with 512-token prefill segments
    python -m repro_torch.launch.serve --arch qwen2.5-32b --policy kivi2 \
        --budget 512 --window 128 --requests 8 --buckets 1024,2048 \
        --max-new 64 --slots 8 --continuous --paged --chunked-prefill \
        --chunk-len 512 --metrics-json metrics.json

    # a mixture-of-experts arch (reduced: 4 experts, mixtral's window
    # cut to 64); --chunked-prefill / --prefix-sharing / --speculative
    # refuse experts, as the JAX CLI does, and --paged admits whole
    # prompts
    python -m repro_torch.launch.serve --arch mixtral-8x22b --reduced \
        --policy kivi2 --budget 32 --window 8 --continuous \
        --buckets 80,96 --paged

    # the hybrid (reduced jamba-v0.1-52b: a Mamba-2 mixer and an
    # attention layer with an MoE FFN per superblock); the attention
    # layers hold the compressed cache, the Mamba-2 layers their
    # constant-size state. mamba2-130m has no attention layer: the engine
    # refuses it (serve it through nn.model.prefill / decode_step)
    python -m repro_torch.launch.serve --arch jamba-v0.1-52b --reduced \\
        --policy kivi2 --budget 32 --window 8 --continuous --paged

    # the encoder-decoder (seamless-m4t-large-v2) on the wave path: each
    # wave encodes its requests' source frames (seeded standard normal,
    # max(prompt_len // 4, 16) frames, the stubbed speech frontend's
    # output) and its decoder cross-attends them; --continuous refuses
    # it, as the JAX CLI does
    python -m repro_torch.launch.serve --arch seamless-m4t-large-v2 \
        --policy kivi2 --budget 512 --window 128 --requests 16 \
        --prompt-len 1024 --max-new 64 --slots 8

    # telemetry: a Chrome trace (Perfetto / chrome://tracing) and the
    # metrics snapshot (schema "repro.obs.metrics/1") of a run
    python -m repro_torch.launch.serve --arch granite-8b --reduced \
        --policy nacl --continuous --paged --trace trace.json \
        --metrics-json metrics.json
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs.base import get_config, reduced
from repro_torch.core.policy import presets
from repro_torch.nn import model as M
from repro_torch.obs import Metrics, Tracer, write_metrics_json
from repro_torch.serving.engine import Engine, resolve_device
from repro_torch.serving.scheduler import Request


def main(argv: Optional[Sequence[str]] = None):
    """Run the CLI; returns (engine, result) for a caller that drives it
    in-process (the engine holds the run's parameters)."""
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
    ap.add_argument("--block-growth", choices=("eager", "lazy"),
                    default="eager",
                    help="paged block reservation: eager reserves a "
                         "request's whole budgeted length at admission; "
                         "lazy grants blocks as it decodes (a starved slot "
                         "preempts with --preemption, else retires 'oom')")
    ap.add_argument("--admission-order", choices=("fifo", "shortest-prompt"),
                    default="fifo",
                    help="queue order of admissions: shortest-prompt lets "
                         "short prompts jump long ones")
    ap.add_argument("--preemption", action="store_true",
                    help="overload ladder (--continuous only): a pool-"
                         "starved admission or decode step preempts the "
                         "least-progressed resident slot, which requeues "
                         "and resumes with an equal stream by prompt "
                         "re-prefill + token replay; requests fail only "
                         "when they cannot fit an empty pool")
    ap.add_argument("--degrade", action="store_true",
                    help="pressure-driven budget degradation (--paged "
                         "--block-growth lazy, quantized policy): above a "
                         "high-water mark of pool usage, resident slots "
                         "drop their oldest flushed groups until usage "
                         "falls to the low-water mark — the reversible "
                         "rung below preemption")
    ap.add_argument("--tiering", action="store_true",
                    help="KV tiering (--continuous --paged only): a "
                         "host-RAM block tier under the pool — preempted "
                         "slots spill their blocks and restore on "
                         "re-admission instead of recomputing, cold "
                         "prefix-cache blocks demote instead of being "
                         "freed, and the overload ladder gains a spill "
                         "rung ahead of degrade / preempt / fail")
    ap.add_argument("--host-blocks", type=int, default=0,
                    help="host tier capacity in blocks for --tiering "
                         "(0 = same as the device pool)")
    ap.add_argument("--audit-every", type=int, default=0,
                    help="audit the pool (allocator refcounts vs slot "
                         "grants vs device block tables vs prefix index) "
                         "every N decode steps (--paged only; 0 = only at "
                         "the end of the run)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="give every synthetic request the same leading N "
                         "tokens (exercises --prefix-sharing warm hits)")
    ap.add_argument("--trace", default="", metavar="PATH",
                    help="record the run's event timeline (request spans, "
                         "preempt / spill / degrade / CoW / prefix "
                         "instants, per-iteration step spans) and export "
                         "Chrome trace_event JSON to PATH (Perfetto, "
                         "chrome://tracing); span times are host times")
    ap.add_argument("--trace-capacity", type=int, default=65536,
                    help="trace ring capacity in events; overflow drops "
                         "the oldest (the exported tail is what a "
                         "post-mortem wants)")
    ap.add_argument("--metrics-json", default="", metavar="PATH",
                    help="dump the run's metrics registry snapshot "
                         "(tok/s, TTFT / inter-token histograms, pool / "
                         "tier / preemption counters) as JSON to PATH, in "
                         "the JAX package's schema")
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
    if args.block_growth == "lazy" and not args.paged:
        ap.error("--block-growth lazy requires --paged")
    if args.preemption and not args.continuous:
        ap.error("--preemption requires --continuous (wave requests "
                 "never contend for a shared pool)")
    if args.degrade and not (args.paged and args.block_growth == "lazy"):
        ap.error("--degrade requires --paged --block-growth lazy")
    if args.tiering and not (args.continuous and args.paged):
        ap.error("--tiering requires --continuous --paged (the host tier "
                 "spills pool blocks)")
    if args.tiering and args.speculative:
        ap.error("--tiering and --speculative are mutually exclusive "
                 "(the draft cache holds no block tables to spill)")
    if args.host_blocks and not args.tiering:
        ap.error("--host-blocks requires --tiering")
    if args.audit_every and not args.paged:
        ap.error("--audit-every requires --paged (it audits the pool)")

    device = resolve_device(args.device)
    use_kernels = args.use_kernels == "on"
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    params = M.init_params(cfg, seed=0, device=device)
    pol = presets(budget=args.budget, window=args.window)[args.policy]
    rng = np.random.default_rng(0)
    tracer = Tracer(args.trace_capacity) if args.trace else None
    metrics = Metrics() if args.metrics_json else None

    def export_telemetry() -> None:
        if tracer is not None:
            tracer.export(args.trace)
            print(f"trace: {len(tracer)} events -> {args.trace}"
                  + (f" ({tracer.dropped} dropped)" if tracer.dropped
                     else ""))
        if metrics is not None:
            write_metrics_json(metrics, args.metrics_json)
            print(f"metrics: {len(metrics)} instruments -> "
                  f"{args.metrics_json}")

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
                     near_hit=args.near_hit, block_growth=args.block_growth,
                     admission_order=args.admission_order,
                     preemption=args.preemption, degrade=args.degrade,
                     tiering=args.tiering,
                     host_blocks=args.host_blocks or None,
                     audit_every=args.audit_every, tracer=tracer,
                     metrics=metrics)
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
        n_pre = sum(r.n_preemptions for r in res.results)
        n_ret = sum(r.n_retries for r in res.results)
        if args.preemption or n_pre or n_ret:
            print(f"overload: {n_pre} preemptions, {n_ret} admission "
                  f"retries across {len(res.results)} requests")
        if args.degrade and eng.pressure is not None:
            st = eng.pressure.stats
            print(f"pressure: {st['degrades']} degrades dropped "
                  f"{st['blocks_dropped']} blocks, peak pool usage "
                  f"{st['peak_used_frac']:.2f}")
        if args.tiering and res.tier is not None:
            t = res.tier
            ratio = t["fp16_block_bytes"] / max(t["block_bytes"], 1)
            print(f"tier: {t['n_spills']} spills / {t['n_fetches']} "
                  f"fetches moved {t['bytes_moved'] / 2**20:.1f} MiB "
                  f"(fp16 transport would be {ratio:.1f}x), "
                  f"fetch stalls {t['fetch_stall_s'] * 1e3:.1f} ms, "
                  f"{t['host_entries']} entries / "
                  f"{t['host_resident']} blocks host-resident of "
                  f"{t['host_blocks']} (refused "
                  f"{t['refused_fetches']} fetches, stripped "
                  f"{t['grants_stripped']} grants)")
        if args.paged:
            a = eng.last_audit
            print(f"paged: pool {res.pool_blocks} blocks, peak "
                  f"{res.pool_peak_blocks}, failed {len(res.failed())}, "
                  f"oom {sum(r.finish_reason == 'oom' for r in res.results)}"
                  f"; pool audit clean={a['clean']} ({a['allocated']} "
                  f"allocated / {a['free']} free of {a['n_blocks']} blocks)")
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
        export_telemetry()
        return eng, res

    prompts = rng.integers(0, cfg.vocab_size,
                           size=(args.requests, args.prompt_len))
    src = None
    if cfg.is_encoder_decoder:
        # the stubbed frontend's frames, drawn after the prompts
        src = rng.standard_normal(
            (args.requests, max(args.prompt_len // 4, 16), cfg.d_model)
        ).astype(np.float32)
    eng = Engine(cfg, params, pol, prompt_len=args.prompt_len,
                 max_new=args.max_new, slots=args.slots,
                 use_kernels=use_kernels, device=device, tracer=tracer,
                 metrics=metrics)
    res = eng.generate(prompts, src_embeds=src)
    print(f"policy={res.policy_name}")
    print(f"prefill_s={res.prefill_seconds:.2f} "
          f"decode_tok/s={res.decode_tokens_per_s:.1f}")
    print(f"compression_ratio={res.compression_ratio:.1f}x "
          f"(logical {res.cache_logical_bytes / 2**20:.1f} MiB vs "
          f"full {res.full_cache_bytes / 2**20:.1f} MiB)")
    export_telemetry()
    return eng, res


if __name__ == "__main__":
    main()
