#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (`src/repro_torch`).

    python3 chip_smoke.py            # one H100; takes no arguments

Phases, each printing its own lines; any failure exits non-zero:

  1. device   card name, count, torch / CUDA / nvcc versions, power limit
  2. build    the three CUDA sources from the checkout (one nvcc per
              source, started together; the decode source holds two
              kernels, the flash source three, the KIVI quantize source
              three: K, V, and both of a flush in one launch), with
              nvcc's -Xptxas -v lines
  3. parity   each kernel against its plain PyTorch version at the main
              path's shapes (granite-8b: Hq 32, Hkv 8, D 128), timed
              beside the plain version and a PyTorch library yardstick;
              the paged decode kernel against the dense one on the same
              rows, and the chunked flash kernel's segments against the
              monolithic one, both bit for bit; the split-KV
              speculative-verify kernel over dense, quantized-ring and
              paged cache views (two launches bit-equal); the back-compat
              quantized decode wrapper; the fused KIVI quantize-and-pack
              kernels (K, V, and the one launch of both that the cache
              makes) at the flush and prompt shapes; then B1, B3, B2,
              B4 and B5 at each head group of phase 7 (Gq 1 / D 64, Gq 5,
              6, 8 and 12), f32 and bf16, B5's 60 packed rows at Gq 12 in
              two row tiles; mixtral's sliding window: B2 at T 6144, Gq
              6, window 4096 (tiles outside the window skipped) and B5
              at Gq 6 over a 6208-row view with window 4096
  4. serve    granite-8b at full width and depth, random bf16 weights from
              a seed, `Engine.generate_continuous` under full / h2o /
              kivi2 / h2o+kivi2 and the noisy nacl / keyformer (dense
              cache, monolithic prefill; the last two beside h2o), then
              full / kivi2 / h2o+kivi2 over a paged pool with chunked
              prefill (`full` with the Tracer and Metrics on: the trace
              reloads, its counters equal the result, the host seconds
              of each span printed), then the temperature / top-k
              sampler (top_k 1 equal to greedy, top_k 50 beside it),
              then self-speculative decoding (gamma 4) on 9 of the 36
              layers, each beside a plain twin of that depth: full with
              the `same` drafter, kivi2 with a `window:64` drafter, full
              paged + chunked with `same`; then the overload ladder
              (paged + chunked, 8 requests): full with lazy block growth
              and preemption on a pool that starves mid-decode, kivi2 with
              three forced preemptions, each held token for token to its
              unpreempted run with clean periodic pool audits; the same
              starving full run with the host-RAM tier (every preemption
              spills to pinned host memory on a side stream and restores,
              no re-prefill, no replay; the same streams), twice:
              untraced and traced (spill <= preempt <= restore <= fetch
              in the trace; the two walls printed), and kivi2 with
              pressure-driven degradation at a pool whose usage crosses
              the high-water mark (resident slots drop groups; B6 goes on
              flushing into the regrown ones); then the
              prefix cache (paged + chunked, templated prompts): full and
              kivi2 with sharing, each beside the same requests without,
              and full near-hits through CacheBlend at recompute 1.0 and
              0.25 (9 of the 36 layers); each run must go through its
              kernels, and only its kernels, as many times as its steps
              (flushes and quantized admissions for KIVI; re-admissions
              of preempted requests)
  5. e2e      4-layer granite-8b: prefill + decode logits with the kernels
              against an engine built with use_kernels=False, dense and
              paged + chunked; then in f32 the speculative streams against
              the plain ones, the sharing streams against the non-sharing
              ones (and a near-hit at recompute 1.0 against a cold
              admission), kivi2 with the fused quantizer against the
              plain one, and preempted runs (dense, kivi2 paged + chunked,
              lazy growth on a starving pool, speculative) against their
              unpreempted twins, token for token, and with the host tier
              (full and kivi2, every preemption restored); kivi2 with
              degradation through the kernels against the same run with
              use_kernels=False (degrades, blocks dropped, streams);
              nacl, keyformer (dense, paged + chunked) and the
              temperature sampler through the kernels against
              use_kernels=False under one seed (streams equal), the
              sampler's seed 0 twice (equal) and seeds 0 / 1 (differ)
  6. profile  one decode step at full depth, 8 slots, dense and paged, and
              one verify round: wall vs dispatch time, device-busy time
              and the top kernels (torch.profiler); for h2o+kivi2 also a
              step whose ring flushes (the fused quantizer's share)
  7. configs  the further configs at full width, one on the card at a
              time: minicpm-2b (Gq 1, D 64; full and h2o dense),
              qwen2.5-32b (Gq 5, QKV bias; kivi2 paged + chunked through
              the serving CLI, its metrics snapshot read, one decode step
              profiled) at full depth, chameleon-34b (Gq 8, the vlm
              config; full paged + chunked) on 24 of 48 layers,
              command-r-plus-104b (Gq 12; full dense and speculative with
              the `same` drafter) on 8 of 64; the mixture-of-experts decoders mixtral-8x22b (Gq 6,
              window 4096, prompts of 6144 and 2048; full dense, kivi2
              paged with monolithic admission) on 8 of 56 layers and
              kimi-k2-1t-a32b (Gq 8, 384 experts top 8; full and h2o
              dense) on 1 of 61, each MoE FFN held to its f32 oracle at
              full width, drop fractions at decode printed, one decode
              step profiled; launches exact, then each config at 4
              layers (or its cut) with the kernels against
              use_kernels=False, dense and paged, an f32 reference path
              beside them where its weights fit; the hybrid
              jamba-v0.1-52b (Gq 4; a superblock of 8 layers holds one
              attention layer and seven Mamba-2 mixers, MoE of 16
              experts top 2 every second layer) on 16 of 32 layers: full
              dense and kivi2 paged (monolithic admission), launches
              exact (2 attention layers), its MoE FFN held to the f32
              oracle, one decode step profiled, the e2e on one 8-layer
              superblock, and there the host tier on a starving pool
              (every preemption spills and restores the slot's SSM state
              with its blocks) token-equal to its unpreempted twin; then
              mamba2-130m at full size through the model-level prefill
              and decode (the engine refuses it: no attention layer),
              every kernel counter 0, decode continuing prefill in f32,
              `ssd_chunked` against the sequential recurrence
  8. kvsharer granite-8b through the layer-sharing runner: 9 of 36 layers
              share a calibrated source's cache (27/36 of the model's
              own prefill cache of the same prompts, B2
              once per unshared layer, B1 once per layer a step), then at
              4 layers against use_kernels=False and, with no sharing,
              against the model's own prefill and decode
  9. encdec   seamless-m4t-large-v2 at full size (24 encoder + 24
              decoder layers, Gq 1, D 64) through the wave path
              (`Engine.generate`): 16 requests of 1024 tokens, each with
              256 seeded source frames, two waves of 8; full and h2o,
              kivi2 through the serving CLI; launches exact (B2 once per
              layer a wave, B1 once per layer a decode step, B6 per
              admission and flush); then on a 4 + 4 layer cut the
              kernels against use_kernels=False, the bf16 paths against
              an f32 reference path, and f32 decode continuing
              `train_forward`'s logits
 10. train    `launch/train.py` at full size, bf16 params and f32
              moments, remat: 4 steps of 8 x 256 tokens of seamless
              (cosine) and minicpm-2b (WSD); loss, ce, lr, grad norm,
              step wall, tokens/s and peak memory per step; finite, every
              weight matrix moved, no kernel launched; the first step's
              loss in bf16 against f32 on seamless's 4 + 4 layer cut
 11. shard    the sharded path (DTensor over torch.distributed):
              `launch/train.py --mesh host` as one NCCL rank (mesh 1 x 1)
              against phase 10's minicpm-2b steps; two gloo ranks
              spawned on the one card (mesh 1 x 2, tp 2; a probe first
              finds the collectives gloo cannot run on CUDA tensors, which
              then go through host memory, printed): granite-8b at full
              width on 18 of 36 layers, 4 x 1024 prompts + 16 steps under
              full and h2o+kivi2 against the one-rank run, B2 / B1 / B6
              launches exact per rank, both ranks' kept positions equal;
              mixtral-8x22b's MoE FFN through `moe_apply_expert_parallel`
              (4 of 8 experts a rank) against the f32 oracle, one
              all-reduce; then the production dry run, every arch but
              paper-llama-7b x the four shapes on a fake 256-rank mesh
              (CPU worker processes started with the script, overlapping
              phases 1-10), and perf_moe's two collective totals

Then one JSON line describing every ported kernel, and as the last line
``{"ok": true, "device": {...}}``. There is no CPU path: without a CUDA
device the script exits non-zero before printing any result.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

PHASES = ("device", "build", "parity", "serve", "e2e", "profile", "configs",
          "kvsharer", "encdec", "train", "shard")
# kernel vs plain version, |kernel - plain| <= atol + rtol * |plain|.
# Both sides compute in f32 on the same (bf16-rounded) inputs, so they
# differ by f32 summation order (readings <= 1e-6) and, for bf16 outputs,
# by the final rounding: at most one bf16 ulp, <= 2^-7 |out| (readings:
# out 4.9e-4 at |out| in [2^-4, 2^-3), flash prefill 2.0e-3 in
# [2^-2, 2^-1), flash verify 7.8e-3 in [1, 2)). Masses are f32 on both
# sides (readings <= 4.8e-7).
OUT_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (1e-4, 1e-2)}
MASS_TOL = (1e-5, 1e-5)
# published H100 SXM peaks (NVIDIA H100 datasheet: HBM3 rate, dense tensor/FP32 rates)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def fail(msg: str) -> None:
    raise SystemExit("chip_smoke: FAIL: " + msg)


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of `reps` timed calls (CUDA events, after warm-up)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, n: int = 20) -> float:
    """Kernel time per call of `fn` on the device (torch.profiler, the
    sum of its kernels over `n` calls): an event-timed call also holds
    the host time the device waits on before its kernel is enqueued."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / n


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def check_close(what: str, got, want, atol: float, rtol: float) -> float:
    """Fail unless |got - want| <= atol + rtol * |want| everywhere;
    returns max |got - want|."""
    d = (got.float() - want.float()).abs()
    err = d.max().item()
    ok = bool((d <= atol + rtol * want.float().abs()).all())
    if not (ok and math.isfinite(err)):
        fail(f"{what}: max|err| {err:.3g} beyond atol {atol} + rtol {rtol}")
    return err


def bound(bytes_moved: float, flops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------


def phase_device(info: dict) -> None:
    import torch
    info["kind"] = torch.cuda.get_device_name(0)
    info["count"] = torch.cuda.device_count()
    print(f"[device] {info['kind']} x{info['count']} torch "
          f"{torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}")
    from repro_torch.kernels.build import find_nvcc
    nv = subprocess.run([find_nvcc(), "--version"], capture_output=True,
                        text=True).stdout.strip().splitlines()
    print("[device] nvcc: " + (nv[-1] if nv else "?"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    info["smi"] = smi.stdout.strip().splitlines()[0] if smi.stdout else "?"
    print(info["smi"])


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------


def phase_build(info: dict) -> None:
    from repro_torch.kernels.decode_qattn import ops as dq
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.kernels.kvquant import ops as kvq
    sources = [dq.SOURCE, fp.SOURCE, kvq.SOURCE]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as ex:
        for src, fut in [(s, ex.submit(s.build)) for s in sources]:
            fut.result()
            for line in src.build_log.splitlines():
                if "registers" in line or "spill" in line or "smem" in line:
                    print(f"[build] {src.path.name}: {line.strip()}")
    print(f"[build] {len(sources)} sources (8 kernels) built in "
          f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# 3. parity (+ timing) at main-path shapes
# ---------------------------------------------------------------------------


def _decode_case(torch, dt, bits, ring, B=8, S=512, W=128, Hq=32, Hkv=8,
                 D=128, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    f32 = torch.float32

    def rnd(*shape, dtype=f32):
        return torch.randn(*shape, generator=g, device=dev, dtype=f32).to(dtype)

    q = rnd(B, Hq, D, dtype=dt)
    # ragged rows, one all-empty slot (row 3): every key masked there
    length = torch.tensor([512, 300, 17, 0, 511, 128, 64, 1], device=dev)
    rlen = torch.tensor([128, 5, 1, 0, 64, 128, 1, 127], device=dev)
    bias_main = torch.where(torch.arange(S, device=dev)[None] < length[:, None],
                            0.0, -1e30).to(f32)
    if bits < 16:
        Dp = D * bits // 8
        k = torch.randint(-128, 128, (B, S, Hkv, Dp), generator=g, device=dev,
                          dtype=torch.int8)
        v = torch.randint(-128, 128, (B, S, Hkv, Dp), generator=g, device=dev,
                          dtype=torch.int8)
        ks = rnd(B, S // W, Hkv, D).abs() * 0.1 + 0.01
        kz = rnd(B, S // W, Hkv, D)
        vs = rnd(B, S, Hkv).abs() * 0.1 + 0.01
        vz = rnd(B, S, Hkv)
    else:
        k, v = rnd(B, S, Hkv, D, dtype=dt), rnd(B, S, Hkv, D, dtype=dt)
        ks = kz = vs = vz = None
    if ring:
        rk, rv = rnd(B, W, Hkv, D, dtype=dt), rnd(B, W, Hkv, D, dtype=dt)
        bias_ring = torch.where(torch.arange(W, device=dev)[None]
                                < rlen[:, None], 0.0, -1e30).to(f32)
    else:
        rk = rv = bias_ring = None
    return (q, k, ks, kz, v, vs, vz, bias_main, rk, rv, bias_ring)


def phase_parity(info: dict) -> None:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_qattn import ops as dq
    from repro_torch.kernels.decode_qattn.ref import decode_attn_ref
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = info.setdefault("kernel_rows", {})

    # ---- B1: fused decode attention ----
    grid = []
    for dt in (torch.float32, torch.bfloat16):
        for bits in (2, 16):
            for mass in (True, False):
                for ring in ((True,) if bits < 16 else (True, False)):
                    grid.append((dt, bits, mass, ring))
    for dt, bits, mass, ring in grid:
        args = _decode_case(torch, dt, bits, ring)
        kw = dict(bits=bits, group=128, return_mass=mass, compute_dtype=dt)
        out_k, m_k = dq.decode_attn_cuda(*args, **kw)
        out_r, m_r = decode_attn_ref(*args, bits=bits, group=128,
                                     compute_dtype=dt)
        torch.cuda.synchronize()
        what = f"decode_attn {dt} bits={bits} mass={mass} ring={ring}"
        err = check_close(what + " out", out_k, out_r,
                          *OUT_TOL[str(dt)[6:]])
        merr = (check_close(what + " mass", m_k, m_r, *MASS_TOL)
                if mass else 0.0)
        ms = median_ms(lambda: dq.decode_attn_cuda(*args, **kw))
        plain_ms = median_ms(lambda: decode_attn_ref(
            *args, bits=bits, group=128, compute_dtype=dt))
        lib_ms = None
        q, k, _, _, v, _, _, bm, rk, rv, br = args
        if bits == 16 and not mass:
            kk = torch.cat([k, rk], 1) if ring else k
            vv = torch.cat([v, rv], 1) if ring else v
            bb = torch.cat([bm, br], 1) if ring else bm
            qh = q[:, :, None]                                 # [B,Hq,1,D]
            kh, vh = kk.transpose(1, 2), vv.transpose(1, 2)    # [B,Hkv,S,D]
            mask = bb[:, None, None].to(dt)
            lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, enable_gqa=True))
        B, Hq, D = q.shape
        Stot = k.shape[1] + (rk.shape[1] if ring else 0)
        moved = nbytes(*args, out_k) + (nbytes(m_k) if mass else 0)
        flops = 4.0 * B * Hq * Stot * D
        bms, by = bound(moved, flops, str(dt).split(".")[1])
        print(f"[parity] decode_attn {str(dt)[6:]} bits={bits} mass={mass} "
              f"ring={ring}: max|err| out {err:.3g} mass {merr:.3g}; "
              f"{ms:.4f} ms (plain {plain_ms:.4f} ms, sdpa "
              f"{'null' if lib_ms is None else '%.4f ms' % lib_ms}, bound "
              f"{bms:.4f} ms by {by}, {bms / ms:.1%} of it)")

    # ---- B2: causal flash prefill ----
    for dt in (torch.float32, torch.bfloat16):
        for T in (1024, 2048):
            g = torch.Generator(device="cuda").manual_seed(T)
            q, k, v = (torch.randn(1, T, h, 128, generator=g, device="cuda")
                       .to(dt) for h in (32, 8, 8))
            out_k = fp.flash_prefill_cuda(q, k, v)
            out_r = flash_prefill_ref(q, k, v)
            torch.cuda.synchronize()
            err = check_close(f"flash_prefill {dt} T={T}", out_k, out_r,
                              *OUT_TOL[str(dt)[6:]])
            ms = median_ms(lambda: fp.flash_prefill_cuda(q, k, v), reps=10)
            plain_ms = median_ms(lambda: flash_prefill_ref(q, k, v), reps=5)
            qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
            lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True, enable_gqa=True), reps=10)
            moved = nbytes(q, k, v, out_k)
            flops = 4.0 * 32 * 128 * T * (T + 1) / 2
            bms, by = bound(moved, flops, str(dt).split(".")[1])
            dev = device_ms(lambda: fp.flash_prefill_cuda(q, k, v), n=10)
            print(f"[parity] flash_prefill {str(dt)[6:]} T={T}: max|err| "
                  f"{err:.3g}; {ms:.4f} ms, device {dev:.4f} ms (plain "
                  f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
                  f"{bms:.4f} ms by {by}, {bms / ms:.1%} of it)")
            if dt == torch.bfloat16 and T == 2048:
                rows["flash_prefill"] = dict(
                    name="flash_prefill_cuda", route="cuda",
                    source="src/repro_torch/kernels/flash_prefill/csrc/"
                           "flash_prefill.cu",
                    replaces="src/repro/kernels/flash_prefill/kernel.py:257",
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                    bound_by=by, library_ms=lib_ms)
            del q, k, v, out_k, out_r
    _parity_decode_full_path(info)
    _parity_paged_decode(info)
    _parity_paged_full_path(info)
    _parity_chunk_prefill(info)
    _parity_verify(info)
    _parity_quantized_wrapper(info)
    _parity_kvquant(info)
    _parity_config_shapes(info)
    _parity_window(info)


def _parity_decode_full_path(info: dict) -> None:
    """B1 at the case the `full` serve path runs (the largest share of
    its device time): bf16, dense 16-bit store of S = 2112 rows (prompt
    2048 + 64 new), no ring, no mass, ragged rows and one empty slot. It
    has a one-call library equivalent: SDPA with the validity bias as a
    float mask (mask construction excluded)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.build import decode_splits, sm_count
    from repro_torch.kernels.decode_qattn import ops as dq
    from repro_torch.kernels.decode_qattn.ref import decode_attn_ref
    args = _decode_case(torch, torch.bfloat16, 16, False, S=FULL_S)
    q, k, _, _, v, _, _, bm = args[:8]
    bm[:, :] = torch.where(torch.arange(FULL_S, device="cuda")[None]
                           < torch.tensor([2112, 2000, 1024, 0, 1500, 64, 2,
                                           1100], device="cuda")[:, None],
                           0.0, -1e30)
    kw = dict(bits=16, group=128, return_mass=False,
              compute_dtype=torch.bfloat16)
    out_k, _ = dq.decode_attn_cuda(*args, **kw)
    out_r, _ = decode_attn_ref(*args, bits=16, group=128,
                               compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    err = check_close("decode_attn full path out", out_k, out_r,
                      *OUT_TOL["bfloat16"])
    ms = median_ms(lambda: dq.decode_attn_cuda(*args, **kw))
    plain_ms = median_ms(lambda: decode_attn_ref(
        *args, bits=16, group=128, compute_dtype=torch.bfloat16))
    qh, kh, vh = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    mask = bm[:, None, None].to(torch.bfloat16)
    lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, enable_gqa=True))
    B, Hq, D = q.shape
    bms, by = bound(nbytes(q, k, v, bm, out_k), 4.0 * B * Hq * FULL_S * D,
                    "bfloat16")
    dev = device_ms(lambda: dq.decode_attn_cuda(*args, **kw))
    n_split, _ = decode_splits(B, k.shape[2], FULL_S, sm_count(q.device))
    print(f"[parity] decode_attn bfloat16 bits=16 S={FULL_S} mass=False "
          f"ring=False (the full path, {n_split} splits: "
          f"{B * k.shape[2] * n_split} CTAs): max|err| out {err:.3g}; "
          f"{ms:.4f} ms, device {dev:.4f} ms "
          f"(plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
          f"{bms:.4f} ms by {by}, {bms / ms:.1%} of it)")
    info["kernel_rows"]["decode_attn"] = dict(
        name="decode_attn_cuda", route="cuda",
        source="src/repro_torch/kernels/decode_qattn/csrc/decode_attn.cu",
        replaces="src/repro/kernels/decode_qattn/kernel.py:158",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=lib_ms)


# the serve path's cache views: `full` keeps prompt + new tokens verbatim,
# kivi2 a 512-row quantized store and a 128-row ring
FULL_S = 2112
GAMMA = 4


def _verify_case(torch, dt, *, kind: str, B=8, Hq=32, Hkv=8, D=128, seed=0,
                 S_full=FULL_S, before=(2048, 1500, 1030, 0, 2000, 1024, 7,
                                        2100)):
    """A speculative-verify input at the serve path's shapes: an L = 5
    segment (gamma 4) per slot, already appended, over the materialized
    view the engine hands the kernel. `kind`:

      * ``full``   dense view of S = `S_full` rows (2112), positions 0.. in
                   order, `before` committed rows a slot, the segment in
                   the main store (ring-free: W 0);
      * ``kivi``   512 main rows at streaming positions + a 128-row ring
                   whose `pos - rlen + arange` labels are true positions,
                   the segment in the ring;
      * ``paged``  the `full` view gathered from a shuffled 16-row-block
                   pool (-1 past each slot's length, read as block 0).

    Ragged segments: valid_len 5, 4, 3, 2, 1, 0, 5, 1 (rows past it still
    run at their positions; slot 5 appended nothing). Slot 3 holds no
    committed row (`full`: its rows see only its own segment; `kivi`: an
    empty main store). Returns (q, k, v, kv_pos, bias, q_pos)."""
    from repro_torch.kernels.decode_qattn.ref import gather_pool
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev, L = "cuda", GAMMA + 1

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dt)

    valid = torch.tensor([5, 4, 3, 2, 1, 0, 5, 1], device=dev)
    if kind in ("full", "paged"):
        S = S_full
        # committed rows before the segment, then the valid segment rows
        before = torch.tensor(before, device=dev)
        length = before + valid
        idx = torch.arange(S, device=dev)[None]
        kv_pos = torch.where(idx < length[:, None], idx, -1).to(torch.int32)
        bias = torch.where(idx < length[:, None], 0.0, -1e30)
        k, v = rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
        if kind == "paged":
            bl, n_max = 16, S // 16
            nb = B * n_max + 5
            ids = torch.randperm(nb, generator=g, device=dev)[:B * n_max]
            used = (torch.arange(n_max, device=dev)[None] * bl
                    < length[:, None])
            tbl = torch.where(used, ids.view(B, n_max), -1).to(torch.int32)
            pool_k, pool_v = rnd(nb, bl, Hkv, D), rnd(nb, bl, Hkv, D)
            k = gather_pool(pool_k, tbl).contiguous()
            v = gather_pool(pool_v, tbl).contiguous()
        q_pos = (before[:, None] + torch.arange(L, device=dev)[None])
    else:
        S, W = 512, 128
        pos_before = torch.tensor([2048, 1500, 1030, 40, 2000, 1024, 600,
                                   2100], device=dev)
        rlen = torch.tensor([100, 5, 127, 4, 64, 1, 5, 128], device=dev)
        rlen = torch.maximum(rlen, valid)     # the segment sits in the ring
        pos = pos_before + valid
        n_main = torch.tensor([512, 384, 512, 0, 512, 512, 256, 512],
                              device=dev)
        idx = torch.arange(S, device=dev)[None]
        # streaming keeps the sinks and the most recent flushed groups
        main_pos = torch.where(idx < 128, idx,
                               (pos - rlen)[:, None] - (n_main[:, None] - idx))
        main_ok = idx < n_main[:, None]
        ring_idx = torch.arange(W, device=dev)[None]
        ring_pos = (pos - rlen)[:, None] + ring_idx
        kv_pos = torch.cat([torch.where(main_ok, main_pos, -1), ring_pos],
                           1).to(torch.int32)
        bias = torch.cat([torch.where(main_ok, 0.0, -1e30),
                          torch.where(ring_idx < rlen[:, None], 0.0, -1e30)],
                         1)
        k, v = rnd(B, S + W, Hkv, D), rnd(B, S + W, Hkv, D)
        q_pos = pos_before[:, None] + torch.arange(L, device=dev)[None]
    return (rnd(B, L, Hq, D), k, v, kv_pos, bias.float().contiguous(),
            q_pos.to(torch.int32).contiguous())


def _parity_verify(info: dict) -> None:
    """B5 against its plain version: f32 and bf16, the `full` dense view,
    the kivi2 quantized-ring view at window 0 and 64, and the paged view;
    a second launch on the same inputs must be bit-equal (the split merge
    does not depend on which CTA arrives last). Each case is timed beside
    its plain version and SDPA with the float mask built from kv_pos /
    q_pos / window / bias (built outside the timing); bf16 cases also
    read the kernel's device time (profiler)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.build import sm_count
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.kernels.flash_prefill.ref import flash_verify_ref
    rows = info["kernel_rows"]
    for dt in (torch.float32, torch.bfloat16):
        for kind, window in (("full", 0), ("kivi", 0), ("kivi", 64),
                             ("paged", 0)):
            args = _verify_case(torch, dt, kind=kind)
            out_k = fp.flash_verify_cuda(*args, window=window)
            out_2 = fp.flash_verify_cuda(*args, window=window)
            out_r = flash_verify_ref(*args, window=window)
            torch.cuda.synchronize()
            name = str(dt)[6:]
            what = f"flash_verify {name} {kind} window={window}"
            err = check_close(what, out_k, out_r, *OUT_TOL[name])
            if not torch.equal(out_k, out_2):
                fail(f"{what}: two launches on the same inputs differ")
            ms = median_ms(lambda: fp.flash_verify_cuda(*args, window=window))
            plain_ms = median_ms(lambda: flash_verify_ref(*args,
                                                          window=window))
            q, k, v, kv_pos, bias, q_pos = args
            ok = kv_pos[:, None, :] <= q_pos[:, :, None]
            if window:
                ok = ok & (kv_pos[:, None, :] > q_pos[:, :, None] - window)
            mask = (bias[:, None, :] + torch.where(ok, 0.0, -1e30)
                    )[:, None].to(dt)                       # [B,1,L,Tk]
            qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, enable_gqa=True))
            B, L, Hq, D = q.shape
            Tk, Hkv = k.shape[1], k.shape[2]
            bms, by = bound(nbytes(*args, out_k),
                            4.0 * B * Hq * L * Tk * D, name)
            n_rt, n_split, split_len = fp.verify_splits(
                B, Hkv, Hq // Hkv * L, Tk, sm_count(q.device))
            dev = (device_ms(lambda: fp.flash_verify_cuda(*args,
                                                          window=window))
                   if dt == torch.bfloat16 else None)
            print(f"[parity] {what} (B {B}, L {L}, Tk {Tk}; {n_split} "
                  f"splits of {split_len}: {B * Hkv * n_rt * n_split} "
                  f"CTAs): max|err| {err:.3g}, repeat bit-equal; {ms:.4f} "
                  f"ms{'' if dev is None else ', device %.4f ms' % dev} "
                  f"(plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
                  f"{bms:.4f} ms by {by}, {bms / ms:.1%} of it)")
            if dt == torch.bfloat16 and kind == "full":
                rows["flash_verify"] = dict(
                    name="flash_verify_cuda", route="cuda",
                    source="src/repro_torch/kernels/flash_prefill/csrc/"
                           "flash_prefill.cu",
                    replaces="src/repro/kernels/flash_prefill/kernel.py:169",
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                    bound_by=by, library_ms=lib_ms)
            del args, out_k, out_2, out_r, mask


# B5's tiles of 32 packed query rows at L 5, per Gq (5, 25, 40, 60 rows)
VERIFY_ROW_TILES = {1: 1, 5: 1, 6: 1, 8: 2, 12: 2}


def _config_shapes():
    """The head groups the configs phase serves, beside granite's (32 / 8
    / 128, which the cases above hold, jamba's among them): (configs,
    Hq, Hkv, D) from the port's own configs, one entry per distinct shape
    (chameleon's and kimi's are one)."""
    from repro_torch.configs.base import get_config
    from repro_torch.configs.granite_8b import CONFIG as granite
    main = (granite.num_heads, granite.num_kv_heads, granite.head_dim)
    shapes: dict = {}
    for a, _ in CONFIG_RUNS:
        c = get_config(a)
        key = (c.num_heads, c.num_kv_heads, c.head_dim)
        if key != main:
            shapes.setdefault(key, []).append(a)
    return [(" / ".join(a), *k) for k, a in shapes.items()]


def _parity_config_shapes(info: dict) -> None:
    """Every kernel of the configs phase's path against its plain
    version, at each config's head group and head dim, f32 and bf16, under
    the per-kernel bounds above: B1 (16-bit with and without mass and
    ring, 2-bit with both) and B3 on the same grid (also bit-equal to B1
    on the gathered rows); B2 at T 2048 and B4's 512-row segments of it
    (concatenated bit-equal to B2); B5 at L 5 over the dense and the paged
    view, its Gq*L packed query rows in as many VERIFY_ROWS-row tiles as
    the grid says (command-r's 60: two). Times the bf16 B5 at command-r's
    Gq 12 (the speculative run's shape) beside its plain version."""
    import torch
    from repro_torch.kernels.build import sm_count
    from repro_torch.kernels.decode_qattn import ops as dq
    from repro_torch.kernels.decode_qattn.ref import (decode_attn_paged_ref,
                                                      decode_attn_ref)
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.kernels.flash_prefill.ref import (
        flash_prefill_chunk_ref, flash_prefill_ref, flash_verify_ref)
    for arch, Hq, Hkv, D in _config_shapes():
        shape = dict(Hq=Hq, Hkv=Hkv, D=D)
        gq = Hq // Hkv
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt)[6:]
            tol = OUT_TOL[name]
            for bits, mass, ring in ((16, True, True), (16, False, False),
                                     (2, True, True)):
                what = (f"{arch} Gq {gq} D {D} {name} bits={bits} "
                        f"mass={mass} ring={ring}")
                kw = dict(bits=bits, group=128, return_mass=mass,
                          compute_dtype=dt)
                rkw = dict(bits=bits, group=128, compute_dtype=dt)
                args = _decode_case(torch, dt, bits, ring, **shape)
                out_k, m_k = dq.decode_attn_cuda(*args, **kw)
                out_r, m_r = decode_attn_ref(*args, **rkw)
                paged, dense = _paged_case(torch, dt, bits, ring, **shape)
                out_p, m_p = dq.decode_attn_paged_cuda(*paged, **kw)
                out_pr, m_pr = decode_attn_paged_ref(*paged, **rkw)
                out_d, m_d = dq.decode_attn_cuda(*dense, **kw)
                torch.cuda.synchronize()
                e = [check_close("decode_attn " + what, out_k, out_r, *tol),
                     check_close("decode_attn_paged " + what, out_p, out_pr,
                                 *tol)]
                if mass:
                    e += [check_close("decode_attn mass " + what, m_k, m_r,
                                      *MASS_TOL),
                          check_close("decode_attn_paged mass " + what, m_p,
                                      m_pr, *MASS_TOL)]
                if not (torch.equal(out_p, out_d)
                        and (not mass or torch.equal(m_p, m_d))):
                    fail(f"decode_attn_paged {what}: differs from "
                         "decode_attn on the same rows (want bit-equal)")
                errs[f"B1/B3 {name} {bits}-bit"] = max(
                    errs.get(f"B1/B3 {name} {bits}-bit", 0.0), *e)
                del args, paged, dense
            T = 2048
            g = torch.Generator(device="cuda").manual_seed(T + Hq)
            q, k, v = (torch.randn(1, T, h, D, generator=g, device="cuda")
                       .to(dt) for h in (Hq, Hkv, Hkv))
            whole = fp.flash_prefill_cuda(q, k, v)
            e = [check_close(f"flash_prefill {arch} {name}", whole,
                             flash_prefill_ref(q, k, v), *tol)]
            outs = []
            for c0 in range(0, T, CHUNK_LEN):
                c1 = c0 + CHUNK_LEN
                ks, vs = torch.zeros_like(k), torch.zeros_like(v)
                ks[:, :c1], vs[:, :c1] = k[:, :c1], v[:, :c1]
                qs = q[:, c0:c1].contiguous()
                outs.append(fp.flash_prefill_chunk_cuda(qs, ks, vs,
                                                        q_offset=c0))
                e.append(check_close(
                    f"flash_prefill_chunk {arch} {name} offset {c0}",
                    outs[-1], flash_prefill_chunk_ref(qs, ks, vs,
                                                      q_offset=c0), *tol))
            torch.cuda.synchronize()
            if not torch.equal(torch.cat(outs, 1), whole):
                fail(f"flash_prefill_chunk {arch} {name}: segments differ "
                     "from flash_prefill (want bit-equal)")
            errs[f"B2/B4 {name}"] = max(e)
            del q, k, v, ks, vs, outs, whole
            for kind in ("full", "paged"):
                args = _verify_case(torch, dt, kind=kind, **shape)
                out_k = fp.flash_verify_cuda(*args, window=0)
                out_r = flash_verify_ref(*args, window=0)
                torch.cuda.synchronize()
                what = f"flash_verify {arch} Gq {gq} {name} {kind}"
                e = check_close(what, out_k, out_r, *tol)
                errs[f"B5 {name}"] = max(errs.get(f"B5 {name}", 0.0), e)
                B, L = args[0].shape[:2]
                n_rt, n_split, _ = fp.verify_splits(
                    B, Hkv, gq * L, args[1].shape[1], sm_count(args[0].device))
                if n_rt != VERIFY_ROW_TILES[gq]:
                    fail(f"{what}: {n_rt} row tiles for {gq * L} packed "
                         f"rows, want {VERIFY_ROW_TILES[gq]}")
                if dt == torch.bfloat16 and kind == "full":
                    ms = median_ms(lambda: fp.flash_verify_cuda(*args,
                                                                window=0))
                    plain_ms = median_ms(lambda: flash_verify_ref(*args,
                                                                  window=0))
                    dev = device_ms(lambda: fp.flash_verify_cuda(*args,
                                                                 window=0))
                    print(f"[parity] {what} (B {B}, L {L}: {gq * L} packed "
                          f"rows in {n_rt} row tiles, {n_split} splits): "
                          f"{ms:.4f} ms, device {dev:.4f} ms (plain "
                          f"{plain_ms:.4f} ms)")
                del args, out_k, out_r
        print(f"[parity] {arch} (Hq {Hq}, Hkv {Hkv}, Gq {gq}, D {D}): "
              "max|err| " + ", ".join(f"{k} {v:.3g}" for k, v in
                                      errs.items())
              + f" (bounds f32 {OUT_TOL['float32']}, bf16 "
                f"{OUT_TOL['bfloat16']}, mass {MASS_TOL})")
    torch.cuda.empty_cache()


# mixtral's sliding window at the shapes its runs give the kernels: B2 at
# its longest prompt, B5 over a view as long as a 6144-token prompt plus
# its 64 new tokens (the serve run's compressed 640-row view rarely lets
# the window mask a row; here it masks 2100 of some rows' keys)
WINDOW_B2 = (6144, 48, 8, 128, 4096)          # T, Hq, Hkv, D, window
WINDOW_B5_S = 6208
WINDOW_B5_BEFORE = (6200, 5000, 4500, 0, 6100, 4096, 7, 6203)


def _parity_window(info: dict) -> None:
    """B2 and B5 with mixtral's 4096-token window against their plain
    versions, f32 and bf16, under the per-kernel bounds. B2's bf16 call is
    timed beside the same call without a window: the kernel skips the
    key tiles wholly outside the window, so the windowed call must not be
    slower than the causal one by more than timing noise (printed, not
    gated)."""
    import torch
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.kernels.flash_prefill.ref import (flash_prefill_ref,
                                                       flash_verify_ref)
    T, Hq, Hkv, D, win = WINDOW_B2
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt)[6:]
        tol = OUT_TOL[name]
        g = torch.Generator(device="cuda").manual_seed(T + win)
        q, k, v = (torch.randn(1, T, h, D, generator=g, device="cuda")
                   .to(dt) for h in (Hq, Hkv, Hkv))
        out_k = fp.flash_prefill_cuda(q, k, v, window=win)
        out_r = flash_prefill_ref(q, k, v, window=win)
        torch.cuda.synchronize()
        what = (f"flash_prefill {name} T={T} Hq {Hq} Hkv {Hkv} (Gq "
                f"{Hq // Hkv}) window {win}")
        err = check_close(what, out_k, out_r, *tol)
        line = f"[parity] {what}: max|err| {err:.3g}"
        if dt == torch.bfloat16:
            ms = median_ms(lambda: fp.flash_prefill_cuda(q, k, v,
                                                         window=win), reps=10)
            causal = median_ms(lambda: fp.flash_prefill_cuda(q, k, v),
                               reps=10)
            dev = device_ms(lambda: fp.flash_prefill_cuda(q, k, v,
                                                          window=win), n=10)
            line += (f"; {ms:.4f} ms, device {dev:.4f} ms (the same call "
                     f"without a window {causal:.4f} ms)")
        print(line)
        del q, k, v, out_k, out_r
        torch.cuda.empty_cache()
        args = _verify_case(torch, dt, kind="full", Hq=Hq, Hkv=Hkv, D=D,
                            S_full=WINDOW_B5_S, before=WINDOW_B5_BEFORE)
        out_k = fp.flash_verify_cuda(*args, window=win)
        out_r = flash_verify_ref(*args, window=win)
        nowin = flash_verify_ref(*args, window=0)
        torch.cuda.synchronize()
        what = (f"flash_verify {name} Gq {Hq // Hkv} L {GAMMA + 1} Tk "
                f"{WINDOW_B5_S} window {win}")
        err = check_close(what, out_k, out_r, *tol)
        moved = (out_r.float() - nowin.float()).abs().max().item()
        print(f"[parity] {what}: max|err| {err:.3g}; the window moves the "
              f"plain output by up to {moved:.3g}")
        if moved == 0.0:
            fail(f"{what}: the window masked nothing")
        del args, out_k, out_r, nowin
    torch.cuda.empty_cache()


def _parity_quantized_wrapper(info: dict) -> None:
    """B1w (the back-compat wrapper over B1: quantized store, no ring, no
    mass, f32 compute) against its plain version at B1's 2-bit shapes."""
    import torch
    from repro_torch.kernels.decode_qattn import ops as dq
    from repro_torch.kernels.decode_qattn.ref import decode_attn_ref
    args = _decode_case(torch, torch.bfloat16, 2, False)[:8]
    kw = dict(bits=2, group=128)
    n0 = dq.decode_qattn_count.launches
    out_k = dq.decode_attention_quantized(*args, **kw)
    if dq.decode_qattn_count.launches != n0 + 1:
        fail("decode_attention_quantized: its launch was not counted")
    out_r, _ = decode_attn_ref(*args, None, None, None, **kw,
                               compute_dtype=torch.float32)
    torch.cuda.synchronize()
    err = check_close("decode_attention_quantized", out_k, out_r,
                      *OUT_TOL["bfloat16"])
    ms = median_ms(lambda: dq.decode_attention_quantized(*args, **kw))
    plain_ms = median_ms(lambda: decode_attn_ref(
        *args, None, None, None, **kw, compute_dtype=torch.float32))
    q, k = args[0], args[1]
    B, Hq, D = q.shape
    bms, by = bound(nbytes(*args, out_k), 4.0 * B * Hq * k.shape[1] * D,
                    "bfloat16")
    print(f"[parity] decode_attention_quantized bfloat16 bits=2: max|err| "
          f"{err:.3g}; {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
          f"{bms:.4f} ms by {by}, {bms / ms:.1%} of it)")
    info["kernel_rows"]["decode_qattn"] = dict(
        name="decode_attention_quantized", route="cuda",
        source="src/repro_torch/kernels/decode_qattn/csrc/decode_attn.cu",
        replaces="src/repro/kernels/decode_qattn/kernel.py:378",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=None)


# B6 at the serve path's shapes: the ring flush of 8 slots (one 128-row
# group a row) and the prompt compressions of kivi2 at budget 512 and
# 1920 (the prefix runs' budget)
KVQUANT_CASES = ((8, 128), (1, 512), (1, 1920))
KVQUANT_TIE = 1e-5


def _code_ties(torch, x, packed_k, packed_r, scale, zero, bits, group):
    """(codes that differ, of them the ones at a tie): a difference of
    one level is allowed only where the plain version's own quotient
    (x - lo) / scale lies within KVQUANT_TIE of a .5 tie. `scale` / `zero`
    are the plain version's, per channel over `group` rows (K) when
    `group`, else per row (V). Fails on any other difference."""
    from repro_torch.kernels.kvquant.ref import unpack_ref
    D = x.shape[-1]
    a = unpack_ref(packed_k, bits, D)
    b = unpack_ref(packed_r, bits, D)
    if group:
        lo = zero.repeat_interleave(group, dim=1)
        sc = scale.repeat_interleave(group, dim=1)
    else:
        lo, sc = zero[..., None], scale[..., None]
    quot = (x.float() - lo) / sc
    tie = (quot - quot.floor() - 0.5).abs() <= KVQUANT_TIE
    diff = (a - b).abs()
    bad = int(((diff > 1) | ((diff == 1) & ~tie)).sum().item())
    return int((diff > 0).sum().item()), int((tie & (diff == 1)).sum().item()), bad


def _b6_compare(torch, what, x, got, want, bits, group):
    """Fail unless B6's (packed, scale, zero) `got` on `x` matches the
    plain version's `want`: zeros bit-equal, scales within one f32 ulp,
    codes equal but for tie-only differences (per channel over `group`
    rows when `group`, else per row). Returns (codes differing, of them
    at ties, scale max ulp, max|err| of the dequantized values)."""
    from repro_torch.kernels.kvquant.ref import dequant_k_ref, dequant_v_ref
    (pk, sk, zk), (pr, sr, zr) = got, want
    torch.cuda.synchronize()
    if not torch.equal(zk, zr):
        fail(f"{what}: zeros differ from the plain version")
    ulp = int((sk.view(torch.int32) - sr.view(torch.int32)).abs().max()
              .item())
    if ulp > 1:
        fail(f"{what}: scales differ by {ulp} f32 ulp")
    n_diff, n_tie, bad = _code_ties(torch, x, pk, pr, sr, zr, bits, group)
    if bad:
        fail(f"{what}: {bad} codes differ beyond a tie")
    if group:
        deq = [dequant_k_ref(p_, s_, z_, bits, group, torch.float32)
               for p_, s_, z_ in (got, want)]
    else:
        deq = [dequant_v_ref(p_, s_, z_, bits, torch.float32)
               for p_, s_, z_ in (got, want)]
    return n_diff, n_tie, ulp, (deq[0] - deq[1]).abs().max().item()


def _parity_kvquant(info: dict) -> None:
    """B6 (kquant / vquant, and the fused kvquant launch that quantizes a
    flush's K and V together) against its plain version on the card, bf16
    and f32, bits 2 / 4 / 8, at KVQUANT_CASES: zeros bit-equal, scales
    within one f32 ulp (the reading printed: both divide exactly, the
    plain version by a 0-d device tensor), codes equal but for tie-only
    differences (counted and printed); the fused launch also bit-equal to
    the two standalone ones on the same K and V; each call adds one to
    its own launch count. The bf16 2-bit flush case is timed into the
    kernels line (what every kivi2 flush runs): bytes read + codes and
    scale / zero written, at the HBM rate (the fused row: both); beside
    the fused call, the two standalone calls it replaces. No single
    PyTorch call quantizes and packs, so no library time."""
    import torch
    from repro_torch.kernels.kvquant import ops as kvq
    from repro_torch.kernels.kvquant.ref import kquant_ref, vquant_ref
    rows = info["kernel_rows"]
    G = 128
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt)[6:]
        for B, S in KVQUANT_CASES:
            g = torch.Generator(device="cuda").manual_seed(B * S)
            x = (torch.randn(B, S, 8, 128, generator=g, device="cuda")
                 * 2).to(dt)
            y = (torch.randn(B, S, 8, 128, generator=g, device="cuda")
                 * 2).to(dt)
            for bits in (2, 4, 8):
                row = dt == torch.bfloat16 and (B, S) == (8, 128) \
                    and bits == 2
                timed = dt == torch.bfloat16 and bits == 2
                for kind, fn, kern, plain in (
                        ("kquant", kvq.kquant_cuda, kvq.kquant_kernel,
                         lambda: kquant_ref(x, bits, G)),
                        ("vquant", kvq.vquant_cuda, kvq.vquant_kernel,
                         lambda: vquant_ref(x, bits))):
                    n0 = kern.launches
                    got = fn(x, bits=bits, group=G)
                    if kern.launches != n0 + 1:
                        fail(f"{kind}: its launch was not counted")
                    what = (f"{kind} {name} [{B}, {S}, 8, 128] G {G} "
                            f"bits={bits}")
                    n_diff, n_tie, ulp, err = _b6_compare(
                        torch, what, x, got, plain(), bits,
                        G if kind == "kquant" else 0)
                    ms = median_ms(lambda: fn(x, bits=bits, group=G))
                    plain_ms = median_ms(plain)
                    bms, by = bound(nbytes(x, *got), 0.0, name)
                    dev = (device_ms(lambda: fn(x, bits=bits, group=G))
                           if timed else None)
                    print(f"[parity] {what}: codes differing {n_diff} (at "
                          f"ties {n_tie}), max|err| dequantized {err:.3g}, "
                          f"scale max ulp {ulp}, zeros bit-equal; "
                          f"{ms:.4f} ms"
                          f"{'' if dev is None else ', device %.4f ms' % dev}"
                          f" (plain {plain_ms:.4f} "
                          f"ms, library null, bound {bms:.4f} ms by {by}, "
                          f"{bms / ms:.1%} of it)")
                    if row:
                        rows[kind] = dict(
                            name=f"{kind}_cuda", route="cuda",
                            source="src/repro_torch/kernels/kvquant/csrc/"
                                   "kvquant.cu",
                            replaces="src/repro/kernels/kvquant/kernel.py:"
                                     + ("67" if kind == "kquant" else "96"),
                            max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                            library_ms=None)
                # one flush's K (x) and V (y) in one launch
                what = f"kvquant {name} [{B}, {S}, 8, 128] G {G} bits={bits}"
                kw = dict(bits=bits, group=G)
                n0 = kvq.kvquant_kernel.launches
                kf, vf = kvq.kvquant_cuda(x, y, **kw)
                if kvq.kvquant_kernel.launches != n0 + 1:
                    fail("kvquant: its launch was not counted")
                apart = kvq.kquant_cuda(x, **kw) + kvq.vquant_cuda(y, **kw)
                torch.cuda.synchronize()
                if not all(map(torch.equal, kf + vf, apart)):
                    fail(f"{what}: differs from the two standalone launches")
                rk = _b6_compare(torch, what + " K", x, kf,
                                 kquant_ref(x, bits, G), bits, G)
                rv = _b6_compare(torch, what + " V", y, vf,
                                 vquant_ref(y, bits), bits, 0)
                err = max(rk[3], rv[3])

                def fused():
                    return kvq.kvquant_cuda(x, y, **kw)

                def two_calls():
                    return kvq.kquant_cuda(x, **kw), kvq.vquant_cuda(y, **kw)

                def plain_pair():
                    return kquant_ref(x, bits, G), vquant_ref(y, bits)

                ms, apart_ms = median_ms(fused), median_ms(two_calls)
                plain_ms = median_ms(plain_pair)
                bms, by = bound(nbytes(x, y, *kf, *vf), 0.0, name)
                dev = ((device_ms(fused), device_ms(two_calls)) if timed
                       else None)
                print(f"[parity] {what}: K / V codes differing {rk[0]} / "
                      f"{rv[0]} (at ties {rk[1]} / {rv[1]}), max|err| "
                      f"dequantized {err:.3g}, scale max ulp "
                      f"{max(rk[2], rv[2])}, zeros bit-equal, bit-equal to "
                      f"kquant + vquant; {ms:.4f} ms"
                      + ("" if dev is None else
                         ", device %.4f ms" % dev[0])
                      + f" (kquant + vquant apart {apart_ms:.4f} ms"
                      + ("" if dev is None else
                         ", device %.4f ms" % dev[1])
                      + f"; plain {plain_ms:.4f} ms, library null, bound "
                      f"{bms:.4f} ms by {by}, {bms / ms:.1%} of it)")
                if row:
                    rows["kvquant"] = dict(
                        name="kvquant_cuda", route="cuda",
                        source="src/repro_torch/kernels/kvquant/csrc/"
                               "kvquant.cu",
                        replaces="src/repro/kernels/kvquant/kernel.py:67",
                        also_replaces="src/repro/kernels/kvquant/"
                                      "kernel.py:96",
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bms, bound_by=by, library_ms=None)
            del x, y


def _paged_case(torch, dt, bits, ring, B=8, S=512, W=128, Hq=32, Hkv=8,
                D=128, seed=0):
    """The main path's paged shapes: 128-row blocks (the quantization
    group) for a 2-bit pool, 16-row blocks (granite-8b `full` snaps its
    2112-row store to 16) for a dense one. A shuffled table over a pool
    with spare blocks, -1 past each row's length, one all -1 (free)
    slot. Returns (paged args, the dense-store args holding the same
    rows: each slot's blocks gathered, -1 read as block 0)."""
    from repro_torch.kernels.decode_qattn.ref import gather_pool
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev, f32 = "cuda", torch.float32
    bl = 128 if bits < 16 else 16
    n_max = S // bl
    nb = B * n_max + 5

    def rnd(*shape, dtype=f32):
        return torch.randn(*shape, generator=g, device=dev, dtype=f32).to(dtype)

    length = torch.tensor([512, 300, 17, 0, 511, 128, 64, 1], device=dev)
    ids = torch.randperm(nb, generator=g, device=dev)[:B * n_max]
    used = (torch.arange(n_max, device=dev)[None] * bl) < length[:, None]
    tbl = torch.where(used, ids.view(B, n_max), -1).to(torch.int32)
    bias_main = torch.where(torch.arange(S, device=dev)[None] < length[:, None],
                            0.0, -1e30).to(f32)
    if bits < 16:
        Dp = D * bits // 8
        pk = torch.randint(-128, 128, (nb, bl, Hkv, Dp), generator=g,
                           device=dev, dtype=torch.int8)
        pv = torch.randint(-128, 128, (nb, bl, Hkv, Dp), generator=g,
                           device=dev, dtype=torch.int8)
        ks = rnd(nb, bl // W, Hkv, D).abs() * 0.1 + 0.01
        kz = rnd(nb, bl // W, Hkv, D)
        vs = rnd(nb, bl, Hkv).abs() * 0.1 + 0.01
        vz = rnd(nb, bl, Hkv)
    else:
        pk, pv = rnd(nb, bl, Hkv, D, dtype=dt), rnd(nb, bl, Hkv, D, dtype=dt)
        ks = kz = vs = vz = None
    if ring:
        rlen = torch.tensor([128, 5, 1, 0, 64, 128, 1, 127], device=dev)
        rk, rv = rnd(B, W, Hkv, D, dtype=dt), rnd(B, W, Hkv, D, dtype=dt)
        bias_ring = torch.where(torch.arange(W, device=dev)[None]
                                < rlen[:, None], 0.0, -1e30).to(f32)
    else:
        rk = rv = bias_ring = None
    q = rnd(B, Hq, D, dtype=dt)

    def gd(pool):
        return None if pool is None else gather_pool(pool, tbl).contiguous()

    return ((q, tbl, pk, ks, kz, pv, vs, vz, bias_main, rk, rv, bias_ring),
            (q, gd(pk), gd(ks), gd(kz), gd(pv), gd(vs), gd(vz), bias_main,
             rk, rv, bias_ring))


def _parity_paged_decode(info: dict) -> None:
    """B3 against its plain version, and against B1 on the same rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_qattn import ops as dq
    from repro_torch.kernels.decode_qattn.ref import decode_attn_paged_ref
    for dt in (torch.float32, torch.bfloat16):
        for bits in (2, 16):
            for mass in (True, False):
                for ring in ((True,) if bits < 16 else (True, False)):
                    paged, dense = _paged_case(torch, dt, bits, ring)
                    kw = dict(bits=bits, group=128, return_mass=mass,
                              compute_dtype=dt)
                    out_k, m_k = dq.decode_attn_paged_cuda(*paged, **kw)
                    out_d, m_d = dq.decode_attn_cuda(*dense, **kw)
                    out_r, m_r = decode_attn_paged_ref(
                        *paged, bits=bits, group=128, compute_dtype=dt)
                    torch.cuda.synchronize()
                    what = (f"decode_attn_paged {str(dt)[6:]} bits={bits} "
                            f"mass={mass} ring={ring}")
                    err = check_close(what + " out", out_k, out_r,
                                      *OUT_TOL[str(dt)[6:]])
                    merr = (check_close(what + " mass", m_k, m_r, *MASS_TOL)
                            if mass else 0.0)
                    # one kernel body, two row addressings: bit-equal
                    d_b1 = (out_k.float() - out_d.float()).abs().max().item()
                    if mass:
                        d_b1 = max(d_b1, (m_k - m_d).abs().max().item())
                    if d_b1 != 0.0:
                        fail(f"{what}: differs from decode_attn on the same "
                             f"rows by {d_b1:.3g} (want bit-equal)")
                    ms = median_ms(lambda: dq.decode_attn_paged_cuda(
                        *paged, **kw))
                    plain_ms = median_ms(lambda: decode_attn_paged_ref(
                        *paged, bits=bits, group=128, compute_dtype=dt))
                    q, tbl, pk = paged[:3]
                    _, kd, _, _, vd, _, _, bm, rk, rv, br = dense
                    lib_ms = None
                    if bits == 16 and not mass:
                        # SDPA over the gathered dense view (gather excluded)
                        kk = torch.cat([kd, rk], 1) if ring else kd
                        vv = torch.cat([vd, rv], 1) if ring else vd
                        bb = torch.cat([bm, br], 1) if ring else bm
                        qh = q[:, :, None]
                        kh, vh = kk.transpose(1, 2), vv.transpose(1, 2)
                        mask = bb[:, None, None].to(dt)
                        lib_ms = median_ms(
                            lambda: F.scaled_dot_product_attention(
                                qh, kh, vh, attn_mask=mask, enable_gqa=True))
                    B, Hq, D = q.shape
                    Stot = bm.shape[1] + (rk.shape[1] if ring else 0)
                    # each input read once: the rows the table walks (the
                    # gathered view, as B1 reads its dense store), the
                    # table, bias, ring, query; out and mass written once
                    moved = (nbytes(*dense, tbl, out_k)
                             + (nbytes(m_k) if mass else 0))
                    flops = 4.0 * B * Hq * Stot * D
                    bms, by = bound(moved, flops, str(dt).split(".")[1])
                    print(f"[parity] decode_attn_paged {str(dt)[6:]} "
                          f"bits={bits} block={pk.shape[1]} mass={mass} "
                          f"ring={ring}: max|err| out {err:.3g} mass "
                          f"{merr:.3g}, vs decode_attn {d_b1:.3g}; "
                          f"{ms:.4f} ms (plain {plain_ms:.4f} ms, sdpa "
                          f"{'null' if lib_ms is None else '%.4f ms' % lib_ms}"
                          f", bound {bms:.4f} ms by {by}, "
                          f"{bms / ms:.1%} of it)")


def _parity_paged_full_path(info: dict) -> None:
    """B3 at the case the `full paged` serve path runs (the largest share
    of its device time): bf16, a 16-bit pool of 16-row blocks, S = 2112,
    no ring, no mass, a shuffled table with ragged rows and one free
    slot; bit-equal to B1 on the gathered rows. Its one-call library
    equivalent: SDPA over the gathered view with the bias as a float mask
    (gather and mask construction excluded)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_qattn import ops as dq
    from repro_torch.kernels.decode_qattn.ref import decode_attn_paged_ref
    bf = torch.bfloat16
    paged, dense = _paged_case(torch, bf, 16, False, S=FULL_S)
    kw = dict(bits=16, group=128, return_mass=False, compute_dtype=bf)
    out_k, _ = dq.decode_attn_paged_cuda(*paged, **kw)
    out_d, _ = dq.decode_attn_cuda(*dense, **kw)
    out_r, _ = decode_attn_paged_ref(*paged, bits=16, group=128,
                                     compute_dtype=bf)
    torch.cuda.synchronize()
    what = f"decode_attn_paged bfloat16 bits=16 block=16 S={FULL_S}"
    err = check_close(what + " out", out_k, out_r, *OUT_TOL["bfloat16"])
    d_b1 = (out_k.float() - out_d.float()).abs().max().item()
    if d_b1 != 0.0:
        fail(f"{what}: differs from decode_attn on the same rows by "
             f"{d_b1:.3g} (want bit-equal)")
    ms = median_ms(lambda: dq.decode_attn_paged_cuda(*paged, **kw))
    plain_ms = median_ms(lambda: decode_attn_paged_ref(
        *paged, bits=16, group=128, compute_dtype=bf))
    q, tbl = paged[:2]
    _, kd, _, _, vd, _, _, bm = dense[:8]
    qh, kh, vh = q[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2)
    mask = bm[:, None, None].to(bf)
    lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, enable_gqa=True))
    B, Hq, D = q.shape
    # each input read once: the rows the table walks (the gathered view),
    # the table, bias, query; out written once
    bms, by = bound(nbytes(q, kd, vd, bm, tbl, out_k),
                    4.0 * B * Hq * FULL_S * D, "bfloat16")
    dev = device_ms(lambda: dq.decode_attn_paged_cuda(*paged, **kw))
    print(f"[parity] {what} ring=False mass=False (the full paged path): "
          f"max|err| out {err:.3g}, vs decode_attn {d_b1:.3g}; {ms:.4f} ms, "
          f"device {dev:.4f} ms (plain {plain_ms:.4f} ms, sdpa "
          f"{lib_ms:.4f} ms, bound "
          f"{bms:.4f} ms by {by}, {bms / ms:.1%} of it)")
    info["kernel_rows"]["decode_attn_paged"] = dict(
        name="decode_attn_paged_cuda", route="cuda",
        source="src/repro_torch/kernels/decode_qattn/csrc/decode_attn.cu",
        replaces="src/repro/kernels/decode_qattn/kernel.py:258",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=lib_ms)


CHUNK_LEN = 512


def _parity_chunk_prefill(info: dict) -> None:
    """B4's segments against their plain version (scratch rows past the
    segment zero, as in a chunked admission) and, concatenated, against
    B2 on the whole prompt; the last segment of the 2048-token bf16
    prompt is timed."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_chunk_ref
    rows = info["kernel_rows"]
    for dt in (torch.float32, torch.bfloat16):
        for T in (2048, 2000):                 # 2000: a ragged 464-row tail
            g = torch.Generator(device="cuda").manual_seed(T + 7)
            q, k, v = (torch.randn(1, T, h, 128, generator=g, device="cuda")
                       .to(dt) for h in (32, 8, 8))
            outs, errs = [], []
            for c0 in range(0, T, CHUNK_LEN):
                c1 = min(c0 + CHUNK_LEN, T)
                ks, vs = torch.zeros_like(k), torch.zeros_like(v)
                ks[:, :c1], vs[:, :c1] = k[:, :c1], v[:, :c1]
                qs = q[:, c0:c1].contiguous()
                out_k = fp.flash_prefill_chunk_cuda(qs, ks, vs, q_offset=c0)
                out_r = flash_prefill_chunk_ref(qs, ks, vs, q_offset=c0)
                torch.cuda.synchronize()
                errs.append(check_close(
                    f"flash_prefill_chunk {dt} T={T} offset {c0}", out_k,
                    out_r, *OUT_TOL[str(dt)[6:]]))
                outs.append(out_k)
            whole = fp.flash_prefill_cuda(q, k, v)
            torch.cuda.synchronize()
            d_b2 = (torch.cat(outs, 1).float() - whole.float()).abs().max()
            d_b2 = d_b2.item()
            if d_b2 != 0.0:
                fail(f"flash_prefill_chunk {dt} T={T}: segments differ from "
                     f"flash_prefill by {d_b2:.3g} (want bit-equal)")
            # time the heaviest segment: the last, over the whole scratch
            ms = median_ms(lambda: fp.flash_prefill_chunk_cuda(
                qs, ks, vs, q_offset=c0), reps=10)
            plain_ms = median_ms(lambda: flash_prefill_chunk_ref(
                qs, ks, vs, q_offset=c0), reps=5)
            qpos = c0 + torch.arange(c1 - c0, device="cuda")
            mask = (torch.arange(T, device="cuda")[None] <= qpos[:, None])
            qh, kh, vh = (x.transpose(1, 2) for x in (qs, ks, vs))
            lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, enable_gqa=True), reps=10)
            moved = nbytes(qs, k[:, :c1], v[:, :c1], outs[-1])
            flops = 4.0 * 32 * 128 * float((qpos + 1).sum().item())
            bms, by = bound(moved, flops, str(dt).split(".")[1])
            dev = device_ms(lambda: fp.flash_prefill_chunk_cuda(
                qs, ks, vs, q_offset=c0), n=10)
            print(f"[parity] flash_prefill_chunk {str(dt)[6:]} T={T} "
                  f"chunk {CHUNK_LEN}: max|err| {max(errs):.3g} over "
                  f"{len(outs)} segments, vs flash_prefill {d_b2:.3g}; "
                  f"last segment ({c1 - c0} rows at {c0}) {ms:.4f} ms, "
                  f"device {dev:.4f} ms "
                  f"(plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
                  f"{bms:.4f} ms by {by}, {bms / ms:.1%} of it)")
            if dt == torch.bfloat16 and T == 2048:
                rows["flash_prefill_chunk"] = dict(
                    name="flash_prefill_chunk_cuda", route="cuda",
                    source="src/repro_torch/kernels/flash_prefill/csrc/"
                           "flash_prefill.cu",
                    replaces="src/repro/kernels/flash_prefill/kernel.py:212",
                    max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                    bound_ms=bms, bound_by=by, library_ms=lib_ms)
            del q, k, v, ks, vs, outs, whole


# ---------------------------------------------------------------------------
# 4. serve: granite-8b, full width and depth, four policies
# ---------------------------------------------------------------------------

SERVE_POLICIES = ("full", "h2o", "kivi2", "h2o+kivi2")
BUCKETS = (1024, 2048)
N_REQUESTS, MAX_NEW, SLOTS, BUDGET, WINDOW = 16, 64, 8, 512, 128
# plain runs no speculative run is set beside serve N_SHORT requests
# (one wave of the 8 slots), to keep the script's time down
N_SHORT = 8
# paged + chunked runs: (policy, pool blocks; None = parity with the dense
# layout). `full` keeps 2112 rows a slot in 16-row blocks: parity is
# 8 x 132 = 1056 blocks, so at 640 admissions wait on retirements.
PAGED_RUNS = (("full", 640), ("kivi2", None), ("h2o+kivi2", None))
# speculative runs (gamma GAMMA): (policy, drafter, paged + chunked?).
# They serve SPEC_LAYERS of the 36 layers, each beside a plain twin of
# the same depth and requests (their launches follow from each run's own
# counts at any depth; the host-bound verify rounds made them the
# script's longest runs: 18 layers since PR 21, 9 since the
# encoder-decoder and training phases joined)
SPEC_RUNS = (("full", "same", False), ("kivi2", "window:64", False),
             ("full", "same", True))
SPEC_LAYERS = 9
# overload runs (paged + chunked, the first N_SHORT prompts), each held
# token for token to the unpreempted paged + chunked run of its policy
# above: (policy, engine options, forced preemptions or None). `full`
# with lazy growth and preemption on a pool sized for typical load:
# lazy admission under preemption covers prompt + 1 rows, 65 / 129
# 16-row blocks for a 1024 / 2048-token prompt (776 for the 8), growth
# to 1088 / 2112 rows needs 68 / 132 (800), so the 784-block pool
# starves mid-decode; kivi2 at parity with three forced preemptions at
# (dispatch, slot) pairs whose slots are active then (re-admissions run
# B4 and B6 again; replay crosses ring flushes). Then the rest of the
# ladder: the same starving `full` run with the host-RAM tier (each
# preemption spills the slot to pinned host memory and its re-admission
# restores it: no B4 segment, no replay), and kivi2 with lazy growth,
# preemption and degradation at the parity pool (8 x 4 blocks of 128
# rows: budget 512 keeps 4 groups a slot, and lazy admission of a 1024-
# or 2048-token prompt takes all 4, so the pool fills to 1.0 >= the 0.85
# high-water mark as the eighth request is admitted; the controller
# drops 2 groups of a slot down to 0.60, and a degraded slot's first
# flush regrows a group through lazy growth). Each audits the pool,
# device block table and host census included, every OVERLOAD_AUDIT
# dispatches. The tier run goes twice, untraced and with the `Tracer` and
# `Metrics` on (the wall time of each printed: tracing's cost). Per run:
# (policy, engine options, preemptions: an int is exact, None at least
# one, "any" not gated; streams gated against the unpreempted run?;
# traced?)
OVERLOAD_RUNS = (("full", dict(pool_blocks=784, block_growth="lazy",
                               preemption=True), None, True, False),
                 ("kivi2", dict(preempt_at=((8, 0), (20, 3), (40, 5))), 3,
                  True, False),
                 ("full", dict(pool_blocks=784, block_growth="lazy",
                               preemption=True, tiering=True), None, True,
                  False),
                 ("full", dict(pool_blocks=784, block_growth="lazy",
                               preemption=True, tiering=True), None, True,
                  True),
                 ("kivi2", dict(block_growth="lazy", preemption=True,
                                degrade=True), "any", False, False))
OVERLOAD_AUDIT = 16
# the selective-token presets that draw Gumbel noise (dense, N_SHORT
# requests, B1 with mass as h2o; printed beside h2o)
NOISE_POLICIES = ("nacl", "keyformer")
# temperature / top-k sampler runs (dense `full`, N_SHORT requests, seed
# 0): top_k 1 must give the greedy streams bit for bit
SAMPLER_TEMP, SAMPLER_TOP_K = 0.8, (1, 50)
# telemetry: the traced runs report the host seconds of these spans
# (and the count of `audit` instants); a span ends when the host has
# enqueued its work, so these are host times
SPAN_NAMES = ("step", "prefill_chunk", "restore", "prefill")
KERNELS = ("decode_attn", "flash_prefill", "decode_attn_paged",
           "flash_prefill_chunk", "flash_verify", "decode_qattn", "kquant",
           "vquant", "kvquant")


def _kernel_objs():
    from repro_torch.kernels.decode_qattn import ops as dq
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.kernels.kvquant import ops as kvq
    return dict(decode_attn=dq.decode_attn_kernel,
                flash_prefill=fp.flash_prefill_kernel,
                decode_attn_paged=dq.decode_attn_paged_kernel,
                flash_prefill_chunk=fp.flash_prefill_chunk_kernel,
                flash_verify=fp.flash_verify_kernel,
                decode_qattn=dq.decode_qattn_count,
                kquant=kvq.kquant_kernel, vquant=kvq.vquant_kernel,
                kvquant=kvq.kvquant_kernel)


def _want_launches(eng, res, n_layers: int, n_req: int, segments: int):
    """The launches a serve run must show, per kernel, from its own step
    counts: one per layer for every decode step (B1 dense / B3 paged),
    monolithic admission (B2, also into a paged pool) or prompt segment
    (B4) of a policy that reads no mass,
    and, speculative, verify round (B5) and drafter decode step and
    drafter admission (B1 / B2: the drafter's cache is dense); for a
    quantized (KIVI) cache, B6 once per layer (K and V in one fused
    kvquant launch; no standalone kquant / vquant launch) for every
    append step whose ring flushed (decided on the host: the run's
    `kv_flush_steps`) and every quantized admission (target, and drafter
    when its view is quantized)."""
    want = dict.fromkeys(KERNELS, 0)
    dec = "decode_attn_paged" if eng.paged else "decode_attn"
    pre = "flash_prefill_chunk" if eng.chunked_prefill else "flash_prefill"
    st = res.spec
    want[dec] = (st.plain_rounds if st else res.decode_steps) * n_layers
    if not eng.spec.track_scores():
        want[pre] = (segments if eng.chunked_prefill else n_req) * n_layers
    if st:
        want["flash_verify"] += st.verify_rounds * n_layers
        want["decode_attn"] += st.draft_calls * n_layers
        if not eng.draft.spec.track_scores():
            want["flash_prefill"] += n_req * n_layers
    n_quant = n_req * (int(eng.spec.quantized)
                       + int(bool(st) and eng.draft.spec.quantized))
    want["kvquant"] = (res.kv_flush_steps + n_quant) * n_layers
    return want


def _agreement(res_a, res_b):
    """(requests with equal streams, tokens equal position by position,
    tokens) of two runs over the same requests."""
    same = tok = n = 0
    for a, b in zip(res_a.results, res_b.results):
        same += int(a.tokens.tolist() == b.tokens.tolist())
        m = min(len(a.tokens), len(b.tokens))
        tok += int((a.tokens[:m] == b.tokens[:m]).sum())
        n += max(len(a.tokens), len(b.tokens))
    return same, tok, n


def _counted(fn, kernels, launches):
    """fn() with every kernel counter set to 0 just before and read just
    after (summed into `launches`); returns (out, counts, seconds)."""
    import torch
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
    t1 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    n = {name: k.launches for name, k in kernels.items()}
    for name in KERNELS:
        launches[name] += n[name]
    return out, n, time.perf_counter() - t1


def phase_serve(info: dict) -> None:
    import numpy as np
    import torch
    from repro_torch.configs.granite_8b import CONFIG
    from repro_torch.core.policy import presets
    from repro_torch.nn import model as M
    from repro_torch.obs import Metrics, Tracer
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request
    cfg = CONFIG
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(params))
    print(f"[serve] {cfg.name}: {cfg.num_layers} layers d_model "
          f"{cfg.d_model} heads {cfg.num_heads}/{cfg.num_kv_heads} d_ff "
          f"{cfg.d_ff} vocab {cfg.vocab_size} {str(cfg.dtype)[6:]}; "
          f"{n_par / 1e9:.2f} B random parameters in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=BUCKETS[i % 2])
               for i in range(N_REQUESTS)]
    kernels = _kernel_objs()
    launches = info.setdefault("launches", dict.fromkeys(KERNELS, 0))
    chunked = dict(paged=True, chunked_prefill=True, chunk_len=CHUNK_LEN)
    # (policy, options, drafter, layers: None = all); a speculative run
    # follows its plain twin
    runs = ([(p, {}, None, None) for p in SERVE_POLICIES + NOISE_POLICIES]
            + [(p, dict(chunked, pool_blocks=nb), None, None)
               for p, nb in PAGED_RUNS]
            + [(p, dict(chunked, pool_blocks=640) if pg else {}, dr,
                SPEC_LAYERS) for p, d, pg in SPEC_RUNS for dr in (None, d)])
    baselines = {(p, pg) for p, _, pg in SPEC_RUNS}
    params_cut = _layers_view(params, SPEC_LAYERS)
    plain = {}
    for pname, opts, draft, depth in runs:
        c, prm = ((cfg, params) if depth is None
                  else (cfg.replace(num_layers=depth), params_cut))
        L = c.num_layers
        n_req = (N_REQUESTS if depth or (pname, bool(opts)) in baselines
                 else N_SHORT)
        segments = sum(-(-len(p) // CHUNK_LEN) for p in prompts[:n_req])
        pol = presets(budget=BUDGET, window=WINDOW)[pname]
        spec_kw = (dict(speculative=True, gamma=GAMMA, draft_policy=draft)
                   if draft else {})
        # telemetry on in the `full` paged + chunked run
        traced = pname == "full" and bool(opts) and depth is None
        tr, mx = (Tracer(), Metrics()) if traced else (None, None)
        eng = Engine(c, prm, pol, prompt_len=max(BUCKETS),
                     max_new=MAX_NEW, slots=SLOTS, buckets=BUCKETS, **opts,
                     **spec_kw, tracer=tr, metrics=mx)
        reqs = [Request(tokens=p, max_new=MAX_NEW) for p in prompts[:n_req]]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels.values():
            k.launches = 0
        t1 = time.perf_counter()
        res = eng.generate_continuous(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        n = {name: k.launches for name, k in kernels.items()}
        for name in KERNELS:
            launches[name] += n[name]
        done = [r for r in res.results if r.finish_reason == "length"
                and r.n_tokens == MAX_NEW]
        toks = np.concatenate([r.tokens for r in res.results])
        label = (pname + (" paged+chunked" if opts else "")
                 + (f" spec[{draft}]" if draft else "")
                 + (" +trace" if traced else "")
                 + (f" ({depth} layers)" if depth else ""))
        pool = ""
        if opts:
            pool = (f", pool peak {res.pool_peak_blocks}/{res.pool_blocks} "
                    f"blocks of {eng.block_len} rows"
                    f"{' (prefill-direct)' if eng._verbatim_ok(BUCKETS[1]) else ''}"
                    f", audit clean={eng.last_audit['clean']}")
        print(f"[serve] {label}: {len(done)}/{n_req} requests "
              f"completed, prefill {res.prefill_seconds:.3f} s, decode "
              f"{res.decode_tokens_per_s:.1f} tok/s over "
              f"{res.decode_steps} steps, ttft mean {res.ttft_mean_s:.3f} "
              f"s, wall {wall:.2f} s, peak allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, cache "
              f"{res.cache_physical_bytes / 2**20:.1f} MiB physical{pool}; "
              f"launches " + " ".join(f"{k} {v}" for k, v in n.items()))
        key = (pname, bool(opts)) + ((depth,) if depth else ())
        if draft is None:
            plain[key] = res
        else:
            st, base = res.spec, plain[key]
            same, tok, ntok = _agreement(res, base)
            print(f"[serve]   {st.describe()}; {st.verify_rounds} verify + "
                  f"{st.plain_rounds} plain rounds, {st.draft_calls} drafter "
                  f"steps; tok/s {res.decode_tokens_per_s:.1f} vs plain "
                  f"{base.decode_tokens_per_s:.1f}, ttft mean "
                  f"{res.ttft_mean_s:.3f} s vs {base.ttft_mean_s:.3f} s; bf16 "
                  f"streams equal to plain: {same}/{N_REQUESTS} requests, "
                  f"{tok}/{ntok} tokens (reported, not gated)")
            info.setdefault("spec_serve", []).append(
                dict(label=label, acceptance=st.acceptance_rate,
                     committed_per_verify=st.committed_per_verify_step,
                     tok_s=res.decode_tokens_per_s,
                     plain_tok_s=base.decode_tokens_per_s))
            if st.verify_rounds == 0:
                fail(f"{label}: no verify round ran")
        if len(done) != n_req:
            fail(f"{label}: only {len(done)} of {n_req} requests completed")
        if toks.min() < 0 or toks.max() >= cfg.vocab_size:
            fail(f"{label}: token ids out of range")
        want = _want_launches(eng, res, L, n_req, segments)
        if n != want:
            fail(f"{label}: kernel launches {n}, want {want} "
                 f"({res.decode_steps} decode steps, {L} layers"
                 f"{'; ' + res.spec.describe() if res.spec else ''})")
        if opts and not (eng.last_audit["clean"]
                         and res.pool_peak_blocks <= res.pool_blocks):
            fail(f"{label}: pool audit {eng.last_audit}, peak "
                 f"{res.pool_peak_blocks} of {res.pool_blocks} blocks")
        if traced:
            _check_telemetry(info, label, tr, mx, res, wall, causal=False)
        del eng, res
        torch.cuda.empty_cache()
    h2o = plain[("h2o", False)]
    for pname in NOISE_POLICIES:
        r = plain[(pname, False)]
        print(f"[serve] {pname} vs h2o (dense, {N_SHORT} requests, "
              f"{cfg.num_layers} B1 launches with mass per decode step in "
              f"both): decode "
              f"{r.decode_tokens_per_s:.1f} vs {h2o.decode_tokens_per_s:.1f}"
              f" tok/s, ttft mean {r.ttft_mean_s:.3f} vs "
              f"{h2o.ttft_mean_s:.3f} s, prefill {r.prefill_seconds:.3f} vs "
              f"{h2o.prefill_seconds:.3f} s; {info['smi']}")
        info.setdefault("noise_serve", []).append(dict(
            policy=pname, tok_s=r.decode_tokens_per_s,
            h2o_tok_s=h2o.decode_tokens_per_s, ttft=r.ttft_mean_s,
            h2o_ttft=h2o.ttft_mean_s))
    _serve_sampler(info, params, kernels, prompts, plain)
    _serve_overload(info, params, kernels, prompts, plain)
    del plain
    _serve_prefix(info, params, kernels)
    del params
    torch.cuda.empty_cache()


def _serve_sampler(info: dict, params, kernels, prompts, plain) -> None:
    """The temperature / top-k sampler at full width and depth (dense
    `full`, the first N_SHORT prompts, seed 0): every request completes,
    launches are exact (the sampler launches none of the counted
    kernels), top_k 1 gives the greedy run's streams bit for bit (the
    Gumbel draw cannot move a pick that the mask leaves alone), and
    top_k 50's tok/s is printed beside top_k 1's."""
    import torch
    from repro_torch.configs.granite_8b import CONFIG as cfg
    from repro_torch.core.policy import presets
    from repro_torch.serving import sampler as sampler_lib
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request
    launches = info["launches"]
    greedy = plain[("full", False)]
    rows = {}
    for top_k in SAMPLER_TOP_K:
        eng = Engine(cfg, params, presets(budget=BUDGET, window=WINDOW)[
                         "full"], prompt_len=max(BUCKETS), max_new=MAX_NEW,
                     slots=SLOTS, buckets=BUCKETS, seed=0,
                     sampler=sampler_lib.temperature(SAMPLER_TEMP, top_k))
        reqs = [Request(tokens=p, max_new=MAX_NEW)
                for p in prompts[:N_SHORT]]
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        t1 = time.perf_counter()
        res = eng.generate_continuous(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        n = {name: k.launches for name, k in kernels.items()}
        for name in KERNELS:
            launches[name] += n[name]
        label = f"full temperature({SAMPLER_TEMP}, top_k={top_k})"
        done = [r for r in res.results if r.finish_reason == "length"
                and r.n_tokens == MAX_NEW]
        same = sum(a.tokens.tolist() == b.tokens.tolist()
                   for a, b in zip(res.results, greedy.results[:N_SHORT]))
        rows[top_k] = res
        print(f"[serve] {label}: {len(done)}/{N_SHORT} requests completed, "
              f"decode {res.decode_tokens_per_s:.1f} tok/s over "
              f"{res.decode_steps} steps (greedy, {N_REQUESTS} requests: "
              f"{greedy.decode_tokens_per_s:.1f}), ttft mean "
              f"{res.ttft_mean_s:.3f} s, wall {wall:.2f} s; streams equal "
              f"to greedy's: {same}/{N_SHORT}"
              f"{'' if top_k == 1 else ' (reported, not gated)'}; launches "
              + " ".join(f"{k} {v}" for k, v in n.items()))
        if len(done) != N_SHORT:
            fail(f"{label}: only {len(done)} of {N_SHORT} requests "
                 "completed")
        want = _want_launches(eng, res, cfg.num_layers, N_SHORT, 0)
        if n != want:
            fail(f"{label}: kernel launches {n}, want {want}")
        if top_k == 1 and same != N_SHORT:
            fail(f"{label}: {N_SHORT - same} streams differ from greedy's")
        info.setdefault("sampler_serve", []).append(dict(
            top_k=top_k, tok_s=res.decode_tokens_per_s, wall=wall,
            greedy_equal=same))
        del eng
        torch.cuda.empty_cache()
    print(f"[serve]   temperature({SAMPLER_TEMP}): top_k 50 decode "
          f"{rows[50].decode_tokens_per_s:.1f} tok/s vs top_k 1 (the greedy "
          f"stream, same requests) {rows[1].decode_tokens_per_s:.1f}; "
          f"{info['smi']}")


def _check_telemetry(info: dict, label: str, tr, mx, res, wall: float, *,
                     causal: bool) -> None:
    """A traced run's telemetry: the exported Chrome trace reloads as
    JSON with every recorded event and none dropped; the metrics
    snapshot's counters equal the run's result; with `causal` (a tier
    run) the first spill, preempt, restore and fetch come in that order
    (the victim's blocks are snapshotted before its ids are released, the
    continuation fetches them inside its restore span). Prints the host
    seconds per span name beside the run's wall time."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        with open(tr.export(os.path.join(d, "trace.json"))) as f:
            doc = json.load(f)
    evs = [e for e in doc["traceEvents"] if e["ph"] != "M"]
    if len(evs) != len(tr) or tr.dropped:
        fail(f"{label}: trace reloaded {len(evs)} of {len(tr)} events, "
             f"{tr.dropped} dropped")
    snap = mx.snapshot()
    want = {"engine.decode_steps": res.decode_steps,
            "sched.preemptions": sum(r.n_preemptions for r in res.results),
            "requests.completed": sum(r.finish_reason != "failed"
                                      for r in res.results)}
    if res.tier is not None:
        want.update({"tier.spills": res.tier["n_spills"],
                     "tier.fetches": res.tier["n_fetches"]})
    got = {k: snap.get(k) for k in want}
    if got != want:
        fail(f"{label}: metrics counters {got}, the result's {want}")
    if causal:
        def first(name, ph):
            hits = [e["ts"] for e in evs if e["name"] == name
                    and e["ph"] == ph]
            if not hits:
                fail(f"{label}: no {name!r} ({ph}) event in the trace")
            return min(hits)
        chain = [first("spill", "i"), first("preempt", "i"),
                 first("restore", "X"), first("fetch", "i")]
        if chain != sorted(chain):
            fail(f"{label}: spill / preempt / restore / fetch at {chain} "
                 "(microseconds), not in causal order")
    secs, counts = {}, {}
    for e in evs:
        if e["ph"] == "X":
            secs[e["name"]] = secs.get(e["name"], 0.0) + e["dur"] / 1e6
            counts[e["name"]] = counts.get(e["name"], 0) + 1
    audits = sum(e["name"] == "audit" for e in evs)
    print(f"[serve]   telemetry {label}: {len(evs)} events, 0 dropped; "
          f"host seconds per span: "
          + ", ".join(f"{n} {secs.get(n, 0.0):.3f} s ({counts.get(n, 0)})"
                      for n in SPAN_NAMES)
          + f", audit {audits} instants; wall {wall:.2f} s"
          + ("; spill <= preempt <= restore <= fetch" if causal else "")
          + f"; counters {got} equal the result's; {info['smi']}")
    info.setdefault("telemetry", []).append(dict(
        label=label, events=len(evs), span_s=secs, span_n=counts,
        audits=audits, wall=wall))


def _counted_audits(eng):
    """Count the engine's audits that read the device block table (the
    periodic ones); returns the one-element counter list."""
    n = [0]
    audit = eng._run_audit

    def counted(sched, cache=None):
        n[0] += cache is not None
        return audit(sched, cache)

    eng._run_audit = counted
    return n


def _serve_overload(info: dict, params, kernels, prompts, plain) -> None:
    """The overload ladder at full width and depth (OVERLOAD_RUNS): every
    request completes, preemptions happen (exactly the forced count where
    forced), every audit is clean (the periodic ones with the device
    block-table check and the host census), the pool peak stays within
    the pool, the bf16 streams equal the unpreempted run's for the same
    requests token for token (replay repeats the same row operations at
    the same shapes, a restore puts back the same bytes; not gated under
    degradation, which is lossy), and launches are exact: replay steps
    are decode steps, each re-admission that recomputes adds its prompt's
    B4 segments (and B6 once a layer under kivi2), a restore from the
    host tier and a degrade add nothing. With the tier every preemption
    spills and restores (fetches = spills - refusals, nothing replayed);
    with degradation at least one degrade drops at least one block.
    Prints preemptions, retries, replayed tokens, re-admission prefill
    seconds, tok/s and TTFT beside the unpreempted run's, the pool peak,
    the tier's bytes, copy rates and fetch stall (beside the run without
    the tier), and the degrade counts."""
    import numpy as np
    import torch
    from repro_torch.configs.granite_8b import CONFIG as cfg
    from repro_torch.core.policy import presets
    from repro_torch.obs import Metrics, Tracer
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request
    launches = info["launches"]
    n_layers, C = cfg.num_layers, CHUNK_LEN
    reqs_p = prompts[:N_SHORT]
    no_tier = {}
    tier_wall = {}
    for pname, opts, forced, gate_streams, traced in OVERLOAD_RUNS:
        pol = presets(budget=BUDGET, window=WINDOW)[pname]
        tr, mx = (Tracer(), Metrics()) if traced else (None, None)
        eng = Engine(cfg, params, pol, prompt_len=max(BUCKETS),
                     max_new=MAX_NEW, slots=SLOTS, buckets=BUCKETS,
                     paged=True, chunked_prefill=True, chunk_len=C,
                     audit_every=OVERLOAD_AUDIT, tracer=tr, metrics=mx,
                     **opts)
        n_audit = _counted_audits(eng)
        label = (f"{pname} paged+chunked overload "
                 + ("lazy+preemption" if eng.preemption and not eng.preempt_at
                    else f"preempt_at {eng.preempt_at}")
                 + ("+tier" if eng.tiering else "")
                 + ("+degrade" if eng.pressure is not None else "")
                 + ("+trace" if traced else "")
                 + f" pool {eng.pool_blocks}")
        reqs = [Request(tokens=p, max_new=MAX_NEW) for p in reqs_p]
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        t1 = time.perf_counter()
        res = eng.generate_continuous(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        n = {name: k.launches for name, k in kernels.items()}
        for name in KERNELS:
            launches[name] += n[name]
        base = plain[(pname, True)]
        # the same requests' mean TTFT in the unpreempted run
        base_ttft = float(np.mean([r.ttft_s
                                   for r in base.results[:N_SHORT]]))
        n_pre = sum(r.n_preemptions for r in res.results)
        n_ret = sum(r.n_retries for r in res.results)
        done = [r for r in res.results if r.finish_reason == "length"
                and r.n_tokens == MAX_NEW]
        same = sum(a.tokens.tolist() == b.tokens.tolist()
                   for a, b in zip(res.results, base.results[:N_SHORT]))
        print(f"[serve] {label}: {len(done)}/{N_SHORT} requests completed "
              f"(reasons {sorted({r.finish_reason for r in res.results})}); "
              f"{n_pre} preemptions ({[r.n_preemptions for r in res.results]}"
              f" per request), {n_ret} admission retries, "
              f"{len(res.recomputed_uids)} re-admissions recomputed, "
              f"{res.replayed_tokens} tokens replayed, re-admission prefill "
              f"{res.readmit_prefill_s:.3f} of {res.prefill_seconds:.3f} s; "
              f"decode {res.decode_tokens_per_s:.1f} tok/s over "
              f"{res.decode_steps} steps vs unpreempted "
              f"{base.decode_tokens_per_s:.1f} over {base.decode_steps}, "
              f"ttft mean {res.ttft_mean_s:.3f} vs {base_ttft:.3f} s (the "
              f"same requests; unpreempted run: {len(base.results)} "
              f"requests); pool peak "
              f"{res.pool_peak_blocks}/{res.pool_blocks} blocks (unpreempted "
              f"{base.pool_peak_blocks}/{base.pool_blocks}); {n_audit[0]} "
              f"device-table audits, all clean; bf16 streams equal to the "
              f"unpreempted run: {same}/{N_SHORT}"
              f"{'' if gate_streams else ' (reported, not gated: lossy)'}; "
              f"wall {wall:.2f} s; launches "
              + " ".join(f"{k} {v}" for k, v in n.items()))
        row = dict(
            label=label, preemptions=n_pre, retries=n_ret,
            recomputed=len(res.recomputed_uids),
            replayed=res.replayed_tokens,
            readmit_prefill_s=res.readmit_prefill_s,
            prefill_s=res.prefill_seconds, tok_s=res.decode_tokens_per_s,
            base_tok_s=base.decode_tokens_per_s, ttft=res.ttft_mean_s,
            base_ttft=base_ttft, peak=res.pool_peak_blocks,
            pool=res.pool_blocks, wall=wall, streams_equal=same)
        if len(done) != N_SHORT:
            fail(f"{label}: only {len(done)} of {N_SHORT} requests "
                 "completed")
        if (forced != "any"
                and ((n_pre < 1) if forced is None else (n_pre != forced))):
            fail(f"{label}: {n_pre} preemptions, want "
                 + ("at least 1" if forced is None else f"exactly {forced}"))
        if not (n_audit[0] >= 1 and eng.last_audit["clean"]
                and res.pool_peak_blocks <= res.pool_blocks):
            fail(f"{label}: {n_audit[0]} device-table audits, last "
                 f"{eng.last_audit}, peak {res.pool_peak_blocks} of "
                 f"{res.pool_blocks} blocks")
        if gate_streams and same != N_SHORT:
            fail(f"{label}: {N_SHORT - same} bf16 streams differ from the "
                 "unpreempted run's")
        # B4 segments: every first admission, and every re-admission that
        # recomputes (a restore from the tier streams no segment)
        seg = {r.uid: -(-len(r.tokens) // C) for r in reqs}
        segments = (sum(seg.values())
                    + sum(seg[u] for u in res.recomputed_uids))
        want = _want_launches(eng, res, n_layers,
                              N_SHORT + len(res.recomputed_uids), segments)
        if n != want:
            fail(f"{label}: kernel launches {n}, want {want} "
                 f"({res.decode_steps} decode steps, {res.kv_flush_steps} "
                 f"flush steps, {len(res.recomputed_uids)} recomputed "
                 f"re-admissions, {n_layers} layers)")
        if eng.tiering:
            _check_tier_run(info, label, eng, res, n_pre, row, no_tier)
            tier_wall[traced] = wall
        elif eng.pressure is None and eng.lazy_blocks:
            no_tier.update(tok_s=res.decode_tokens_per_s,
                           ttft=res.ttft_mean_s, wall=wall)
            if len(res.recomputed_uids) != n_pre:
                fail(f"{label}: {len(res.recomputed_uids)} recomputed "
                     f"re-admissions for {n_pre} preemptions")
        if traced:
            _check_telemetry(info, label, tr, mx, res, wall,
                             causal=eng.tiering)
            if False in tier_wall:
                print(f"[serve]   tracing cost: the tier run's wall "
                      f"{tier_wall[True]:.2f} s traced vs "
                      f"{tier_wall[False]:.2f} s untraced, {len(tr)} "
                      f"events (a reading, not gated); {info['smi']}")
                info["trace_cost"] = dict(traced_wall=tier_wall[True],
                                          untraced_wall=tier_wall[False],
                                          events=len(tr))
        if eng.pressure is not None:
            st = eng.pressure.stats
            print(f"[serve]   degrade: {st['degrades']} degrades dropped "
                  f"{st['blocks_dropped']} blocks ({st['ticks_pressed']} "
                  f"pressed ticks, peak pool usage "
                  f"{st['peak_used_frac']:.3f}); {res.kv_flush_steps} flush "
                  f"steps through B6 ({n['kvquant']} launches)")
            row.update(degrades=st["degrades"],
                       blocks_dropped=st["blocks_dropped"],
                       peak_used_frac=st["peak_used_frac"])
            if st["degrades"] < 1 or st["blocks_dropped"] < 1:
                fail(f"{label}: no degrade under pressure ({st})")
        info.setdefault("overload_serve", []).append(row)
        del eng, res
        torch.cuda.empty_cache()


def _check_tier_run(info, label, eng, res, n_pre, row, no_tier) -> None:
    """The host tier's gates and readings: every preemption spilled and
    was restored (no prefix cache here, so every spill and fetch is a
    slot's), nothing recomputed or replayed, the census drained; prints
    the bytes each way, the device-to-host and host-to-device copy rates
    (their CUDA-event times), the fetch stall and what the tier pins,
    tok/s and TTFT beside the same run without the tier."""
    tier, t = eng.host_tier, res.tier
    d2h, h2d = tier.d2h_seconds, tier.h2d_seconds
    print(f"[serve]   tier: {t['spills']} spills / {t['fetches']} fetches "
          f"({t['refused_fetches']} refused), {t['bytes_spilled'] / 1e9:.3f}"
          f" GB spilled at {t['bytes_spilled'] / max(d2h, 1e-12) / 1e9:.1f} "
          f"GB/s ({d2h * 1e3:.2f} ms of side-stream copies), "
          f"{t['bytes_fetched'] / 1e9:.3f} GB fetched at "
          f"{t['bytes_fetched'] / max(h2d, 1e-12) / 1e9:.1f} GB/s "
          f"({h2d * 1e3:.2f} ms of main-stream copies), fetch stall "
          f"{t['fetch_stall_s'] * 1e3:.3f} ms, {tier.pinned_bytes / 1e9:.3f}"
          f" GB pinned; tok/s {res.decode_tokens_per_s:.1f} vs "
          f"{no_tier.get('tok_s', float('nan')):.1f} without the tier, ttft "
          f"mean {res.ttft_mean_s:.3f} vs {no_tier.get('ttft', float('nan')):.3f}"
          f" s; {info['smi']}")
    row.update(spills=t["spills"], fetches=t["fetches"],
               refused_fetches=t["refused_fetches"],
               bytes_spilled=t["bytes_spilled"],
               bytes_fetched=t["bytes_fetched"], d2h_s=d2h, h2d_s=h2d,
               fetch_stall_s=t["fetch_stall_s"],
               pinned_bytes=tier.pinned_bytes,
               no_tier_tok_s=no_tier.get("tok_s"),
               no_tier_ttft=no_tier.get("ttft"))
    if not (t["spills"] == n_pre and t["refused_fetches"] == 0
            and t["fetches"] == t["spills"] - t["refused_fetches"]
            and not res.recomputed_uids and res.replayed_tokens == 0
            and t["host_entries"] == 0
            and t["bytes_fetched"] == t["bytes_spilled"] > 0):
        fail(f"{label}: tier {t} with {n_pre} preemptions, "
             f"{len(res.recomputed_uids)} recomputed re-admissions, "
             f"{res.replayed_tokens} tokens replayed")


# prefix-cache runs: paged + chunked (CHUNK_LEN), SLOTS slots, MAX_NEW new
# tokens, N_REQUESTS prompts of 2048 tokens whose first PREFIX_SHARED are
# one template. (policy, engine options): `full` keeps every row in
# 16-row blocks at the 640-block pool; kivi2 at budget 1920 keeps the
# whole pre-window prompt (the smallest budget at which all of it is
# shareable) in 128-row blocks, its pool 192 blocks — 1.6x the 8 x 15
# blocks of parity, so the index (template + 3 suffix blocks a request)
# is never reclaimed and the counts below are exact. Each run with
# sharing is set beside the same requests without it. The runs use the
# first PREFIX_LAYERS of the 36 layers (full width): cut in half to keep
# the script near 700 s once the noise, sampler and traced runs joined,
# and in half again (9) once the encoder-decoder and training phases did
# (the schedule, the counts and the pool sizes do not depend on depth).
PREFIX_SHARED = 1536
PREFIX_LAYERS = 9
PREFIX_RUNS = (("full", dict(pool_blocks=640)),
               ("kivi2", dict(budget=1920, pool_blocks=192)))
# near-hits: NEAR_REQUESTS copies of one template with tokens NEAR_EDIT
# replaced (a 256-row exact prefix, overlap 0.97 >= 0.8): every request
# after the first goes through CacheBlend, at each recompute fraction
NEAR_REQUESTS, NEAR_EDIT, NEAR_FRACS = 8, (256, 320), (1.0, 0.25)


def _prefix_prompts(rng, vocab: int, n: int):
    """(templated prompts, near-hit prompts) of 2048 tokens."""
    import numpy as np
    L = max(BUCKETS)
    template = rng.integers(0, vocab, size=L)
    exact = [np.concatenate([template[:PREFIX_SHARED],
                             rng.integers(0, vocab, size=L - PREFIX_SHARED)])
             for _ in range(n)]
    near = []
    for _ in range(NEAR_REQUESTS):
        p = template.copy()
        p[NEAR_EDIT[0]:NEAR_EDIT[1]] = rng.integers(
            0, vocab, size=NEAR_EDIT[1] - NEAR_EDIT[0])
        near.append(p)
    return exact, near


def _serve_prefix(info: dict, params, kernels) -> None:
    """The prefix-cache runs at full width, PREFIX_LAYERS deep (the
    first layers of `params`): completion, the
    warm / cold / near-hit / copy-on-write counts the schedule implies
    (one admission at a time, so every request after the first finds the
    first one's blocks indexed; kivi2's first flush of every slot evicts
    at cap, so every slot un-shares), exact launches (B4 only for the
    segments streamed: all of a cold prompt, the suffix of a warm one,
    none of a near-hit), a clean audit with the index's references, and
    the pool peaks, prefill seconds and mean TTFT beside the twin run."""
    import numpy as np
    import torch
    from repro_torch.configs.granite_8b import CONFIG
    from repro_torch.core.policy import presets
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request
    cfg = CONFIG.replace(num_layers=PREFIX_LAYERS)
    launches = info["launches"]
    L, C, n_layers = max(BUCKETS), CHUNK_LEN, cfg.num_layers
    exact, near = _prefix_prompts(np.random.default_rng(5), cfg.vocab_size,
                                  N_REQUESTS)
    runs = [(pname, kw, exact, dict(prefix_sharing=share))
            for pname, kw in PREFIX_RUNS for share in (True, False)]
    runs += [("full", dict(pool_blocks=640), near,
              dict(prefix_sharing=True, near_hit=frac))
             for frac in NEAR_FRACS]
    twin = {}
    for pname, kw, prompts, share_kw in runs:
        kw = dict(kw)
        pol = presets(budget=kw.pop("budget", BUDGET), window=WINDOW)[pname]
        eng = Engine(cfg, params, pol, prompt_len=L, max_new=MAX_NEW,
                     slots=SLOTS, buckets=(L,), paged=True,
                     chunked_prefill=True, chunk_len=C, **kw, **share_kw)
        n_req = len(prompts)
        sharing, frac = share_kw["prefix_sharing"], share_kw.get("near_hit")
        label = (f"{pname} paged+chunked "
                 + (f"near-hit {frac}" if frac else
                    "sharing" if sharing else "no sharing"))
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        t1 = time.perf_counter()
        res = eng.generate_continuous([Request(tokens=p, max_new=MAX_NEW)
                                       for p in prompts])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        n = {name: k.launches for name, k in kernels.items()}
        for name in KERNELS:
            launches[name] += n[name]
        done = [r for r in res.results if r.finish_reason == "length"
                and r.n_tokens == MAX_NEW]
        if len(done) != n_req:
            fail(f"{label}: only {len(done)} of {n_req} requests completed")
        pf = res.prefix
        if sharing:
            # what the schedule implies
            want_pf = dict(cold=1, warm_hits=0 if frac else n_req - 1,
                           near_hits=n_req - 1 if frac else 0,
                           cow_copies=n_req if pol.spec.quantized else 0)
            got_pf = {k: pf[k] for k in want_pf}
            if got_pf != want_pf:
                fail(f"{label}: prefix counts {got_pf}, want {want_pf}")
            warm_segs = 0 if frac else -(-(L - PREFIX_SHARED) // C)
            segments = (-(-L // C) + (n_req - 1) * warm_segs)
        else:
            segments = n_req * -(-L // C)
        want = _want_launches(eng, res, n_layers, n_req, segments)
        if n != want:
            fail(f"{label}: kernel launches {n}, want {want} "
                 f"({res.decode_steps} decode steps, {res.kv_flush_steps} "
                 f"flush steps, {n_layers} layers)")
        if not (eng.last_audit["clean"]
                and res.pool_peak_blocks <= res.pool_blocks):
            fail(f"{label}: pool audit {eng.last_audit}")
        mapped = pf["peak_mapped_blocks"] if pf else res.pool_peak_blocks
        line = (f"[serve] {label}: {len(done)}/{n_req} requests completed, "
                f"prefill {res.prefill_seconds:.3f} s, ttft mean "
                f"{res.ttft_mean_s:.3f} s, decode "
                f"{res.decode_tokens_per_s:.1f} tok/s, wall {wall:.2f} s; "
                f"pool peak {res.pool_peak_blocks}/{res.pool_blocks} blocks "
                f"of {eng.block_len} rows allocated, {mapped} mapped by "
                f"slots; audit clean ({eng.last_audit['holders']} holders)")
        if pf:
            wp, cp = pf["warm_prefill_s"], pf["cold_prefill_s"]
            line += (f"; {pf['warm_hits']} warm / {pf['cold']} cold / "
                     f"{pf['near_hits']} near-hit, {pf['cow_copies']} CoW, "
                     f"{pf['ingested_blocks']} blocks indexed, "
                     f"{pf['evicted_blocks']} evicted, {pf['index_blocks']} "
                     f"held at the end; admission prefill mean warm / "
                     f"near {np.mean(wp) if wp else 0.0:.3f} s, cold "
                     f"{np.mean(cp) if cp else 0.0:.3f} s")
        print(line + "; launches " + " ".join(f"{k} {v}"
                                               for k, v in n.items()))
        row = dict(label=label, prefill_s=res.prefill_seconds,
                   ttft=res.ttft_mean_s, tok_s=res.decode_tokens_per_s,
                   peak=res.pool_peak_blocks, mapped=mapped, wall=wall)
        if sharing and not frac:
            twin[pname] = row
        elif not sharing:
            on = twin[pname]
            print(f"[serve]   {pname}: sharing vs not: prefill "
                  f"{on['prefill_s']:.3f} / {row['prefill_s']:.3f} s, ttft "
                  f"mean {on['ttft']:.3f} / {row['ttft']:.3f} s, tok/s "
                  f"{on['tok_s']:.1f} / {row['tok_s']:.1f}, blocks mapped "
                  f"by slots at peak {on['mapped']} / {row['mapped']}, "
                  f"allocated {on['peak']} / {row['peak']}")
            if pname == "full" and not on["mapped"] < row["mapped"]:
                fail(f"{pname}: sharing mapped {on['mapped']} blocks at "
                     f"peak, not fewer than {row['mapped']} without")
        info.setdefault("prefix_serve", []).append(row)
        del eng, res
        torch.cuda.empty_cache()


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


# ---------------------------------------------------------------------------
# 5. e2e: kernels against the reference path, 4-layer granite-8b
# ---------------------------------------------------------------------------

E2E_LAYERS, E2E_STEPS = 4, 4
# max |logit delta| bound, kernels vs reference path, bf16 model (logits
# of magnitude ~5 at this random init): the reference rounds scores and
# probabilities through bf16 where the kernels keep f32, and the flash
# kernel's prefill feeds the cache slightly different K/V roundings, so
# the two bf16 paths drift apart. Readings at this seed: 0.0643 / 0.0728
# / 0.1773 / 0.0763 (full / h2o / kivi2 / h2o+kivi2); 0.1926 worst in an
# earlier build of the kernels. An f32 run of the reference path on the
# same weights is printed beside them: it shows which bf16 path is closer
# to exact arithmetic.
E2E_LOGIT_TOL = 0.25


def phase_e2e(info: dict) -> None:
    import numpy as np
    import torch
    from repro_torch.configs.granite_8b import CONFIG
    from repro_torch.core.policy import presets
    from repro_torch.nn import model as M
    from repro_torch.serving.engine import Engine
    cfg = CONFIG.replace(num_layers=E2E_LAYERS)
    params = M.init_params(cfg, seed=1, device="cuda")
    params32 = _cast(params, torch.float32)
    cfg32 = cfg.replace(dtype=torch.float32)
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        size=(SLOTS, BUCKETS[0])),
                           device="cuda")
    for pname in SERVE_POLICIES:
        pol = presets(budget=BUDGET, window=WINDOW)[pname]
        runs = [(Engine(c, p, pol, prompt_len=max(BUCKETS), max_new=MAX_NEW,
                        slots=SLOTS, buckets=BUCKETS, use_kernels=uk), p)
                for c, p, uk in ((cfg, params, True), (cfg, params, False),
                                 (cfg32, params32, False))]
        caches, logits = [], []
        for e, p in runs:
            lg, c = M.prefill(p, e.cfg, {"tokens": toks}, e.spec,
                              layer_budgets=e.layer_budgets)
            caches.append(c)
            logits.append([lg])
        for _ in range(E2E_STEPS):
            tok = torch.argmax(logits[2][-1], -1)[:, None]   # f32 path leads
            for (e, p), c, lgs in zip(runs, caches, logits):
                lgs.append(M.decode_step(p, e.cfg, c, tok, e.spec)[0])
        torch.cuda.synchronize()

        def delta(a, b):
            return [(x - y).abs().max().item() for x, y in zip(a, b)]

        d_kr = delta(logits[0], logits[1])
        d_k32, d_r32 = delta(logits[0], logits[2]), delta(logits[1], logits[2])
        scale = max(x.abs().max().item() for x in logits[2])
        print(f"[e2e] {pname}: max|dlogit| kernels vs reference (bf16) "
              f"prefill {d_kr[0]:.4f} decode {max(d_kr[1:]):.4f} (tol "
              f"{E2E_LOGIT_TOL}); vs f32 reference: kernels "
              f"{max(d_k32):.4f}, bf16 reference {max(d_r32):.4f}; "
              f"max|logit| {scale:.2f}")
        if not all(math.isfinite(d) and d <= E2E_LOGIT_TOL for d in d_kr):
            fail(f"e2e {pname}: kernels vs reference logits differ by "
                 f"{max(d_kr):.4f} > {E2E_LOGIT_TOL}")
        del runs, caches, logits
        # paged pool + chunked admission: B3 / B4 (and the gqa prefill of
        # the mass policies) against the gather + materialize reference
        d_pg = _kernels_vs_reference(cfg, params, pol, toks,
                                     paged=True)["kr"]
        print(f"[e2e] {pname} paged+chunked: max|dlogit| kernels vs "
              f"reference (bf16) prefill {d_pg[0]:.4f} decode "
              f"{max(d_pg[1:]):.4f} (tol {E2E_LOGIT_TOL}; dense path above: "
              f"{max(d_kr):.4f})")
        if not all(math.isfinite(d) and d <= E2E_LOGIT_TOL for d in d_pg):
            fail(f"e2e {pname} paged+chunked: kernels vs reference logits "
                 f"differ by {max(d_pg):.4f} > {E2E_LOGIT_TOL}")
    del params, params32
    torch.cuda.empty_cache()
    _e2e_spec()
    _e2e_prefix()
    _e2e_preempt()
    _e2e_noise()


# speculative e2e, 4-layer granite-8b in f32 with the kernels: requests,
# new tokens and slots of the run, and the top-2 logit margin below which
# a divergence from the plain stream is a near-tie (f32 summation order
# of the batched verify GEMMs, M = slots x L rows, against the decode
# GEMMs, M = slots), not a fault
E2E_SPEC_REQUESTS, E2E_SPEC_NEW, E2E_SPEC_SLOTS = 8, 24, 4
E2E_MARGIN = 1e-4


def _e2e_spec() -> None:
    """Speculative streams against plain streams, token for token, in
    f32 with the kernels (`full` and `kivi2` dense, `full` paged +
    chunked; drafters `same` and `window:32`): the JAX package's
    contract. A divergence fails unless the target's top-2 margin at that
    step (recomputed from the plain stream) is below E2E_MARGIN."""
    import numpy as np
    import torch
    from repro_torch.configs.granite_8b import CONFIG
    from repro_torch.core.policy import presets
    from repro_torch.nn import model as M
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request
    cfg = CONFIG.replace(num_layers=E2E_LAYERS, dtype=torch.float32)
    params = M.init_params(cfg, seed=3, device="cuda")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=BUCKETS[i % 2])
               for i in range(E2E_SPEC_REQUESTS)]
    chunked = dict(paged=True, chunked_prefill=True, chunk_len=CHUNK_LEN)

    def serve(pol, **kw):
        eng = Engine(cfg, params, pol, prompt_len=max(BUCKETS),
                     max_new=E2E_SPEC_NEW, slots=E2E_SPEC_SLOTS,
                     buckets=BUCKETS, **kw)
        res = eng.generate_continuous(
            [Request(tokens=p, max_new=E2E_SPEC_NEW) for p in prompts])
        if eng.paged and not eng.last_audit["clean"]:
            fail(f"e2e spec: pool audit {eng.last_audit}")
        return eng, res

    def margin(eng, prompt, stream, i):
        """Top-2 logit margin of the target at token i of the stream."""
        toks = torch.as_tensor(prompt[None], device="cuda")
        lg, pc = M.prefill(params, cfg, {"tokens": toks}, eng.spec,
                           layer_budgets=eng.layer_budgets)
        for t in stream[:i]:
            lg, _ = M.decode_step(params, cfg, pc, torch.as_tensor(
                [[int(t)]], device="cuda"), eng.spec)
        top = torch.topk(lg[0], 2).values
        return (top[0] - top[1]).item()

    for pname, paged in (("full", False), ("kivi2", False), ("full", True)):
        pol = presets(budget=BUDGET, window=WINDOW)[pname]
        opts = chunked if paged else {}
        eng, base = serve(pol, **opts)
        for draft in ("same", "window:32"):
            _, res = serve(pol, speculative=True, gamma=GAMMA,
                           draft_policy=draft, **opts)
            label = f"{pname}{' paged+chunked' if paged else ''} [{draft}]"
            div = []
            for r, (a, b) in enumerate(zip(base.results, res.results)):
                if a.tokens.tolist() != b.tokens.tolist():
                    m = min(len(a.tokens), len(b.tokens))
                    i = next((j for j in range(m)
                              if a.tokens[j] != b.tokens[j]), m)
                    div.append((r, i, margin(eng, prompts[r],
                                             a.tokens.tolist(), i)))
            st = res.spec
            print(f"[e2e] spec f32 {label}: "
                  f"{E2E_SPEC_REQUESTS - len(div)}/{E2E_SPEC_REQUESTS} "
                  f"streams token-equal to plain; {st.describe()}"
                  + "".join(f"; request {r} diverges at token {i}, target "
                            f"top-2 margin {mg:.3g}" for r, i, mg in div))
            if st.verify_steps == 0:
                fail(f"e2e spec {label}: no drafted verify step")
            bad = [(r, i, mg) for r, i, mg in div if not mg < E2E_MARGIN]
            if bad:
                fail(f"e2e spec {label}: streams diverge from plain decode "
                     f"at (request, token, margin) {bad}, margins not below "
                     f"{E2E_MARGIN}")
    del params
    torch.cuda.empty_cache()


# prefix e2e, 4-layer granite-8b in f32 with the kernels: the prefix
# runs' prompts (first PREFIX_SHARED tokens one template) and near-hit
# edits, fewer requests and new tokens, 4 slots
E2E_PREFIX_REQUESTS, E2E_PREFIX_NEW, E2E_PREFIX_SLOTS = 6, 24, 4


@contextlib.contextmanager
def _plain_quantizer():
    """Route the KIVI quantize-and-pack call of the cache
    (`kvquant.ops.quantize_kv_pair`) to its plain versions on the card,
    so a run can be set beside the same run through B6."""
    from repro_torch.kernels.kvquant import ops as kvq
    from repro_torch.kernels.kvquant import ref
    saved = kvq.quantize_kv_pair
    kvq.quantize_kv_pair = lambda k, v, *, bits, group: (
        ref.kquant_ref(k, bits, group), ref.vquant_ref(v, bits))
    try:
        yield
    finally:
        kvq.quantize_kv_pair = saved


def _e2e_prefix() -> None:
    """Token-for-token gates in f32 with the kernels: sharing streams
    equal non-sharing streams (`full`, kivi2 with copy-on-write), a
    near-hit at recompute 1.0 equals the cold admission of the same
    prompts, and kivi2 through B6 equals kivi2 through the plain
    quantizer on the card (streams, and the packed store after one
    prefill: codes bit-equal or the tie-only differences counted)."""
    import numpy as np
    import torch
    from repro_torch.configs.granite_8b import CONFIG
    from repro_torch.core.policy import presets
    from repro_torch.kernels.kvquant import ops as kvq
    from repro_torch.nn import model as M
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request
    cfg = CONFIG.replace(num_layers=E2E_LAYERS, dtype=torch.float32)
    params = M.init_params(cfg, seed=5, device="cuda")
    exact, near = _prefix_prompts(np.random.default_rng(6), cfg.vocab_size,
                                  E2E_PREFIX_REQUESTS)
    L = max(BUCKETS)

    def serve(pname, prompts, budget=BUDGET, pool=640, **kw):
        pol = presets(budget=budget, window=WINDOW)[pname]
        eng = Engine(cfg, params, pol, prompt_len=L, max_new=E2E_PREFIX_NEW,
                     slots=E2E_PREFIX_SLOTS, buckets=(L,), paged=True,
                     chunked_prefill=True, chunk_len=CHUNK_LEN,
                     pool_blocks=pool, **kw)
        res = eng.generate_continuous(
            [Request(tokens=p, max_new=E2E_PREFIX_NEW) for p in prompts])
        if not eng.last_audit["clean"]:
            fail(f"e2e prefix: pool audit {eng.last_audit}")
        return eng, res

    def gate(label, a, b, extra=""):
        same = sum(x.tokens.tolist() == y.tokens.tolist()
                   for x, y in zip(a.results, b.results))
        print(f"[e2e] prefix f32 {label}: {same}/{len(a.results)} streams "
              f"token-equal{extra}")
        if same != len(a.results):
            fail(f"e2e prefix {label}: streams differ")

    for pname, budget, pool in (("full", BUDGET, 640), ("kivi2", 1920, 128)):
        _, off = serve(pname, exact, budget, pool)
        _, on = serve(pname, exact, budget, pool, prefix_sharing=True)
        pf = on.prefix
        gate(f"{pname} sharing vs not", on, off,
             f" ({pf['warm_hits']} warm / {pf['cold']} cold, "
             f"{pf['cow_copies']} CoW)")
        if pf["warm_hits"] == 0:
            fail(f"e2e prefix {pname}: no warm hit")
    _, cold = serve("full", near)
    _, blend = serve("full", near, prefix_sharing=True, near_hit=1.0)
    gate("near-hit at recompute 1.0 vs cold", blend, cold,
         f" ({blend.prefix['near_hits']} near-hits)")
    if blend.prefix["near_hits"] == 0:
        fail("e2e prefix: no near-hit")
    # kivi2 through B6 vs through the plain quantizer on the card
    kvq.kvquant_kernel.launches = 0
    eng, fused = serve("kivi2", exact, 1920, 128, prefix_sharing=True)
    n_b6 = kvq.kvquant_kernel.launches
    with _plain_quantizer():
        _, plain = serve("kivi2", exact, 1920, 128, prefix_sharing=True)
    if n_b6 == 0 or kvq.kvquant_kernel.launches != n_b6:
        fail(f"e2e prefix: B6 launches {n_b6} with the kernel, "
             f"{kvq.kvquant_kernel.launches - n_b6} without")
    toks = torch.as_tensor(exact[0][None], device="cuda")
    _, pc_k = M.prefill(params, cfg, {"tokens": toks}, eng.spec,
                        layer_budgets=eng.layer_budgets)
    with _plain_quantizer():
        _, pc_p = M.prefill(params, cfg, {"tokens": toks}, eng.spec,
                            layer_budgets=eng.layer_budgets)
    diff = {f: int((getattr(pc_k.attn, f) != getattr(pc_p.attn, f))
                   .sum().item())
            for f in ("k", "v", "k_scale", "k_zero", "v_scale", "v_zero")}
    gate("kivi2 B6 vs plain quantizer", fused, plain,
         f"; packed store after one prefill: differing entries {diff}")
    if any(diff.values()):
        fail(f"e2e prefix: B6 and the plain quantizer store {diff} "
             "differing entries (f32 inputs: no ties expected)")
    del params, eng
    torch.cuda.empty_cache()


# preemption e2e, 4-layer granite-8b in f32 with the kernels: the
# speculative e2e's requests, new tokens and slots; (label, engine
# options, ladder options, forced preemptions or None: at least one).
# The forced (dispatch or round, slot) pairs name slots active then; the
# lazy pool (392 blocks of 16 rows) is under the 4 slots' growth (2 x 66
# + 2 x 130 blocks), so it starves.
_CHUNKED = dict(paged=True, chunked_prefill=True, chunk_len=CHUNK_LEN)
E2E_PREEMPT_RUNS = (
    ("full dense", {}, dict(preempt_at=((4, 0), (9, 2), (15, 1))), 3),
    ("kivi2 paged+chunked", _CHUNKED,
     dict(preempt_at=((6, 0), (14, 1), (30, 2))), 3),
    ("full paged+chunked lazy", _CHUNKED,
     dict(pool_blocks=392, block_growth="lazy", preemption=True,
          audit_every=8), None),
    ("full paged+chunked spec[same]",
     dict(_CHUNKED, speculative=True, gamma=GAMMA, draft_policy="same"),
     dict(preempt_at=((3, 0), (12, 1), (20, 2))), 3),
    ("full paged+chunked tier", _CHUNKED,
     dict(preempt_at=((6, 0), (14, 1), (30, 2)), tiering=True), 3),
    ("kivi2 paged+chunked tier", _CHUNKED,
     dict(preempt_at=((6, 0), (14, 1), (30, 2)), tiering=True), 3),
)


def _e2e_preempt() -> None:
    """Recompute-on-resume in f32 with the kernels, token for token and
    with no margin: each run of E2E_PREEMPT_RUNS against its unpreempted
    twin (`full` dense: B2 re-prefill, B1 replay; kivi2: B4 / B6 again at
    re-admission, B3 replay across ring flushes; lazy growth starving the
    pool; the speculative loop's replay through plain rounds)."""
    import numpy as np
    import torch
    from repro_torch.configs.granite_8b import CONFIG
    from repro_torch.core.policy import presets
    from repro_torch.nn import model as M
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request
    cfg = CONFIG.replace(num_layers=E2E_LAYERS, dtype=torch.float32)
    params = M.init_params(cfg, seed=7, device="cuda")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, size=BUCKETS[i % 2])
               for i in range(E2E_SPEC_REQUESTS)]
    for label, opts, ladder, forced in E2E_PREEMPT_RUNS:
        pname = label.split()[0]
        out = []
        for kw in ({}, ladder):
            eng = Engine(cfg, params,
                         presets(budget=BUDGET, window=WINDOW)[pname],
                         prompt_len=max(BUCKETS), max_new=E2E_SPEC_NEW,
                         slots=E2E_SPEC_SLOTS, buckets=BUCKETS, **opts, **kw)
            out.append(eng.generate_continuous(
                [Request(tokens=p, max_new=E2E_SPEC_NEW) for p in prompts]))
            if eng.paged and not eng.last_audit["clean"]:
                fail(f"e2e preempt {label}: pool audit {eng.last_audit}")
        twin, res = out
        n_pre = sum(r.n_preemptions for r in res.results)
        same = sum(a.tokens.tolist() == b.tokens.tolist()
                   and a.finish_reason == b.finish_reason == "length"
                   for a, b in zip(res.results, twin.results))
        print(f"[e2e] preempt f32 {label} {ladder}: {n_pre} preemptions, "
              f"{res.replayed_tokens} tokens replayed; {same}/"
              f"{len(prompts)} streams token-equal to the unpreempted run")
        if (n_pre < 1) if forced is None else (n_pre != forced):
            fail(f"e2e preempt {label}: {n_pre} preemptions, want "
                 + ("at least 1" if forced is None else f"exactly {forced}"))
        if same != len(prompts):
            fail(f"e2e preempt {label}: {len(prompts) - same} streams "
                 "differ from the unpreempted run's")
        if ladder.get("tiering") and not (
                res.tier["fetches"] == res.tier["spills"] == n_pre
                and res.replayed_tokens == 0):
            fail(f"e2e preempt {label}: tier {res.tier}, "
                 f"{res.replayed_tokens} tokens replayed")
    _e2e_degrade(cfg, params, prompts)
    del params
    torch.cuda.empty_cache()


def _e2e_degrade(cfg, params, prompts) -> None:
    """kivi2 with lazy growth, preemption and degradation at the parity
    pool (E2E_SPEC_SLOTS x 4 blocks: full as the slots fill, past the
    0.85 high-water mark) in f32: through the kernels (B3, B4, B6)
    against the same run with use_kernels=False on the card. The degrade
    count, the blocks dropped, the preemptions and the streams must be
    equal, token for token."""
    from repro_torch.core.policy import presets
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request
    out = []
    for uk in (True, False):
        eng = Engine(cfg, params, presets(budget=BUDGET, window=WINDOW)[
                         "kivi2"], prompt_len=max(BUCKETS),
                     max_new=E2E_SPEC_NEW, slots=E2E_SPEC_SLOTS,
                     buckets=BUCKETS, use_kernels=uk, block_growth="lazy",
                     preemption=True, degrade=True, audit_every=8,
                     **_CHUNKED)
        res = eng.generate_continuous(
            [Request(tokens=p, max_new=E2E_SPEC_NEW) for p in prompts])
        if not eng.last_audit["clean"]:
            fail(f"e2e degrade: pool audit {eng.last_audit}")
        out.append((eng.pressure.stats, res))
    (st_k, res_k), (st_r, res_r) = out
    same = sum(a.tokens.tolist() == b.tokens.tolist()
               and a.finish_reason == b.finish_reason == "length"
               for a, b in zip(res_k.results, res_r.results))
    pre = [sum(r.n_preemptions for r in x.results) for x in (res_k, res_r)]
    print(f"[e2e] degrade f32 kivi2 lazy+preemption+degrade pool "
          f"{res_k.pool_blocks}: kernels {st_k['degrades']} degrades / "
          f"{st_k['blocks_dropped']} blocks dropped / {pre[0]} preemptions,"
          f" use_kernels=False {st_r['degrades']} / "
          f"{st_r['blocks_dropped']} / {pre[1]}; {same}/{len(prompts)} "
          "streams token-equal")
    if st_k["degrades"] < 1 or st_k["blocks_dropped"] < 1:
        fail(f"e2e degrade: no degrade under pressure ({st_k})")
    if (st_k["degrades"], st_k["blocks_dropped"], pre[0]) != \
            (st_r["degrades"], st_r["blocks_dropped"], pre[1]):
        fail(f"e2e degrade: kernels {st_k} / {pre[0]} preemptions, "
             f"reference {st_r} / {pre[1]}")
    if same != len(prompts):
        fail(f"e2e degrade: {len(prompts) - same} streams differ between "
             "the kernels and use_kernels=False")


# noise e2e, 4-layer granite-8b in f32: (label, policy, top_k of the
# temperature sampler or None for greedy, engine options), each served
# with the kernels and with use_kernels=False under one seed on the card
E2E_NOISE_RUNS = (
    ("nacl dense", "nacl", None, {}),
    ("keyformer dense", "keyformer", None, {}),
    ("nacl paged+chunked", "nacl", None, _CHUNKED),
    ("keyformer paged+chunked", "keyformer", None, _CHUNKED),
    ("full temperature(0.8, top_k=50)", "full", 50, {}),
)


def _e2e_noise() -> None:
    """The engine's generator on the card, in f32: nacl and keyformer
    (their Gumbel draws after B1 / B3 return the mass) and the
    temperature sampler, each through the kernels and with
    use_kernels=False under seed 0, must give equal streams (both paths
    draw the same shapes in the same order from one device generator).
    Then the sampler run twice under seed 0 gives one stream, and under
    seeds 0 and 1 streams that differ somewhere."""
    import numpy as np
    import torch
    from repro_torch.configs.granite_8b import CONFIG
    from repro_torch.core.policy import presets
    from repro_torch.nn import model as M
    from repro_torch.serving import sampler as sampler_lib
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request
    cfg = CONFIG.replace(num_layers=E2E_LAYERS, dtype=torch.float32)
    params = M.init_params(cfg, seed=5, device="cuda")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=BUCKETS[i % 2])
               for i in range(E2E_SPEC_REQUESTS)]

    def serve(pname, top_k, opts, use_kernels, seed):
        smp = (sampler_lib.greedy if top_k is None
               else sampler_lib.temperature(SAMPLER_TEMP, top_k))
        eng = Engine(cfg, params, presets(budget=BUDGET, window=WINDOW)[
                         pname], prompt_len=max(BUCKETS),
                     max_new=E2E_SPEC_NEW, slots=E2E_SPEC_SLOTS,
                     buckets=BUCKETS, use_kernels=use_kernels, seed=seed,
                     sampler=smp, **opts)
        res = eng.generate_continuous(
            [Request(tokens=p, max_new=E2E_SPEC_NEW) for p in prompts])
        if eng.paged and not eng.last_audit["clean"]:
            fail(f"e2e noise: pool audit {eng.last_audit}")
        if not all(r.finish_reason == "length" for r in res.results):
            fail(f"e2e noise {pname}: finish reasons "
                 f"{[r.finish_reason for r in res.results]}")
        return [r.tokens.tolist() for r in res.results]

    n = len(prompts)
    for label, pname, top_k, opts in E2E_NOISE_RUNS:
        kern = serve(pname, top_k, opts, True, 0)
        plain = serve(pname, top_k, opts, False, 0)
        same = sum(a == b for a, b in zip(kern, plain))
        print(f"[e2e] noise f32 {label} seed 0: {same}/{n} streams "
              "token-equal, kernels vs use_kernels=False")
        if same != n:
            fail(f"e2e noise {label}: {n - same} streams differ between "
                 "the kernels and use_kernels=False under one seed")
        if top_k is not None:
            again = serve(pname, top_k, opts, True, 0)
            other = serve(pname, top_k, opts, True, 1)
            n_again = sum(a == b for a, b in zip(kern, again))
            n_other = sum(a == b for a, b in zip(kern, other))
            print(f"[e2e] noise f32 {label}: seed 0 twice {n_again}/{n} "
                  f"streams equal; seeds 0 and 1 {n_other}/{n} equal")
            if n_again != n or n_other == n:
                fail(f"e2e noise {label}: seed 0 twice {n_again}/{n} "
                     f"equal, seeds 0 and 1 {n_other}/{n} equal")
    del params
    torch.cuda.empty_cache()


def _paged_kw(cfg) -> dict:
    """The engine options of a paged run: chunked admission, or for a
    mixture-of-experts config (which chunked prefill refuses: capacity
    couples a segment's tokens) monolithic admission into the pool."""
    return dict(paged=True) if cfg.is_moe else _CHUNKED


def _kernels_vs_reference(cfg, params, pol, toks, *, paged: bool,
                          witness=None, buckets=BUCKETS, src=None):
    """An engine with the kernels against one with use_kernels=False (the
    model's dtype): the admission of `toks` (one prompt a slot; monolithic
    prefill into the dense store, or into a paged pool chunked, or
    monolithic for experts; an encoder-decoder's prefill encodes `src`),
    then E2E_STEPS decode steps fed the reference's greedy tokens. Returns
    {"kr": max |logit delta| per call, "scale": the reference's max
    |logit|}; with `witness` (an f32 (cfg, params) of the same weights),
    also "k32" / "r32": each path's max |logit delta| per call against
    the f32 reference path fed the same tokens.

    An MoE config runs with its discrete choices pinned (`_DiscretePin`):
    the reference path routes and KIVI-quantizes, and the kernel path
    takes the same experts and weights at every MoE call and the same
    codes, scales and zeros at every quantization (its quantizer still
    runs). Both are discontinuous functions of their input: a bf16
    rounding can swap a token's second expert (and at capacity 1.25
    reorder which tokens drop) or move a 2-bit code a level, and MoE
    layers amplify the bf16 noise that reaches them, so without the pin
    the distance measures those flips, not the kernels. The counts of
    what the kernel path would have chosen otherwise are returned:
    "flips" / "routed" tokens, "code_flips" / "codes" code bytes."""
    import torch
    from repro_torch.nn import model as M
    from repro_torch.serving.engine import Engine
    runs = [(cfg, params, True), (cfg, params, False)]
    if witness is not None:
        runs.append((*witness, False))
    engs = [Engine(c, p, pol, prompt_len=max(buckets), max_new=MAX_NEW,
                   slots=SLOTS, buckets=buckets, use_kernels=uk,
                   **(_paged_kw(cfg) if paged else {}))
            for c, p, uk in runs]
    # the reference (engine 1) goes first where its choices are pinned
    order = [1, 0, *range(2, len(engs))] if cfg.is_moe else range(len(engs))
    pin = _DiscretePin() if cfg.is_moe else None
    admitted = [None] * len(engs)
    with (pin if pin else contextlib.nullcontext()):
        for i in order:
            e = engs[i]
            if pin:
                pin.recording = i == 1
            if paged:
                admit = (_admit_paged_mono if cfg.is_moe
                         else _admit_paged_chunked)
                admitted[i] = admit(e, toks.cpu().numpy())
            else:
                batch = {"tokens": toks}
                if src is not None:
                    batch["src_embeds"] = src
                admitted[i] = M.prefill(e.params, e.cfg, batch, e.spec,
                                        layer_budgets=e.layer_budgets)[::-1]
        logits = [[lg] for _, lg in admitted]
        for _ in range(E2E_STEPS):
            tok = torch.argmax(logits[1][-1], -1)[:, None]  # reference leads
            for i in order:
                if pin:
                    pin.recording = i == 1
                logits[i].append(M.decode_step(engs[i].params, engs[i].cfg,
                                               admitted[i][0], tok,
                                               engs[i].spec)[0])
    torch.cuda.synchronize()

    def delta(a, b):
        return [(x.float() - y.float()).abs().max().item()
                for x, y in zip(a, b)]

    out = dict(kr=delta(logits[0], logits[1]),
               scale=max(x.abs().max().item() for x in logits[1]))
    if witness is not None:
        out.update(k32=delta(logits[0], logits[2]),
                   r32=delta(logits[1], logits[2]))
    if pin:
        out.update(flips=pin.flips, routed=pin.routed,
                   code_flips=pin.code_flips, codes=pin.codes)
    return out


class _DiscretePin:
    """While open, `nn.moe._route` and `core.cache.quantize_kv` record
    each call's discrete outcome when `recording` (the experts and
    weights; the codes, scales and zeros), and otherwise hand the
    recorded ones out in call order, counting what the caller's own call
    chose otherwise: tokens routed to other experts (`flips` of
    `routed`), code bytes (`code_flips` of `codes`)."""

    def __init__(self):
        self.recording, self.routes, self.quants = True, [], []
        self.flips = self.routed = self.code_flips = self.codes = 0

    def __enter__(self):
        from repro_torch.core import cache as kvcache
        from repro_torch.nn import moe as moe_lib
        self._route, self._quant = moe_lib._route, kvcache.quantize_kv

        def route(p, x, top_k):
            logits, probs, vals, idx = self._route(p, x, top_k)
            if self.recording:
                self.routes.append((vals, idx))
                return logits, probs, vals, idx
            v0, i0 = self.routes.pop(0)
            own = idx.sort(dim=-1).values != i0.sort(dim=-1).values
            self.flips += int(own.any(-1).sum())
            self.routed += own.shape[0] * own.shape[1]
            return logits, probs, v0, i0

        def quantize_kv(k, v, spec, **kw):
            got = self._quant(k, v, spec, **kw)
            if self.recording:
                self.quants.append(got)
                return got
            ref = self.quants.pop(0)
            for a, b in zip(got, ref):
                self.code_flips += int((a.q != b.q).sum())
                self.codes += a.q.numel()
            return ref

        moe_lib._route, kvcache.quantize_kv = route, quantize_kv
        return self

    def __exit__(self, *exc):
        from repro_torch.core import cache as kvcache
        from repro_torch.nn import moe as moe_lib
        moe_lib._route, kvcache.quantize_kv = self._route, self._quant
        if not exc[0] and (self.routes or self.quants):
            fail(f"discrete pin: {len(self.routes)} routings and "
                 f"{len(self.quants)} quantizations recorded, unused")


def _admit_paged_chunked(eng, prompts):
    """Admit `prompts` (one per slot, in slot order) through the engine's
    own chunked admission into a fresh paged cache, as
    `generate_continuous` does. Returns (cache, first-token logits)."""
    import torch
    from repro_torch.core import paging
    from repro_torch.nn import model as M
    from repro_torch.serving.scheduler import Request, Scheduler
    sched = Scheduler(eng.buckets, eng.slots,
                      allocator=paging.BlockAllocator(eng.pool_blocks),
                      block_need=eng._request_blocks)
    for p in prompts:
        sched.submit(Request(tokens=p, max_new=eng.max_new))
    cache = M.init_cache(eng.cfg, eng.spec, eng.slots,
                         eng.prompt_len + eng.max_new,
                         layer_budgets=eng.layer_budgets, device="cuda",
                         paged=True, block_len=eng.block_len,
                         pool_blocks=eng.pool_blocks)
    logits = []
    while sched.pending:
        adm = eng._start_chunked_admission(sched)
        eng._advance_chunked_admission(adm, sched, cache, run_all=True)
        logits.append(adm.last_logits)
    return cache, torch.cat(logits)


def _admit_paged_mono(eng, prompts):
    """Admit `prompts` (one per slot, in slot order) by monolithic batch-1
    prefill into a fresh paged cache, as `generate_continuous` does
    without chunked prefill. Returns (cache, first-token logits)."""
    import torch
    from repro_torch.core import paging
    from repro_torch.nn import model as M
    from repro_torch.serving.scheduler import Request, Scheduler
    sched = Scheduler(eng.buckets, eng.slots,
                      allocator=paging.BlockAllocator(eng.pool_blocks),
                      block_need=eng._request_blocks)
    cache = M.init_cache(eng.cfg, eng.spec, eng.slots,
                         eng.prompt_len + eng.max_new,
                         layer_budgets=eng.layer_budgets, device="cuda",
                         paged=True, block_len=eng.block_len,
                         pool_blocks=eng.pool_blocks)
    logits = []
    for slot, p in enumerate(prompts):
        sched.submit(Request(tokens=p, max_new=eng.max_new))
        req = sched.admit_next(slot)
        lg, pc = eng._prefill(req.tokens[None])
        eng._insert(cache, sched, slot, pc)
        logits.append(lg)
    return cache, torch.cat(logits)


def _tree(fn, tree):
    return {k: (_tree(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


def _cast(tree, dtype):
    return _tree(lambda t: t.to(dtype), tree)


# ---------------------------------------------------------------------------
# 6. profile: where one decode step's time goes (full depth, 8 slots,
#    dense cache and paged pool)
# ---------------------------------------------------------------------------

PROFILE_POLICIES = ("full", "h2o+kivi2")


def phase_profile(info: dict) -> None:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.granite_8b import CONFIG
    from repro_torch.core import cache as kvcache
    from repro_torch.core.policy import presets
    from repro_torch.nn import model as M
    from repro_torch.serving.engine import Engine, RingMirror
    cfg = CONFIG
    params = M.init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(2)
    for pname, paged in [(p, pg) for p in PROFILE_POLICIES
                         for pg in (False, True)]:
        pol = presets(budget=BUDGET, window=WINDOW)[pname]
        eng = Engine(cfg, params, pol, prompt_len=max(BUCKETS),
                     max_new=MAX_NEW, slots=SLOTS, buckets=BUCKETS,
                     paged=paged, chunked_prefill=paged, chunk_len=CHUNK_LEN)
        prompts = rng.integers(0, cfg.vocab_size, (SLOTS, BUCKETS[0]))
        if paged:
            cache, _ = _admit_paged_chunked(eng, prompts)
        else:
            cache = M.init_cache(cfg, eng.spec, SLOTS,
                                 max(BUCKETS) + MAX_NEW,
                                 layer_budgets=eng.layer_budgets,
                                 device="cuda")
            for s in range(SLOTS):
                toks = torch.as_tensor(prompts[s:s + 1], device="cuda")
                _, pc = M.prefill(params, cfg, {"tokens": toks}, eng.spec,
                                  layer_budgets=eng.layer_budgets)
                kvcache.insert_request(cache.attn, s, pc.attn, batch_axis=2)
        label = pname + (" paged" if paged else "")
        ring = RingMirror(eng.spec, SLOTS)
        ring.fill()
        tok = torch.zeros(SLOTS, 1, dtype=torch.long, device="cuda")

        def step():
            lg, _ = M.decode_step(params, cfg, cache, tok, eng.spec,
                                  ring_full=ring.advance())
            return lg

        _profile_decode_step("[profile]", label, step)
        if eng.spec.quantized:
            # a step whose ring flushes: the loop computes the flush for
            # the whole batch whenever any row's ring is full (here no
            # row's is, so the flush is computed and written nowhere)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                M.decode_step(params, cfg, cache, tok, eng.spec,
                              ring_full=True)
                torch.cuda.synchronize()
            rows, n_aten, n_launch = _profile_rows(prof, 1)
            b6 = [r for r in rows if "quant_kernel" in r[0]]
            print(f"[profile] {label}: flushing step, device busy "
                  f"{sum(r[1] for r in rows):.2f} ms; B6 (fused kvquant) "
                  f"{sum(r[1] for r in b6):.3f} ms x{sum(r[2] for r in b6)}"
                  f"; host: {n_aten} aten ops, {n_launch} kernel launches")
            for key, ms, cnt in sorted(b6, key=lambda r: -r[1]):
                print(f"[profile]   {ms:8.3f} ms/step  x{cnt:<5d} {key[:90]}")
        del eng, cache
        torch.cuda.empty_cache()
    _profile_verify(params)
    del params
    torch.cuda.empty_cache()


def _profile_decode_step(tag: str, label: str, step, n: int = 8) -> dict:
    """Time `step` (one decode step as the loop dispatches it): host time
    to dispatch and wall over `n` steps after warm-up, then two steps
    under torch.profiler for device-busy time, the idle share and the top
    kernels. Prints them; returns the numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    host_ms = (time.perf_counter() - t0) * 1e3 / n   # dispatch only
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    # two profiled steps: the profiler takes seconds to fold each step's
    # ~15 thousand host ops
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step()
        torch.cuda.synchronize()
    rows, n_aten, n_launch = _profile_rows(prof, 2)
    busy = sum(r[1] for r in rows)
    print(f"{tag} {label}: decode step {wall_ms:.2f} ms wall "
          f"({host_ms:.2f} ms to dispatch), device busy {busy:.2f} ms/step, "
          f"idle share {1 - busy / wall_ms:.3f}; host: {n_aten} aten ops, "
          f"{n_launch} kernel launches per step")
    for key, ms, cnt in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"{tag}   {ms:8.3f} ms/step  x{cnt:<5d} {key[:90]}")
    return dict(wall_ms=wall_ms, host_ms=host_ms, busy_ms=busy,
                aten=n_aten, launches=n_launch)


def _profile_rows(prof, n: int):
    """Device-side events only (kernels, memcpy, memset: an aten op's own
    row repeats the time of the kernels it launched), per step; plus the
    host's aten ops and kernel launches per step."""
    from torch.autograd import DeviceType
    ka = prof.key_averages()
    rows = [(e.key, e.self_device_time_total / 1e3 / n, e.count // n)
            for e in ka if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    n_aten = sum(e.count for e in ka if e.key.startswith("aten::")) // n
    n_launch = sum(e.count for e in ka
                   if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                "cuLaunchKernel", "cuLaunchKernelEx")) // n
    return rows, n_aten, n_launch


def _profile_verify(params) -> None:
    """One verify round of the `full` dense speculative run: 8 slots after
    8 admissions of 1024 tokens, a gamma-4 segment each (random drafts:
    one row commits), `verify_step` as the loop dispatches it."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.granite_8b import CONFIG
    from repro_torch.core import cache as kvcache
    from repro_torch.core.policy import presets
    from repro_torch.nn import model as M
    from repro_torch.serving.engine import Engine
    cfg = CONFIG
    eng = Engine(cfg, params, presets(budget=BUDGET, window=WINDOW)["full"],
                 prompt_len=max(BUCKETS), max_new=MAX_NEW, slots=SLOTS,
                 buckets=BUCKETS, speculative=True, gamma=GAMMA,
                 draft_policy="same")
    rng = np.random.default_rng(4)
    cache = M.init_cache(cfg, eng.spec, SLOTS, max(BUCKETS) + MAX_NEW,
                         layer_budgets=eng.layer_budgets, device="cuda")
    for s in range(SLOTS):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                            (1, BUCKETS[0])), device="cuda")
        _, pc = M.prefill(params, cfg, {"tokens": toks}, eng.spec,
                          layer_budgets=eng.layer_budgets)
        kvcache.insert_request(cache.attn, s, pc.attn, batch_axis=2)
    seg = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                       (SLOTS, GAMMA + 1)), device="cuda")
    valid = torch.full((SLOTS,), GAMMA + 1, dtype=torch.int32, device="cuda")

    def step():
        return eng._verify(cache, seg, valid, [False] * (GAMMA + 1))

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    n = 4
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    # one profiled round: ~45 thousand host ops, whose trace alone takes
    # the profiler tens of seconds to fold per round
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    rows, n_aten, n_launch = _profile_rows(prof, 1)
    busy = sum(r[1] for r in rows)
    print(f"[profile] full spec verify round (L {GAMMA + 1}): "
          f"{wall_ms:.2f} ms wall ({host_ms:.2f} ms to dispatch), device "
          f"busy {busy:.2f} ms/round, idle share {1 - busy / wall_ms:.3f}; "
          f"host: {n_aten} aten ops, {n_launch} kernel launches per round")
    b5 = [r for r in rows if "flash_verify" in r[0]]
    copies = [r for r in rows if any(w in r[0].lower() for w in
                                     ("copy", "memcpy", "cat"))]
    print(f"[profile]   B5: {sum(r[1] for r in b5):.3f} ms/round x"
          f"{sum(r[2] for r in b5)}; copy / cat kernels (materialize_kv "
          f"and the rest): {sum(r[1] for r in copies):.3f} ms/round x"
          f"{sum(r[2] for r in copies)}")
    for key, ms, cnt in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"[profile]   {ms:8.3f} ms/round  x{cnt:<5d} {key[:90]}")
    del eng, cache
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 7. configs: the further configs at full width
# ---------------------------------------------------------------------------

# layers served where the config's weights leave no room for a pool on
# one card (bf16 by param_count: command-r-plus-104b 193.4 GiB at 64
# layers, 52.7 GiB at 16, 29.3 at 8; mixtral-8x22b 261.9 GiB at 56, 38.1
# at 8, 56.7 at 12; kimi-k2-1t-a32b 1.9 TiB at 61, 36.1 GiB at 1, 67.9 at
# 2, which leaves too little for the transients; jamba-v0.1-52b 95.85 GiB
# at 32 layers, 48.43 at 16 = two of its four 8-layer superblocks, 72.14
# at 24, which leaves no room for admission transients), or where the
# script's time asks for it: once jamba and mamba2 joined, the whole run
# read 759 s on a slow host, so command-r-plus-104b went from 16 layers to
# 8 and chameleon-34b (63.88 GiB at 48) to 24 (32.94 GiB); every other
# config serves at its full depth
CONFIG_DEPTH = {"command-r-plus-104b": 8, "chameleon-34b": 24,
                "mixtral-8x22b": 8, "kimi-k2-1t-a32b": 1,
                "jamba-v0.1-52b": 16}
# prompt buckets where they differ from BUCKETS: mixtral's prompts
# alternate 2048 / 6144, so half of them cross its 4096-token window in
# prefill and go on crossing it in decode
CONFIG_BUCKETS = {"mixtral-8x22b": (2048, 6144)}
# per config, its runs over the serve phase's one-wave traffic (N_SHORT
# requests, prompts alternating 1024 / 2048, MAX_NEW new, SLOTS slots,
# budget 512, window 128, 512-token segments): (policy, paged + chunked?,
# speculative drafter or None). Each new head group meets every kernel
# that serves it: minicpm Gq 1 / D 64 (B2, B1 dense and with mass), qwen
# Gq 5 (B4, B3 2-bit, B6; through the serve CLI), chameleon Gq 8 (B4, B3;
# the vlm config through chunked admission), command-r Gq 12 (B2, B1, and
# B5 whose 60 packed rows take two row tiles), mixtral Gq 6 with its
# window (B2 at T 6144, B1 with the window's bias; kivi2 paged: B3 2-bit,
# B6, B2 through monolithic admission, as chunked prefill refuses
# experts), kimi Gq 8 with 384 experts (B1 dense and with mass). A paged
# run of an MoE config admits monolithically (`_paged_kw`). Speculative
# decoding refuses experts as the JAX engine does (its gate is the
# chunking gate), so no MoE run verifies: B5 meets Gq 6 and the window
# in phase 3. jamba (the hybrid: 1 attention + 7 Mamba-2 layers a
# superblock of 8, MoE every second layer) runs B1 / B3 / B2 / B6 at Gq 4,
# D 128 (granite's group) on its 2 attention layers of 16; chunked
# prefill and speculation refuse its SSM layers, so its paged run admits
# monolithically too.
CONFIG_RUNS = (
    ("minicpm-2b", (("full", False, None), ("h2o", False, None))),
    ("qwen2.5-32b", (("kivi2", True, None),)),
    ("chameleon-34b", (("full", True, None),)),
    ("command-r-plus-104b", (("full", False, None), ("full", False, "same"))),
    ("mixtral-8x22b", (("full", False, None), ("kivi2", True, None))),
    ("kimi-k2-1t-a32b", (("full", False, None), ("h2o", False, None))),
    ("jamba-v0.1-52b", (("full", False, None), ("kivi2", True, None))),
)
# configs whose decode step is profiled (wall against device-busy time)
CONFIG_PROFILE = ("qwen2.5-32b", "mixtral-8x22b", "kimi-k2-1t-a32b",
                  "jamba-v0.1-52b")
# the MoE FFN at full width against its f32 oracle: MOE_TOKENS tokens of
# one layer at drop-free capacity, in bf16, within |y - ref| <= atol +
# rtol * |ref| (two bf16 products with f32 accumulation, each rounded,
# against the f32 oracle on the same bf16 inputs)
MOE_TOKENS = 64
MOE_TOL = (2e-2, 2e-2)
# the qwen run goes through the serving CLI, as a user starts it
QWEN_ARGV = ("--arch", "qwen2.5-32b", "--policy", "kivi2", "--budget",
             str(BUDGET), "--window", str(WINDOW), "--requests",
             str(N_SHORT), "--buckets", ",".join(map(str, BUCKETS)),
             "--max-new", str(MAX_NEW), "--slots", str(SLOTS),
             "--continuous", "--paged", "--chunked-prefill", "--chunk-len",
             str(CHUNK_LEN))


def _layers_view(params, n: int) -> dict:
    """The first `n` layers of a parameter tree (views, no copy): whole
    superblocks, over every ``sub{i}``."""
    sb = len(params["blocks"])
    assert n % sb == 0, (n, sb)

    def head(tree):
        return ({k: head(v) for k, v in tree.items()}
                if isinstance(tree, dict) else tree[:n // sb])
    return dict(params, blocks=head(params["blocks"]))


def _e2e_layers(cfg) -> int:
    """The e2e depth: E2E_LAYERS, at least one superblock (jamba's 8),
    no deeper than the served cut."""
    from repro_torch.nn import model as M
    return min(max(E2E_LAYERS, M.sb_layout(cfg)[0]), cfg.num_layers)


def _n_moe(cfg) -> int:
    return sum(cfg.ffn_kind(i) == "moe" for i in range(cfg.num_layers))


def _first_moe(params) -> dict:
    """The first layer's MoE FFN leaves (the first sublayer with one)."""
    sub = next(v for _, v in sorted(params["blocks"].items())
               if "moe" in v)
    return {k: v[0] for k, v in sub["moe"].items()}


def phase_configs(info: dict) -> None:
    """minicpm-2b and qwen2.5-32b at full width and depth, chameleon-34b,
    command-r-plus-104b, mixtral-8x22b, kimi-k2-1t-a32b and jamba-v0.1-52b
    at full width on the CONFIG_DEPTH cuts, random bf16 weights from seed 0, one config
    on the card at a time: every run of CONFIG_RUNS completes all its
    requests with launches exactly as its own step counts predict
    (speculative: its stream agreement with the plain run printed; MoE:
    each layer's drop fraction at decode printed); an MoE config's FFN
    held to its f32 oracle (`_moe_oracle`); the CONFIG_PROFILE configs'
    decode step profiled (wall against device-busy time); then each
    config at E2E_LAYERS depth (or its cut), its logits with the kernels
    against use_kernels=False for each of its policies, dense and paged,
    within E2E_LOGIT_TOL (MoE: with the routing and the KIVI codes pinned
    to the reference's, `_kernels_vs_reference`); the hybrid's host tier
    at that depth (`_hybrid_tier`). Then mamba2-130m at full size through
    the model-level prefill and decode (`_mamba2`)."""
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    launches = info.setdefault("launches", dict.fromkeys(KERNELS, 0))
    kernels = _kernel_objs()
    for arch, runs in CONFIG_RUNS:
        cfg = get_config(arch)
        if arch in CONFIG_DEPTH:
            cfg = cfg.replace(num_layers=CONFIG_DEPTH[arch])
        w_gib = cfg.param_count() * 2 / 2**30
        ssm = (f"; Mamba-2 d_inner {cfg.d_inner} heads {cfg.ssm_heads} x "
               f"{cfg.ssm.head_dim} d_state {cfg.ssm.d_state}, attention "
               f"layers {cfg.num_attn_layers()} of {cfg.num_layers}"
               if cfg.attn_layer_period else "")
        print(f"[configs] {arch}: {cfg.num_layers}"
              f"{'' if arch not in CONFIG_DEPTH else ' (cut)'} layers "
              f"d_model {cfg.d_model} heads {cfg.num_heads}/"
              f"{cfg.num_kv_heads} (Gq {cfg.num_heads // cfg.num_kv_heads}) "
              f"D {cfg.head_dim} d_ff {cfg.d_ff} vocab {cfg.vocab_size} "
              f"qkv_bias {cfg.qkv_bias} tied {cfg.tie_embeddings} "
              f"rope_theta {cfg.rope_theta:g} arch_type {cfg.arch_type}"
              f"{ssm}; {w_gib:.2f} GiB of bf16 weights")
        buckets = CONFIG_BUCKETS.get(arch, BUCKETS)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, size=buckets[i % 2])
                   for i in range(N_SHORT)]
        params, plain = None, {}
        for pname, paged, draft in runs:
            params = _config_run(info, cfg, params, pname, paged, draft,
                                 prompts, kernels, launches, plain, w_gib,
                                 buckets)
        if cfg.is_moe:
            _moe_oracle(info, cfg, params)
        if arch in CONFIG_PROFILE:
            _profile_config_step(info, cfg, params, buckets)
        # the e2e's first layers, copied so that the served weights go
        # before its f32 witness is cast (a cut no deeper than the e2e
        # serves them as they are)
        if cfg.num_layers > _e2e_layers(cfg):
            params = _tree(torch.clone,
                           _layers_view(params, _e2e_layers(cfg)))
        torch.cuda.empty_cache()
        _config_e2e(info, cfg, params, sorted({p for p, _, _ in runs}),
                    buckets)
        if cfg.attn_layer_period:
            _hybrid_tier(info, cfg.replace(num_layers=_e2e_layers(cfg)),
                         params, prompts)
        del params, plain
        torch.cuda.empty_cache()
    _mamba2(info)


@contextlib.contextmanager
def _moe_drops():
    """Record each `moe_apply` call's drop fraction (a device scalar, read
    after the run) while the context is open, decode calls (one row a
    slot) apart from prefill ones."""
    from repro_torch.nn import moe as moe_lib
    apply, rec = moe_lib.moe_apply, {"decode": [], "prefill": []}

    def counted(p, x, **kw):
        y, aux = apply(p, x, **kw)
        rec["decode" if x.shape[1] == 1 else "prefill"].append(
            aux.drop_fraction)
        return y, aux

    moe_lib.moe_apply = counted
    try:
        yield rec
    finally:
        moe_lib.moe_apply = apply


def _config_run(info, cfg, params, pname, paged, draft, prompts, kernels,
                launches, plain, w_gib, buckets):
    """One serve run of `cfg` (the qwen one through the serving CLI, which
    draws its own weights and requests: its engine's parameters serve the
    config's later steps). Returns the parameters."""
    import json
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core.policy import presets
    from repro_torch.launch import serve
    from repro_torch.nn import model as M
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request
    L = cfg.num_layers
    n_attn, n_moe = cfg.num_attn_layers(), _n_moe(cfg)
    cli = cfg.name == "qwen2.5-32b"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    t1 = time.perf_counter()
    if cli:
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "metrics.json")
            eng, res = serve.main(list(QWEN_ARGV) + ["--metrics-json",
                                                     path])
            with open(path) as f:
                snap = json.load(f)["metrics"]
        params = eng.params
    else:
        if params is None:
            params = M.init_params(cfg, seed=0, device="cuda")
        spec_kw = (dict(speculative=True, gamma=GAMMA, draft_policy=draft)
                   if draft else {})
        eng = Engine(cfg, params, presets(budget=BUDGET, window=WINDOW)[
                         pname], prompt_len=max(buckets), max_new=MAX_NEW,
                     slots=SLOTS, buckets=buckets,
                     **(_paged_kw(cfg) if paged else {}), **spec_kw)
        t1 = time.perf_counter()
        with (_moe_drops() if cfg.is_moe
              else contextlib.nullcontext()) as drops:
            res = eng.generate_continuous([Request(tokens=p, max_new=MAX_NEW)
                                           for p in prompts])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    n = {name: k.launches for name, k in kernels.items()}
    for name in KERNELS:
        launches[name] += n[name]
    label = (f"{cfg.name} {pname}"
             + ((" paged" if cfg.is_moe else " paged+chunked") if paged
                else "")
             + (f" spec[{draft}]" if draft else "")
             + (" (serve CLI)" if cli else ""))
    done = [r for r in res.results if r.finish_reason == "length"]
    toks = np.concatenate([r.tokens for r in res.results])
    lens = ([r.prompt_len for r in res.results] if cli
            else [len(p) for p in prompts])
    segments = sum(-(-n_ // CHUNK_LEN) for n_ in lens)
    print(f"[configs] {label}: {len(done)}/{N_SHORT} requests completed, "
          f"prefill {res.prefill_seconds:.3f} s, decode "
          f"{res.decode_tokens_per_s:.1f} tok/s over {res.decode_steps} "
          f"steps, ttft mean {res.ttft_mean_s:.3f} s, wall {wall:.2f} s"
          f"{' (the CLI draws its weights inside it)' if cli else ''}; "
          f"peak allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB (weights {w_gib:.2f} GiB by param_count), cache "
          f"{res.cache_physical_bytes / 2**20:.1f} MiB physical"
          + (f", pool peak {res.pool_peak_blocks}/{res.pool_blocks} blocks "
             f"of {eng.block_len} rows, audit clean="
             f"{eng.last_audit['clean']}" if paged else "")
          + "; launches " + " ".join(f"{k} {v}" for k, v in n.items())
          + f"; {info['smi']}")
    row = dict(label=label, layers=L, attn_layers=n_attn, completed=len(done),
               tok_s=res.decode_tokens_per_s, ttft=res.ttft_mean_s,
               prefill_s=res.prefill_seconds, wall=wall,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               weights_gib=w_gib, cache_mib=res.cache_physical_bytes / 2**20,
               launches=n)
    if cli:
        got = {k: snap.get(k) for k in ("requests.completed",
                                        "engine.decode_steps")}
        want = {"requests.completed": N_SHORT,
                "engine.decode_steps": res.decode_steps}
        print(f"[configs]   metrics snapshot: {got}, decode "
              f"{snap.get('run.decode_tok_s', 0):.1f} tok/s, ttft mean "
              f"{snap.get('run.ttft_mean_s', 0):.3f} s, cache "
              f"{snap.get('cache.physical_bytes', 0) / 2**20:.1f} MiB")
        if got != want:
            fail(f"{label}: metrics snapshot {got}, want {want}")
    elif any(r.n_tokens != MAX_NEW for r in done):
        fail(f"{label}: a request stopped short of {MAX_NEW} tokens")
    if len(done) != N_SHORT:
        fail(f"{label}: only {len(done)} of {N_SHORT} requests completed")
    if toks.min() < 0 or toks.max() >= cfg.vocab_size:
        fail(f"{label}: token ids out of range")
    if paged and not (eng.last_audit["clean"]
                      and res.pool_peak_blocks <= res.pool_blocks):
        fail(f"{label}: pool audit {eng.last_audit}")
    want = _want_launches(eng, res, n_attn, N_SHORT, segments)
    if n != want:
        fail(f"{label}: kernel launches {n}, want {want} "
             f"({res.decode_steps} decode steps, {res.kv_flush_steps} flush "
             f"steps, {n_attn} attention layers of {L}"
             f"{'; ' + res.spec.describe() if res.spec else ''})")
    if cfg.is_moe:
        dec = torch.stack(drops["decode"]).view(-1, n_moe).mean(0).tolist()
        pre = torch.stack(drops["prefill"]).view(-1, n_moe).mean(0).tolist()
        print(f"[configs]   {label}: MoE drop fraction a layer at decode "
              f"(capacity {cfg.moe.capacity_factor}, {SLOTS} slots x top "
              f"{cfg.moe.num_experts_per_tok} over "
              f"{cfg.moe.num_experts} experts: "
              f"{_moe_cap(cfg, SLOTS)} rows an expert), mean over "
              f"{len(drops['decode']) // n_moe} steps: "
              + " ".join(f"{x:.4f}" for x in dec)
              + "; at admission: " + " ".join(f"{x:.4f}" for x in pre)
              + " (printed, not gated)")
        row.update(drop_decode=dec, drop_prefill=pre)
    if draft is None:
        plain[(pname, paged)] = res
    else:
        st, base = res.spec, plain[(pname, paged)]
        same, tok, ntok = _agreement(res, base)
        print(f"[configs]   {st.describe()}; {st.verify_rounds} verify + "
              f"{st.plain_rounds} plain rounds; tok/s "
              f"{res.decode_tokens_per_s:.1f} vs plain "
              f"{base.decode_tokens_per_s:.1f}; bf16 streams equal to "
              f"plain: {same}/{N_SHORT} requests, {tok}/{ntok} tokens "
              "(reported, not gated)")
        row.update(acceptance=st.acceptance_rate, streams_equal=same,
                   tokens_equal=tok, tokens=ntok)
        if st.verify_rounds == 0:
            fail(f"{label}: no verify round ran")
    info.setdefault("config_serve", []).append(row)
    del eng, res
    torch.cuda.empty_cache()
    return params


def _moe_cap(cfg, n_tokens: int) -> int:
    from repro_torch.nn import moe as moe_lib
    return moe_lib.capacity(n_tokens, cfg.moe.num_experts_per_tok,
                            cfg.moe.num_experts, cfg.moe.capacity_factor)


def _moe_dense_by_expert(p, x, top_k: int):
    """`moe_apply_dense` one expert at a time: the soft-dispatch oracle in
    f32 without casting every expert at once (kimi's 384 would take 63
    GiB in f32)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.nn import moe as moe_lib
    E = p["router"].shape[1]
    _, _, top_vals, top_idx = moe_lib._route(p, x, top_k)
    combine = torch.sum(F.one_hot(top_idx, E).float() * top_vals[..., None],
                        dim=2)                            # [B, T, E]
    xf = x.float()
    y = torch.zeros(xf.shape, dtype=torch.float32, device=x.device)
    for e in range(E):
        h = (F.silu(xf @ p["gate"][e].float()) * (xf @ p["up"][e].float())
             * combine[..., e, None])
        y += h @ p["down"][e].float()
    return y


def _moe_oracle(info, cfg, params) -> None:
    """The MoE FFN of the first served layer at full width: MOE_TOKENS
    random bf16 tokens through `moe_apply` at drop-free capacity against
    the f32 soft-dispatch oracle (`moe_apply_dense`, and one expert at a
    time, which must agree with it where both fit), within MOE_TOL; then
    at the config's capacity the drop fraction must be the host's count
    from the same routing."""
    import numpy as np
    import torch
    from repro_torch.nn import moe as moe_lib
    p = _first_moe(params)
    E, k = cfg.moe.num_experts, cfg.moe.num_experts_per_tok
    g = torch.Generator(device="cuda").manual_seed(MOE_TOKENS)
    x = torch.randn(1, MOE_TOKENS, cfg.d_model, generator=g,
                    device="cuda").to(cfg.dtype)
    y, aux = moe_lib.moe_apply(p, x, top_k=k, capacity_factor=float(E))
    ref = _moe_dense_by_expert(p, x, k)
    f32_gib = 3 * E * cfg.d_model * cfg.moe.d_expert * 4 / 2**30
    line = ""
    if f32_gib < 16:
        dense, _ = moe_lib.moe_apply_dense(p, x.float(), top_k=k)
        d = (dense - ref).abs().max().item()
        line = f"; by expert vs moe_apply_dense {d:.3g}"
        if not d <= 1e-4 + 1e-4 * ref.abs().max().item():
            fail(f"{cfg.name} MoE oracle: by-expert and dense oracles "
                 f"differ by {d:.3g}")
        del dense
    err = check_close(f"{cfg.name} moe_apply bf16 vs f32 oracle", y, ref,
                      *MOE_TOL)
    if aux.drop_fraction.item() != 0.0:
        fail(f"{cfg.name} moe_apply drops at drop-free capacity")
    cf = cfg.moe.capacity_factor
    _, aux = moe_lib.moe_apply(p, x, top_k=k, capacity_factor=cf)
    _, _, _, top_idx = moe_lib._route(p, x, k)
    cap = _moe_cap(cfg, MOE_TOKENS)
    seen = np.zeros(E, np.int64)
    kept = 0
    for e in top_idx.reshape(-1).tolist():      # token-major, as routed
        seen[e] += 1
        kept += seen[e] <= cap
    want = 1.0 - kept / (MOE_TOKENS * k)
    got = aux.drop_fraction.item()
    print(f"[configs] {cfg.name} MoE FFN at full width ({E} experts, top "
          f"{k}, d_model {cfg.d_model}, d_expert {cfg.moe.d_expert}), "
          f"{MOE_TOKENS} tokens: bf16 moe_apply vs f32 oracle max|err| "
          f"{err:.4g} (max|ref| {ref.abs().max().item():.3f}, tol "
          f"{MOE_TOL}){line}; at capacity {cf} ({cap} rows an expert) drop "
          f"fraction {got:.6f}, host count {want:.6f}")
    if abs(got - want) > 1e-6:
        fail(f"{cfg.name} MoE drop fraction {got} != host count {want}")
    info.setdefault("moe_oracle", []).append(dict(
        label=cfg.name, err=err, drop=got, cap=cap))
    del y, ref, x
    torch.cuda.empty_cache()


def _profile_config_step(info, cfg, params, buckets) -> None:
    """One decode step of `cfg` at its served depth under kivi2 on the
    paged pool, 8 slots after 8 admissions of `buckets[0]` tokens
    (chunked; monolithic for experts): wall against device-busy time. For
    an MoE config also the expert products of one decode step alone (the
    three `torch.bmm` over every expert at the step's capacity), beside
    the time to read the experts' weights once."""
    import numpy as np
    import torch
    from repro_torch.core.policy import presets
    from repro_torch.nn import model as M
    from repro_torch.serving.engine import Engine, RingMirror
    eng = Engine(cfg, params, presets(budget=BUDGET, window=WINDOW)["kivi2"],
                 prompt_len=max(buckets), max_new=MAX_NEW, slots=SLOTS,
                 buckets=buckets, **_paged_kw(cfg))
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                                (SLOTS, buckets[0]))
    admit = _admit_paged_mono if cfg.is_moe else _admit_paged_chunked
    cache, _ = admit(eng, prompts)
    ring = RingMirror(eng.spec, SLOTS)
    ring.fill()
    tok = torch.zeros(SLOTS, 1, dtype=torch.long, device="cuda")

    def step():
        return M.decode_step(params, cfg, cache, tok, eng.spec,
                             ring_full=ring.advance())[0]

    row = _profile_decode_step("[configs]", f"{cfg.name} kivi2 paged "
                               f"({cfg.num_layers} layers)", step)
    if cfg.is_moe:
        p = _first_moe(params)
        cap = _moe_cap(cfg, SLOTS)
        g = torch.Generator(device="cuda").manual_seed(cap)
        E, Dm, F_ = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_expert
        buf = torch.randn(E, cap, Dm, generator=g, device="cuda").to(cfg.dtype)
        h = torch.randn(E, cap, F_, generator=g, device="cuda").to(cfg.dtype)

        def experts():
            torch.bmm(buf, p["gate"])
            torch.bmm(buf, p["up"])
            return torch.bmm(h, p["down"])

        # event-timed: three products of milliseconds each hold next to
        # no host time (the profiler's kernel sum read below the bound)
        ms = median_ms(experts)
        b_ms, by = bound(nbytes(p["gate"], p["up"], p["down"]),
                         6.0 * E * cap * Dm * F_, "bfloat16")
        print(f"[configs]   {cfg.name} expert products of one decode step "
              f"({E} experts x {cap} rows, one layer): {ms:.4f} ms, bound "
              f"{b_ms:.4f} ms by {by} ({b_ms / ms:.1%} of it); "
              f"x{_n_moe(cfg)} MoE layers {ms * _n_moe(cfg):.3f} ms of "
              "the step")
        row.update(expert_ms=ms, expert_bound_ms=b_ms)
        del buf, h
    info.setdefault("config_profile", []).append(dict(row, label=cfg.name))
    del eng, cache
    torch.cuda.empty_cache()


def _config_e2e(info, cfg, params4, pnames, buckets) -> None:
    """`cfg` at E2E_LAYERS depth or its cut if shallower (`params4`: its
    served parameters' first layers): kernels against use_kernels=False,
    dense and paged, per policy, within E2E_LOGIT_TOL; the f32 reference
    path on the same weights printed beside them with the logits' scale,
    as phase 5 does, where the f32 copy fits (not for experts: mixtral's
    4 layers are 39 GiB in f32, kimi's one 72 GiB). Prompts are
    `buckets[-1]` long: mixtral's 6144 cross its 4096-token window in both
    paths. The hybrid runs one whole superblock (`_e2e_layers`)."""
    import numpy as np
    import torch
    from repro_torch.core.policy import presets
    n = _e2e_layers(cfg)
    cfg4 = cfg.replace(num_layers=n)
    witness = (None if cfg.is_moe else
               (cfg4.replace(dtype=torch.float32),
                _cast(params4, torch.float32)))
    T = buckets[-1] if cfg.sliding_window else buckets[0]
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(SLOTS, T)), device="cuda")
    for pname in pnames:
        pol = presets(budget=BUDGET, window=WINDOW)[pname]
        for paged in (False, True):
            d = _kernels_vs_reference(cfg4, params4, pol, toks, paged=paged,
                                      witness=witness, buckets=buckets)
            kr = d["kr"]
            label = (f"{cfg.name} {pname}"
                     + ((" paged" if cfg.is_moe else " paged+chunked")
                        if paged else ""))
            f32 = (f"vs f32 reference: kernels {max(d['k32']):.4f}, bf16 "
                   f"reference {max(d['r32']):.4f}" if witness else
                   "no f32 reference (its weights would not fit)")
            if "flips" in d:
                f32 += (f"; routing and KIVI codes pinned to the "
                        f"reference's: the kernel path alone would route "
                        f"{d['flips']} of {d['routed']} tokens to other "
                        f"experts and code {d['code_flips']} of "
                        f"{d['codes']} code bytes otherwise")
            print(f"[configs] e2e {label} ({n} layers, prompts of {T}): "
                  f"max|dlogit| kernels vs reference (bf16) prefill "
                  f"{kr[0]:.4f} decode {max(kr[1:]):.4f} (tol "
                  f"{E2E_LOGIT_TOL}); {f32}; max|logit| {d['scale']:.2f}")
            info.setdefault("config_e2e", []).append(dict(
                label=label, kr=max(kr), k32=max(d.get("k32", [0.0])),
                r32=max(d.get("r32", [0.0])), scale=d["scale"],
                flips=d.get("flips"), code_flips=d.get("code_flips")))
            if not all(math.isfinite(x) and x <= E2E_LOGIT_TOL for x in kr):
                fail(f"e2e {label}: kernels vs reference logits differ by "
                     f"{max(kr):.4f} > {E2E_LOGIT_TOL}")
            torch.cuda.empty_cache()
    del witness
    torch.cuda.empty_cache()


def _hybrid_tier(info, cfg, params, prompts) -> None:
    """The hybrid's host tier at `cfg`'s depth (one superblock), on the
    configs phase's traffic: `full` paged (monolithic admission) with lazy
    growth, preemption and the host-RAM tier on the starving pool of the
    serve phase's overload runs (784 blocks: the same prompts need 776 to
    admit and 800 to finish), against its unpreempted twin at the parity
    pool. Every preemption spills the slot's blocks, metadata and Mamba-2
    state to host and restores them (`_check_tier_run`'s gates: nothing
    recomputed or replayed), the periodic audits are clean, and the bf16
    streams equal the twin's token for token, which they do only if the
    SSM state rides through the spill. Expert capacity couples the slots
    of a decode step and a preemption changes which slots hold requests,
    so both runs route drop-free (capacity = the expert count): what is
    compared is the tier, not the drops."""
    import dataclasses
    import torch
    from repro_torch.core.policy import presets
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import Request
    cfg = cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    pol = presets(budget=BUDGET, window=WINDOW)["full"]
    runs = {}
    for tag, kw in (("twin", {}),
                    ("tier", dict(pool_blocks=784, block_growth="lazy",
                                  preemption=True, tiering=True,
                                  audit_every=OVERLOAD_AUDIT))):
        eng = Engine(cfg, params, pol, prompt_len=max(BUCKETS),
                     max_new=MAX_NEW, slots=SLOTS, buckets=BUCKETS,
                     paged=True, **kw)
        n_audit = _counted_audits(eng)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = eng.generate_continuous([Request(tokens=p, max_new=MAX_NEW)
                                       for p in prompts])
        torch.cuda.synchronize()
        runs[tag] = (eng, res, time.perf_counter() - t1, n_audit)
    eng, res, wall, n_audit = runs["tier"]
    _, base, base_wall, _ = runs["twin"]
    label = (f"{cfg.name} full paged lazy+preemption+tier pool "
             f"{eng.pool_blocks} ({cfg.num_layers} layers, drop-free "
             "experts)")
    n_pre = sum(r.n_preemptions for r in res.results)
    done = [r for r in res.results if r.finish_reason == "length"
            and r.n_tokens == MAX_NEW]
    same = sum(a.tokens.tolist() == b.tokens.tolist()
               for a, b in zip(res.results, base.results))
    print(f"[configs] {label}: {len(done)}/{N_SHORT} requests completed; "
          f"{n_pre} preemptions "
          f"({[r.n_preemptions for r in res.results]} per request), "
          f"{len(res.recomputed_uids)} re-admissions recomputed, "
          f"{res.replayed_tokens} tokens replayed; decode "
          f"{res.decode_tokens_per_s:.1f} tok/s over {res.decode_steps} "
          f"steps vs the twin's {base.decode_tokens_per_s:.1f} over "
          f"{base.decode_steps}; pool peak {res.pool_peak_blocks}/"
          f"{res.pool_blocks}; {n_audit[0]} device-table audits, last clean="
          f"{eng.last_audit['clean']}; bf16 streams equal to the "
          f"unpreempted twin: {same}/{N_SHORT}; wall {wall:.2f} s (twin "
          f"{base_wall:.2f} s)")
    row = dict(label=label, preemptions=n_pre, streams_equal=same,
               tok_s=res.decode_tokens_per_s,
               twin_tok_s=base.decode_tokens_per_s, wall=wall)
    if len(done) != N_SHORT or len(base.results) != N_SHORT:
        fail(f"{label}: only {len(done)} of {N_SHORT} requests completed")
    if n_pre < 1:
        fail(f"{label}: the pool never starved (no preemption)")
    if not (n_audit[0] >= 1 and eng.last_audit["clean"]
            and res.pool_peak_blocks <= res.pool_blocks):
        fail(f"{label}: {n_audit[0]} device-table audits, last "
             f"{eng.last_audit}")
    _check_tier_run(info, label, eng, res, n_pre, row,
                    dict(tok_s=base.decode_tokens_per_s,
                         ttft=base.ttft_mean_s))
    if same != N_SHORT:
        fail(f"{label}: {N_SHORT - same} bf16 streams differ from the "
             "unpreempted twin's")
    info.setdefault("hybrid_tier", []).append(row)
    del runs, eng, res, base
    torch.cuda.empty_cache()


# mamba2-130m at full size (24 layers, d_model 768, 0.24 GiB of bf16
# weights) through the model-level prefill and greedy decode (the engine
# needs an attention layer and refuses it): two batches of MAMBA_BATCH
# prompts, of BUCKETS[0] and BUCKETS[1] tokens, MAX_NEW new tokens each;
# in f32, decode continues prefill within MAMBA_CONT_TOL (the bound of
# tests/test_system.py); `ssd_chunked` at its real shapes (H 24, P 64,
# N 128, chunk 256) over whole and ragged sequences against the
# sequential f32 recurrence within SSD_TOL (tests/test_ssm.py's bound)
MAMBA_BATCH = 4
MAMBA_CONT_TOL = 2e-3
SSD_TOL = (2e-4, 1e-3)
SSD_T = (2048, 2000)


def _ssd_sequential(x, dt, A, B_, C_):
    """The SSD as its recurrence, one step a token, in f32."""
    import torch
    Bsz, T, H, P = x.shape
    rep = H // B_.shape[2]
    Bh = torch.repeat_interleave(B_, rep, dim=2)
    Ch = torch.repeat_interleave(C_, rep, dim=2)
    h = torch.zeros(Bsz, H, P, B_.shape[3], device=x.device)
    ys = torch.empty(Bsz, T, H, P, device=x.device)
    for t in range(T):
        h = (h * torch.exp(dt[:, t] * A)[:, :, None, None]
             + (dt[:, t, :, None] * Bh[:, t])[:, :, None, :]
             * x[:, t, :, :, None])
        ys[:, t] = torch.einsum("bhn,bhpn->bhp", Ch[:, t], h)
    return ys, h


def _mamba2(info) -> None:
    """mamba2-130m at full size on the card, random bf16 weights from seed
    0: `nn.model.prefill` + greedy `decode_step` over two batches (tok/s
    and prefill seconds printed; every token id in range, logits finite);
    no kernel counter moves across these runs (no TPU kernel lies on the
    SSM path). In f32 on the same weights: the logits after decoding
    prompt token T equal the last logits of a T+1 prefill within
    MAMBA_CONT_TOL, and the bf16 logits beside the f32 ones are printed.
    `ssd_chunked` at the config's shapes against `_ssd_sequential`."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core.cache import CacheSpec
    from repro_torch.nn import model as M
    from repro_torch.nn import ssm as ssm_lib
    cfg = get_config("mamba2-130m")
    kernels = _kernel_objs()
    for k in kernels.values():
        k.launches = 0
    # the earlier engines sit in reference cycles (`_counted_audits`
    # wraps a bound method) with jamba's weights: free them first, so
    # the peak below is mamba2's own
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    print(f"[configs] mamba2-130m: {cfg.num_layers} layers d_model "
          f"{cfg.d_model}, Mamba-2 d_inner {cfg.d_inner} heads "
          f"{cfg.ssm_heads} x {cfg.ssm.head_dim} d_state {cfg.ssm.d_state} "
          f"chunk {cfg.ssm.chunk_size}, vocab {cfg.vocab_size} (tied), no "
          f"attention and no FFN; {cfg.param_count() * 2 / 2**30:.2f} GiB "
          "of bf16 weights")
    rows = []
    first = None
    for T in BUCKETS:
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                            (MAMBA_BATCH, T)), device="cuda")
        spec = CacheSpec(budget=T + MAX_NEW)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = M.prefill(params, cfg, {"tokens": toks}, spec)
        tok = torch.argmax(lg, -1)[:, None]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = [tok]
        for _ in range(MAX_NEW - 1):
            lg, cache = M.decode_step(params, cfg, cache, tok, spec)
            tok = torch.argmax(lg, -1)[:, None]
            out.append(tok)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = torch.cat(out, 1)
        tok_s = MAMBA_BATCH * (MAX_NEW - 1) / (t2 - t1)
        print(f"[configs] mamba2-130m bf16: {MAMBA_BATCH} prompts of {T}: "
              f"prefill {t1 - t0:.3f} s, decode {tok_s:.1f} tok/s over "
              f"{MAX_NEW - 1} steps ({(t2 - t1) / (MAX_NEW - 1) * 1e3:.2f} "
              f"ms a step); SSM state {cache.ssm.state.numel() * 4 / 2**20:.1f}"
              f" MiB f32 + conv {cache.ssm.conv.numel() * 2 / 2**20:.2f} MiB"
              f" for the batch, whatever T; {info['smi']}")
        rows.append(dict(T=T, prefill_s=t1 - t0, tok_s=tok_s))
        if not (torch.isfinite(lg).all() and out.min() >= 0
                and out.max() < cfg.vocab_size):
            fail(f"mamba2-130m T {T}: non-finite logits or token ids out "
                 "of range")
        if first is None:
            first = (toks, out)
    peak = torch.cuda.max_memory_allocated() / 2**30
    moved = {n: k.launches for n, k in kernels.items() if k.launches}
    print(f"[configs] mamba2-130m: kernel counters across both batches "
          f"{moved or 'all 0'} (no TPU kernel on the SSM path); peak "
          f"allocated {peak:.2f} GiB")
    if moved:
        fail(f"mamba2-130m launched kernels {moved}")

    # f32: decode continues prefill; bf16 beside f32
    cfg32 = cfg.replace(dtype=torch.float32)
    p32 = _cast(params, torch.float32)
    toks, out = first
    T = toks.shape[1]
    spec = CacheSpec(budget=T + MAX_NEW)
    lg, cache = M.prefill(p32, cfg32, {"tokens": toks[:, :-1]}, spec)
    lg_dec, _ = M.decode_step(p32, cfg32, cache, toks[:, -1:], spec)
    lg_full, _ = M.prefill(p32, cfg32, {"tokens": toks}, spec)
    cont = (lg_dec - lg_full).abs().max().item()
    lg16, c16 = M.prefill(params, cfg, {"tokens": toks}, spec)
    lg32, c32 = lg_full, M.prefill(p32, cfg32, {"tokens": toks}, spec)[1]
    d_pre = (lg16 - lg32).abs().max().item()
    d_dec = []
    for t in range(4):
        tok = out[:, t:t + 1]
        lg16, c16 = M.decode_step(params, cfg, c16, tok, spec)
        lg32, c32 = M.decode_step(p32, cfg32, c32, tok, spec)
        d_dec.append((lg16 - lg32).abs().max().item())
    print(f"[configs] mamba2-130m f32: decode of token {T} after a "
          f"{T - 1}-token prefill vs a {T}-token prefill max|dlogit| "
          f"{cont:.3g} (tol {MAMBA_CONT_TOL}); bf16 vs f32 max|dlogit| "
          f"prefill {d_pre:.4f}, 4 decode steps {max(d_dec):.4f} (max|logit|"
          f" {lg_full.abs().max().item():.2f}; printed, not gated)")
    if not (math.isfinite(cont) and cont <= MAMBA_CONT_TOL):
        fail(f"mamba2-130m: decode does not continue prefill ({cont:.3g})")
    del p32, cache, c16, c32
    torch.cuda.empty_cache()

    # ssd_chunked at the real shapes against the recurrence
    H, P, N = cfg.ssm_heads, cfg.ssm.head_dim, cfg.ssm.d_state
    g = torch.Generator(device="cuda").manual_seed(0)
    errs = []
    for T in SSD_T:
        x = torch.randn(1, T, H, P, generator=g, device="cuda")
        dt = torch.nn.functional.softplus(
            torch.randn(1, T, H, generator=g, device="cuda") - 1)
        A = -torch.exp(torch.randn(H, generator=g, device="cuda") * 0.5)
        B_ = torch.randn(1, T, 1, N, generator=g, device="cuda") * 0.3
        C_ = torch.randn(1, T, 1, N, generator=g, device="cuda") * 0.3
        t0 = time.perf_counter()
        y, fin = ssm_lib.ssd_chunked(x, dt, A, B_, C_,
                                     min(cfg.ssm.chunk_size, T))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ys, hs = _ssd_sequential(x, dt, A, B_, C_)
        e_y = check_close(f"mamba2 ssd_chunked y T {T}", y, ys, *SSD_TOL)
        e_h = check_close(f"mamba2 ssd_chunked state T {T}", fin, hs,
                          *SSD_TOL)
        print(f"[configs] mamba2-130m ssd_chunked H {H} P {P} N {N} chunk "
              f"{min(cfg.ssm.chunk_size, T)} T {T}"
              f"{' (ragged: padded to whole chunks)' if T % 256 else ''}: "
              f"vs the sequential f32 recurrence max|err| y {e_y:.3g}, final"
              f" state {e_h:.3g} (tol {SSD_TOL}); {ms:.2f} ms (first call "
              "included)")
        errs.append(max(e_y, e_h))
    info["mamba2"] = dict(runs=rows, cont=cont, bf16_prefill=d_pre,
                          bf16_decode=max(d_dec), ssd_err=max(errs),
                          peak_gib=peak)
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 8. kvsharer: the layer-sharing runner on granite-8b
# ---------------------------------------------------------------------------

# KVSharer at full width and depth: a quarter of the 36 layers share
# (calibrated on one 1024-token prompt), then a shared prefill of SLOTS
# prompts of 1024 tokens and KVS_STEPS decode steps over an uncompressed
# store with room for them
KVS_SHARE, KVS_STEPS = 9, 32


def phase_kvsharer(info: dict) -> None:
    """`serving/shared_runner.py` on granite-8b: the calibrated map shares
    exactly KVS_SHARE layers, which hold no cache, so the cache is
    (36 - 9) / 36 of `M.prefill`'s cache of the same prompts; B2 launches
    once per unshared layer a prefill, B1 once per layer a decode step (a
    shared layer's decode attention is B1 over its source's cache); logits
    stay finite (read after the timed steps). Then at
    E2E_LAYERS depth with one shared layer, the kernels against
    use_kernels=False, and with an empty map the runner against
    `M.prefill` / `M.decode_step`, within E2E_LOGIT_TOL."""
    import numpy as np
    import torch
    from repro_torch.configs.granite_8b import CONFIG as cfg
    from repro_torch.core import cache as kvcache
    from repro_torch.core import sharing
    from repro_torch.core.cache import CacheSpec
    from repro_torch.nn import model as M
    from repro_torch.serving import shared_runner as SR
    launches = info.setdefault("launches", dict.fromkeys(KERNELS, 0))
    kernels = _kernel_objs()
    params = M.init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(3)
    T = BUCKETS[0]
    calib = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, T)),
                            device="cuda")
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (SLOTS, T)),
                           device="cuda")
    spec = CacheSpec(budget=T + KVS_STEPS)
    L = cfg.num_layers

    def counted(fn):
        return _counted(fn, kernels, launches)

    mapping, n_cal, t_cal = counted(
        lambda: SR.calibrate_sharing(params, cfg, calib, KVS_SHARE))
    torch.cuda.reset_peak_memory_stats()
    (lg, caches), n_pre, t_pre = counted(
        lambda: SR.shared_prefill(params, cfg, {"tokens": toks}, spec,
                                  mapping))
    logits = [lg]

    def decode():
        nonlocal lg, caches
        for _ in range(KVS_STEPS):
            tok = torch.argmax(lg, -1)[:, None]
            lg, caches = SR.shared_decode_step(params, cfg, caches, tok,
                                               spec, mapping)
            logits.append(lg)

    _, n_dec, t_dec = counted(decode)
    finite = all(bool(torch.isfinite(x).all()) for x in logits)
    per_layer = [kvcache.cache_physical_bytes(c) for c in caches
                 if c is not None]
    kept = sum(per_layer)
    n_none = sum(c is None for c in caches)
    del logits
    # the unshared cache: the model's own prefill of the same prompts at
    # the same spec (its launches are not the runner's: not counted)
    _, ref_cache = M.prefill(params, cfg, {"tokens": toks}, spec)
    unshared = kvcache.cache_physical_bytes(ref_cache.attn)
    del ref_cache
    print(f"[kvsharer] {cfg.name} ({L} layers, full width): map {mapping} "
          f"from one {T}-token prompt ({t_cal:.2f} s, launches "
          f"flash_prefill {n_cal['flash_prefill']}); shared prefill of "
          f"{SLOTS} x {T} tokens {t_pre:.3f} s, {KVS_STEPS} decode steps "
          f"{t_dec:.3f} s ({SLOTS * KVS_STEPS / t_dec:.1f} tok/s); {n_none} "
          f"layers hold no cache, cache {kept / 2**20:.1f} of "
          f"{unshared / 2**20:.1f} MiB in M.prefill's cache of the same "
          f"prompts ({kept / unshared:.4f}; "
          f"sharing.shared_bytes_fraction "
          f"{sharing.shared_bytes_fraction(mapping, L):.4f}); peak "
          f"allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches prefill {n_pre['flash_prefill']} B2, decode "
          f"{n_dec['decode_attn']} B1; logits finite {finite} (read "
          f"after the timed steps); "
          f"{info['smi']}")
    info["kvsharer"] = dict(mapping=mapping, kept=kept, unshared=unshared,
                            prefill_s=t_pre, decode_s=t_dec,
                            tok_s=SLOTS * KVS_STEPS / t_dec)
    want_pre = dict.fromkeys(KERNELS, 0)
    want_pre["flash_prefill"] = L - KVS_SHARE
    want_dec = dict.fromkeys(KERNELS, 0)
    want_dec["decode_attn"] = L * KVS_STEPS
    want_cal = dict.fromkeys(KERNELS, 0)
    want_cal["flash_prefill"] = L
    if len(mapping) != KVS_SHARE or n_none != KVS_SHARE:
        fail(f"kvsharer: {len(mapping)} shared layers in the map, "
             f"{n_none} without a cache; want {KVS_SHARE}")
    if kept * L != unshared * (L - KVS_SHARE) or len(set(per_layer)) != 1:
        fail(f"kvsharer: cache {kept} bytes, want {L - KVS_SHARE}/{L} of "
             f"{unshared}")
    for what, got, want in (("calibration", n_cal, want_cal),
                            ("prefill", n_pre, want_pre),
                            ("decode", n_dec, want_dec)):
        if got != want:
            fail(f"kvsharer {what}: kernel launches {got}, want {want}")
    if not finite:
        fail("kvsharer: non-finite logits")
    del caches, lg
    torch.cuda.empty_cache()
    _kvsharer_e2e(cfg, params, calib, toks)
    del params
    torch.cuda.empty_cache()


def _kvsharer_e2e(cfg, params, calib, toks) -> None:
    """The runner at E2E_LAYERS depth (granite's first layers): with one
    shared layer, kernels against use_kernels=False; with an empty map,
    the runner against `M.prefill` / `M.decode_step` (kernels on both);
    prefill and E2E_STEPS decode steps fed the reference's greedy tokens,
    within E2E_LOGIT_TOL."""
    import torch
    from repro_torch.core.cache import CacheSpec
    from repro_torch.nn import model as M
    from repro_torch.serving import shared_runner as SR
    cfg4 = cfg.replace(num_layers=E2E_LAYERS)
    params4 = _layers_view(params, E2E_LAYERS)
    spec = CacheSpec(budget=toks.shape[1] + E2E_STEPS)
    mapping = SR.calibrate_sharing(params4, cfg4, calib, 1)
    cfg_ref = cfg4.replace(use_kernels=False)

    def runner(c, m):
        lg, caches = SR.shared_prefill(params4, c, {"tokens": toks}, spec, m)
        state = [caches]

        def step(tok):
            out, state[0] = SR.shared_decode_step(params4, c, state[0], tok,
                                                  spec, m)
            return out
        return lg, step

    def model(c):
        lg, cache = M.prefill(params4, c, {"tokens": toks}, spec)
        return lg, lambda tok: M.decode_step(params4, c, cache, tok, spec)[0]

    for label, a, b in (
            (f"map {mapping}: kernels vs use_kernels=False",
             runner(cfg4, mapping), runner(cfg_ref, mapping)),
            ("empty map: runner vs M.prefill / M.decode_step",
             runner(cfg4, {}), model(cfg4))):
        logits = [[a[0]], [b[0]]]
        for _ in range(E2E_STEPS):
            tok = torch.argmax(logits[1][-1], -1)[:, None]
            logits[0].append(a[1](tok))
            logits[1].append(b[1](tok))
        torch.cuda.synchronize()
        d = [(x - y).abs().max().item() for x, y in zip(*logits)]
        print(f"[kvsharer] e2e {E2E_LAYERS} layers, {label}: max|dlogit| "
              f"prefill {d[0]:.4f} decode {max(d[1:]):.4f} (tol "
              f"{E2E_LOGIT_TOL})")
        if not all(math.isfinite(x) and x <= E2E_LOGIT_TOL for x in d):
            fail(f"kvsharer e2e {label}: logits differ by {max(d):.4f} > "
                 f"{E2E_LOGIT_TOL}")
        del logits, a, b
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 9. encdec: seamless-m4t-large-v2 at full size through the wave path
# ---------------------------------------------------------------------------

# the wave path's traffic: N_REQUESTS prompts of BUCKETS[0] tokens, each
# with BUCKETS[0] // 4 source frames (the JAX engine's default length;
# seeded standard normal: the stubbed speech frontend's output), MAX_NEW
# new tokens, waves of SLOTS; `full` and `h2o` through `Engine.generate`,
# kivi2 through the serving CLI (the same draws: prompts, then frames)
ENCDEC_ARCH = "seamless-m4t-large-v2"
ENCDEC_POLICIES = ("full", "h2o")
ENCDEC_CLI = ("--arch", ENCDEC_ARCH, "--policy", "kivi2", "--budget",
              str(BUDGET), "--window", str(WINDOW), "--requests",
              str(N_REQUESTS), "--prompt-len", str(BUCKETS[0]), "--max-new",
              str(MAX_NEW), "--slots", str(SLOTS))
# decode continuing the training forward in f32 (the JAX invariant of
# tests/test_system.py:test_decode_matches_forward): prompt rows, then
# ENCDEC_CONT_NEW tokens fed one at a time
ENCDEC_CONT_T, ENCDEC_CONT_NEW, ENCDEC_CONT_TOL = 256, 8, 2e-3


def _named_leaves(tree, path: str = ""):
    for k, v in tree.items():
        yield from (_named_leaves(v, f"{path}/{k}") if isinstance(v, dict)
                    else ((f"{path}/{k}", v),))


def _encdec_view(params, n: int) -> dict:
    """The first `n` decoder and `n` encoder layers (views, no copy)."""
    out = _layers_view(params, n)
    out["enc_blocks"] = _tree(lambda t: t[:n], params["enc_blocks"])
    return out


def _want_wave(eng, n_waves: int, n_layers: int) -> dict:
    """A wave run's launches from its own counts: B1 once per layer per
    decode step (MAX_NEW - 1 a wave), B2 once per layer per wave prefill
    of a policy that reads no mass, B6 once per layer per wave's
    quantized admission and per flushing decode step (the engine's
    `flush_steps`, counted on the host)."""
    want = dict.fromkeys(KERNELS, 0)
    want["decode_attn"] = n_waves * (MAX_NEW - 1) * n_layers
    if not eng.spec.track_scores():
        want["flash_prefill"] = n_waves * n_layers
    want["kvquant"] = (eng.flush_steps
                       + n_waves * int(eng.spec.quantized)) * n_layers
    return want


def phase_encdec(info: dict) -> None:
    """seamless-m4t-large-v2 at full size (24 encoder + 24 decoder
    layers, 16 heads of 64, vocab 256 206, bf16, random weights from
    seed 0) on the wave path: 16 requests in two waves of 8, each wave's
    prefill encoding its 256 source frames and keeping the cross memory
    (24 x 8 x 256 x 16 x 64 x 2 leaves x 2 B) beside the self-attention
    cache. `full` and `h2o` through `Engine.generate`, kivi2 through
    `launch/serve.py`; launches exact. Then, on a 4 + 4 layer cut at full
    width, the kernels against use_kernels=False and the bf16 paths
    against an f32 reference path (unquantized policies) within
    E2E_LOGIT_TOL, and in f32 the
    decode continuing `train_forward`'s logits within ENCDEC_CONT_TOL."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core.cache import CacheSpec
    from repro_torch.core.policy import presets
    from repro_torch.launch import serve
    from repro_torch.nn import model as M
    from repro_torch.serving.engine import Engine
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(ENCDEC_ARCH)
    L, T = cfg.num_layers, BUCKETS[0]
    kernels = _kernel_objs()
    launches = info.setdefault("launches", dict.fromkeys(KERNELS, 0))
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(params))
    print(f"[encdec] {cfg.name}: {cfg.num_encoder_layers} encoder + {L} "
          f"decoder layers d_model {cfg.d_model} heads {cfg.num_heads}/"
          f"{cfg.num_kv_heads} D {cfg.head_dim} d_ff {cfg.d_ff} vocab "
          f"{cfg.vocab_size} {str(cfg.dtype)[6:]}; {n_par / 1e9:.3f} B "
          f"random parameters ({n_par * 2 / 2**30:.2f} GiB) in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, size=(N_REQUESTS, T))
    src = rng.standard_normal((N_REQUESTS, T // 4, cfg.d_model)
                              ).astype(np.float32)
    n_waves = -(-N_REQUESTS // SLOTS)
    cross = L * SLOTS * (T // 4) * cfg.num_kv_heads * cfg.head_dim * 2 * 2
    runs = [(p, None) for p in ENCDEC_POLICIES] + [("kivi2", ENCDEC_CLI)]
    rows = []
    for pname, argv in runs:
        torch.cuda.reset_peak_memory_stats()
        if argv is None:
            eng = Engine(cfg, params, presets(BUDGET, WINDOW)[pname],
                         prompt_len=T, max_new=MAX_NEW, slots=SLOTS)
            res, n, wall = _counted(
                lambda: eng.generate(prompts, src_embeds=src), kernels,
                launches)
        else:
            (eng, res), n, wall = _counted(lambda: serve.main(list(argv)),
                                           kernels, launches)
        want = _want_wave(eng, n_waves, L)
        ok = (res.tokens.shape == (N_REQUESTS, MAX_NEW)
              and res.tokens.min() >= 0 and res.tokens.max() < cfg.vocab_size)
        label = pname + (" (serving CLI)" if argv else "")
        row = dict(label=label, prefill_s=res.prefill_seconds,
                   tok_s=res.decode_tokens_per_s, wall=wall,
                   peak=torch.cuda.max_memory_allocated(),
                   phys=res.cache_physical_bytes, flush_steps=eng.flush_steps,
                   launches=n)
        rows.append(row)
        print(f"[encdec] {label}: {res.tokens.shape[0] if ok else 0}/"
              f"{N_REQUESTS} requests, {n_waves} waves, prefill "
              f"{res.prefill_seconds:.3f} s, decode "
              f"{res.decode_tokens_per_s:.1f} tok/s, wall {wall:.2f} s"
              f"{' (its weights drawn in it)' if argv else ''}, peak allocated "
              f"{row['peak'] / 2**30:.2f} GiB, cache "
              f"{res.cache_physical_bytes / 2**20:.1f} MiB physical a "
              f"request's share summed (cross memory {cross / 1e6:.1f} MB "
              f"a wave), compression {res.compression_ratio:.2f}x, flush "
              f"steps {eng.flush_steps}; launches "
              + " ".join(f"{k} {v}" for k, v in n.items())
              + f"; {info['smi']}")
        if not ok:
            fail(f"encdec {label}: tokens {res.tokens.shape}, want "
                 f"{(N_REQUESTS, MAX_NEW)} in [0, {cfg.vocab_size})")
        if n != want:
            fail(f"encdec {label}: kernel launches {n}, want {want}")
        del eng, res
    info["encdec"] = rows
    gc.collect()
    torch.cuda.empty_cache()
    _encdec_profile(info, cfg, params, prompts, src)

    # the 4 + 4 layer cut: kernels vs reference, bf16 vs f32
    n = E2E_LAYERS
    cfg4 = cfg.replace(num_layers=n, num_encoder_layers=n)
    params4 = _encdec_view(params, n)
    witness = (cfg4.replace(dtype=torch.float32),
               _cast(params4, torch.float32))
    toks = torch.as_tensor(prompts[:SLOTS], device="cuda")
    src4 = torch.as_tensor(src[:SLOTS], device="cuda")
    for pname in ("full", "h2o", "kivi2"):
        pol = presets(budget=BUDGET, window=WINDOW)[pname]
        d = _kernels_vs_reference(cfg4, params4, pol, toks, paged=False,
                                  witness=witness, buckets=(T,), src=src4)
        kr, k32, r32 = d["kr"], d["k32"], d["r32"]
        print(f"[encdec] e2e {pname} ({n} + {n} layers, prompts of {T}, "
              f"{T // 4} frames): max|dlogit| kernels vs reference (bf16) "
              f"prefill {kr[0]:.4f} decode {max(kr[1:]):.4f}; vs the f32 "
              f"reference: kernels {max(k32):.4f}, bf16 reference "
              f"{max(r32):.4f} (tol {E2E_LOGIT_TOL}); max|logit| "
              f"{d['scale']:.2f}")
        info.setdefault("encdec_e2e", []).append(dict(
            policy=pname, kr=max(kr), k32=max(k32), r32=max(r32)))
        # bf16 against f32 is gated where no 2-bit code can flip between
        # the two (kivi2's codes move a level on a bf16 rounding: phase
        # 7's qwen kivi2 reads ~0.9 on both bf16 paths, so f32 is no
        # witness there; printed)
        gated = kr + ([] if pol.spec.quantized else k32)
        if not all(math.isfinite(x) and x <= E2E_LOGIT_TOL for x in gated):
            fail(f"encdec e2e {pname}: logits differ by "
                 f"{max(gated):.4f} > {E2E_LOGIT_TOL}")
    # f32: decode continuing the training forward (kernels on)
    c32, p32 = witness
    Tc = ENCDEC_CONT_T
    batch = {"tokens": toks[:, :Tc + ENCDEC_CONT_NEW],
             "src_embeds": src4[:, :Tc // 4]}
    with torch.no_grad():
        full, _ = M.train_forward(p32, c32, batch)
    spec = CacheSpec(budget=Tc + ENCDEC_CONT_NEW + 8)
    lg, cache = M.prefill(p32, c32, dict(batch, tokens=toks[:, :Tc]), spec)
    errs = [(lg - full[:, Tc - 1]).abs().max().item()]
    for t in range(Tc, Tc + ENCDEC_CONT_NEW - 1):
        lg, cache = M.decode_step(p32, c32, cache, toks[:, t:t + 1], spec)
        errs.append((lg - full[:, t]).abs().max().item())
    print(f"[encdec] f32 ({n} + {n} layers): prefill of {Tc} + "
          f"{ENCDEC_CONT_NEW - 1} decode steps against train_forward's "
          f"logits: max|dlogit| {max(errs):.3g} (tol {ENCDEC_CONT_TOL})")
    info["encdec_cont"] = max(errs)
    if not all(math.isfinite(e) and e <= ENCDEC_CONT_TOL for e in errs):
        fail(f"encdec: f32 decode leaves train_forward by {max(errs):.3g}")
    del params, params4, witness, full, cache
    gc.collect()
    torch.cuda.empty_cache()


def _encdec_profile(info, cfg, params, prompts, src) -> None:
    """One `full` decode step of a wave (8 slots after a 1024-token
    prefill, as the loop dispatches it) profiled, and the plain
    cross-attention's share: its 24 layers' `_cross_attend` calls alone
    on the step's hidden states (event-timed: host and device)."""
    import torch
    from repro_torch.core.policy import presets
    from repro_torch.nn import blocks as B
    from repro_torch.nn import model as M
    from repro_torch.serving.engine import Engine
    eng = Engine(cfg, params, presets(BUDGET, WINDOW)["full"],
                 prompt_len=BUCKETS[0], max_new=MAX_NEW, slots=SLOTS)
    _, cache = eng._prefill(prompts[:SLOTS], src_embeds=src[:SLOTS])
    tok = torch.zeros((SLOTS, 1), dtype=torch.long, device="cuda")
    prof = _profile_decode_step("[encdec]", "full, wave of 8",
                                lambda: eng._decode(cache, tok, False))
    x = torch.randn(SLOTS, 1, cfg.d_model, device="cuda").to(cfg.dtype)
    layers = [M._layer(params["blocks"]["sub0"], i)
              for i in range(cfg.num_layers)]
    mkv = [(cache.cross_k[i], cache.cross_v[i], cache.cross_bias)
           for i in range(cfg.num_layers)]
    xa = median_ms(lambda: [B._cross_attend(p, x, m, cfg)
                            for p, m in zip(layers, mkv)])
    print(f"[encdec]   plain cross-attention, {cfg.num_layers} layers over "
          f"{src.shape[1]} frames: {xa:.2f} ms a step (event-timed, host "
          f"included) of the step's {prof['wall_ms']:.2f} ms; "
          f"{info['smi']}")
    info["encdec_profile"] = dict(prof, cross_ms=xa)
    del eng, cache


# ---------------------------------------------------------------------------
# 10. train: `launch/train.py` at full size, no kernel
# ---------------------------------------------------------------------------

TRAIN_RUNS = (("seamless-m4t-large-v2", "cosine"), ("minicpm-2b", "wsd"))
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 4, 8, 256
# |first-step loss bf16 - f32| on the 4 + 4 layer cut of seamless, the
# same weights and batch (stated before the first card run; loss ~13)
TRAIN_LOSS_TOL = 0.05


def phase_train(info: dict) -> None:
    """`launch/train.py` on the card at full size, bf16 params and f32
    moments, remat per superblock / encoder layer: TRAIN_STEPS steps of
    TRAIN_BATCH x TRAIN_SEQ tokens, seamless-m4t-large-v2 (cosine) and
    minicpm-2b (WSD). Per step: loss, ce, lr, grad norm, wall, tokens/s,
    peak memory. Gates: finite loss and grad norm, grad norm > 0, every
    weight matrix moved from its seeded init, and no kernel
    launched (training runs plain PyTorch: the kernels have no
    backward). Then the first step's loss in bf16 against f32 on the 4 +
    4 layer cut of seamless, within TRAIN_LOSS_TOL."""
    import gc
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.launch import train as train_cli
    from repro_torch.nn import model as M
    from repro_torch.train import loop as TL
    kernels = _kernel_objs()
    launches = info.setdefault("launches", dict.fromkeys(KERNELS, 0))
    for arch, sched in TRAIN_RUNS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        argv = ["--arch", arch, "--steps", str(TRAIN_STEPS), "--batch",
                str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--schedule",
                sched]
        (state, hist), n, wall = _counted(lambda: train_cli.main(argv),
                                          kernels, launches)
        cfg = get_config(arch)
        for i, h in enumerate(hist):
            print(f"[train] {arch} step {i}: loss {h['loss']:.4f} ce "
                  f"{h['ce_loss']:.4f} lr {h['lr']:.3e} grad norm "
                  f"{h['grad_norm']:.4f} wall {h['wall_s']:.3f} s "
                  f"({TRAIN_BATCH * TRAIN_SEQ / h['wall_s']:.0f} tokens/s), "
                  f"peak allocated {h['max_memory_allocated'] / 2**30:.2f} "
                  f"GiB")
        # the weight matrices (not the norm scales: a bf16 1.0 moves
        # only by an update past half its ulp, 2^-8, and lr is 3e-4)
        fresh = M.init_params(cfg, seed=0, device="cuda")
        mats = [(a, b) for (k, a), (_, b) in zip(_named_leaves(state.params),
                                                 _named_leaves(fresh))
                if "norm" not in k and a.dim() >= 2]
        moved = sum(not torch.equal(a, b) for a, b in mats)
        print(f"[train] {arch}: {cfg.param_count() / 1e9:.3f} B params "
              f"{str(cfg.dtype)[6:]}, remat {cfg.remat}, {TRAIN_STEPS} "
              f"steps in {wall:.1f} s (weights drawn in it), {moved}/"
              f"{len(mats)} matrices moved, launches "
              + " ".join(f"{k} {v}" for k, v in n.items())
              + f"; {info['smi']}")
        info.setdefault("train", []).append(dict(
            arch=arch, steps=hist, wall=wall, moved=moved))
        for i, h in enumerate(hist):
            if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                    and h["grad_norm"] > 0):
                fail(f"train {arch} step {i}: loss {h['loss']}, grad norm "
                     f"{h['grad_norm']}")
        if moved != len(mats):
            fail(f"train {arch}: {len(mats) - moved} matrices never moved")
        if any(n.values()):
            fail(f"train {arch}: kernels launched while training: {n}")
        del state, hist, fresh, mats
    gc.collect()
    torch.cuda.empty_cache()

    # bf16 against f32, first step's loss, 4 + 4 layers of seamless
    cfg = get_config(TRAIN_RUNS[0][0])
    cfg4 = cfg.replace(num_layers=E2E_LAYERS, num_encoder_layers=E2E_LAYERS)
    p16 = M.init_params(cfg4, seed=0, device="cuda")
    b = {k: torch.as_tensor(v, device="cuda") for k, v in
         next(lm_batches(cfg4, TRAIN_BATCH, TRAIN_SEQ, seed=0)).items()}
    with torch.no_grad():
        l16 = TL.loss_fn(p16, cfg4, b)[0].item()
        l32 = TL.loss_fn(_cast(p16, torch.float32),
                         cfg4.replace(dtype=torch.float32), b)[0].item()
    print(f"[train] first-step loss, {E2E_LAYERS} + {E2E_LAYERS} layers of "
          f"{cfg.name}: bf16 {l16:.5f} f32 {l32:.5f}, |d| "
          f"{abs(l16 - l32):.5f} (tol {TRAIN_LOSS_TOL})")
    info["train_loss_d"] = abs(l16 - l32)
    if not abs(l16 - l32) <= TRAIN_LOSS_TOL:
        fail(f"train: bf16 loss {l16} vs f32 {l32}")
    del p16
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 11. shard: the sharded path (DTensor over torch.distributed) on the card
# ---------------------------------------------------------------------------
#
# (a) `launch/train.py --mesh host` as one NCCL rank (mesh 1 x 1) against
#     phase 10's un-meshed minicpm-2b run; (b) two ranks on the one card
#     over gloo (NCCL refuses two ranks on one device), mesh (1, 2), tp 2:
#     granite-8b at full width on 18 of 36 layers through prefill +
#     decode (the kernels on each rank's heads) held to the one-rank run,
#     then mixtral-8x22b's MoE FFN through `moe_apply_expert_parallel`;
#     (c) the
#     production dry run on a fake 256-rank mesh, every arch but
#     paper-llama-7b x the four shapes, run by worker processes started
#     with the script (CPU only, meta tensors), then `perf_moe`.

# |loss| and relative |grad norm| differences per step of the 1 x 1 mesh
# against phase 10 (stated before the first card run; expected 0: the
# mesh runs the same local ops)
SHARD_TRAIN_TOL = (1e-2, 1e-2)
SHARD_ARCH, SHARD_B, SHARD_PROMPT, SHARD_STEPS = "granite-8b", 4, 1024, 16
# (b) runs granite at full width on 18 of its 36 layers: the cut stated
# in PERF.md §6 before the first run, for a (b) over 60 s (PR 25's two
# archive runs took 59.0 and 65.4 s)
SHARD_LAYERS = 18
SHARD_POLICIES = ("full", "h2o+kivi2")
SHARD_DEADLINE = 420          # seconds for the two ranks, both runs
SHARD_DRYRUN_WORKERS = 4
SHARD_DRYRUN_DEADLINE = 900   # seconds after the script starts
_DRYRUN: dict = {}
# functional collectives DTensor may call, by the c10d collective they run
_FUNCOL = {"all_reduce": ("all_reduce",),
           "all_gather": ("all_gather_tensor", "all_gather_single"),
           "reduce_scatter": ("reduce_scatter_tensor", "reduce_scatter_single"),
           "all_to_all": ("all_to_all_single",)}


def start_dryrun() -> None:
    """Start the phase-11 dry-run workers (CPU processes over meta
    tensors: they overlap the card phases). Each runs
    `repro_torch.launch.dryrun` over its share of the archs into a
    temporary directory; `_stop_dryrun` ends them."""
    import atexit
    import tempfile
    from repro_torch.configs.base import ARCH_IDS
    archs = [a for a in ARCH_IDS if a != "paper-llama-7b"]
    out = tempfile.mkdtemp(prefix="dryrun_torch_")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = []
    for i in range(SHARD_DRYRUN_WORKERS):
        mine = archs[i::SHARD_DRYRUN_WORKERS]
        log = open(os.path.join(out, f"worker{i}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             ",".join(mine), "--shape", "all", "--mesh", "single", "--out",
             out], env=env, stdout=log, stderr=subprocess.STDOUT))
    _DRYRUN.update(out=out, procs=procs, t0=time.time(), archs=archs)
    atexit.register(_stop_dryrun)


def _stop_dryrun() -> None:
    for p in _DRYRUN.get("procs", ()):
        if p.poll() is None:
            p.kill()
            p.wait()


def _host_collectives(ops) -> None:
    """Carry the functional collectives of `ops` through host memory: a
    CUDA tensor goes to the CPU, the gloo collective runs there, the
    result comes back to the card. Phase 11 (b) only, for the collectives
    gloo cannot run on CUDA tensors (printed)."""
    import torch
    import torch.distributed._functional_collectives as funcol

    def wrap(fn):
        def call(x, *args, **kwargs):
            if isinstance(x, torch.Tensor) and x.is_cuda:
                y = funcol.wait_tensor(fn(x.cpu(), *args, **kwargs))
                return y.to(x.device)
            return fn(x, *args, **kwargs)
        return call

    for op in ops:
        for name in _FUNCOL[op]:
            if hasattr(funcol, name):
                setattr(funcol, name, wrap(getattr(funcol, name)))


def _shard_probe_rank(rank: int, rdv: str, out: str) -> None:
    """Which functional collectives gloo runs on CUDA tensors (two
    ranks, one card): each op is tried once and its result checked."""
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=2)
    g = dist.group.WORLD
    x = torch.arange(4, device="cuda", dtype=torch.float32) + 10 * rank
    want = {"all_reduce": [10., 12., 14., 16.],
            "all_gather": [0., 1., 2., 3., 10., 11., 12., 13.],
            "reduce_scatter": [[10., 12.], [14., 16.]][rank],
            "all_to_all": [[0., 1., 10., 11.], [2., 3., 12., 13.]][rank]}
    res = {}
    for op, fn in (
            ("all_reduce", lambda: funcol.all_reduce(x, "sum", g)),
            ("all_gather", lambda: funcol.all_gather_tensor(x, 0, g)),
            ("reduce_scatter",
             lambda: funcol.reduce_scatter_tensor(x, "sum", 0, g)),
            ("all_to_all",
             lambda: funcol.all_to_all_single(x, None, None, g))):
        try:
            y = funcol.wait_tensor(fn())
            torch.cuda.synchronize()
            res[op] = y.cpu().tolist() == want[op]
        except Exception as e:  # noqa: BLE001 — recorded: goes by host
            res[op] = repr(e)[:200]
        with open(f"{out}.{rank}", "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def _spawn(target, args_of, n: int, deadline: float, what: str):
    """Start `n` spawned processes target(rank, *args_of(rank)), wait
    until `deadline` (seconds from now), kill any left. Returns their
    exit codes (None: killed at the deadline)."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, *args_of(r)))
             for r in range(n)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline
    for p in procs:
        p.join(timeout=max(end - time.monotonic(), 1))
    codes = [None if p.is_alive() else p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if None in codes:
        print(f"[shard] {what}: ranks still running after {deadline} s "
              f"killed (exit codes {codes})")
    return codes


def _shard_tokens(cfg, seed: int):
    import torch
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size,
                         (SHARD_B, SHARD_PROMPT + SHARD_STEPS),
                         generator=g).to(torch.int32)


def _shard_serve(params, cfg, spec, toks, place):
    """prefill + SHARD_STEPS decode steps (the tokens fed: teacher
    forcing, so both runs see the same inputs); the logits of every
    call on the host, and the final cache."""
    from repro_torch.nn import model as M
    lg, cache = M.prefill(params, cfg,
                          {"tokens": place(toks[:, :SHARD_PROMPT])}, spec)
    out = [lg]
    for t in range(SHARD_PROMPT, SHARD_PROMPT + SHARD_STEPS):
        lg, cache = M.decode_step(params, cfg, cache,
                                  place(toks[:, t:t + 1]), spec)
        out.append(lg)
    return out, cache


def _shard_rank(rank: int, rdv: str, out: str, host_ops) -> None:
    """One of the two phase-11 ranks: granite-8b over the (1, 2) mesh
    under each policy (kernel launches counted around the run), then
    mixtral's expert-parallel MoE FFN; results to `out`.<rank>."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs.base import get_config
    from repro_torch.core.policy import presets
    from repro_torch.launch.dryrun import DeviceCounter
    from repro_torch.nn import model as M
    from repro_torch.nn import sharding as shd
    from repro_torch.nn.moe_ep import moe_apply_expert_parallel
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank,
                            world_size=2)
    _host_collectives(host_ops)
    mesh = init_device_mesh("cuda", (1, 2), mesh_dim_names=("data", "model"))
    kernels = _kernel_objs()
    res = {"runs": {}}
    cfg = get_config(SHARD_ARCH).replace(num_layers=SHARD_LAYERS)
    params = M.init_params(cfg, seed=0, device="cuda")
    dp = shd.distribute_tree(params, shd.param_pspecs(params, cfg, mesh),
                             mesh)
    del params
    torch.cuda.empty_cache()
    toks = _shard_tokens(cfg, 1).cuda()

    def place(t):
        return shd.distribute_leaf(t, (("data",), None), mesh)

    for pname in SHARD_POLICIES:
        spec = presets(budget=BUDGET, window=WINDOW)[pname].spec
        torch.cuda.synchronize()
        for k in kernels.values():
            k.launches = 0
        t1 = time.perf_counter()
        with torch.no_grad():
            logits, cache = _shard_serve(dp, cfg, spec, toks, place)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        n = {name: k.launches for name, k in kernels.items()}
        res["runs"][pname] = dict(
            logits=[lg.full_tensor().float().cpu() for lg in logits],
            slot_pos=cache.attn.slot_pos.to_local().cpu(),
            launches=n, wall=wall,
            peak=torch.cuda.max_memory_allocated())
        del cache, logits
    del dp
    torch.cuda.empty_cache()

    # mixtral-8x22b's MoE FFN, one layer at full width: 4 of 8 experts a
    # rank, drop-free capacity, one all-reduce
    mcfg = get_config("mixtral-8x22b").replace(num_layers=1)
    p = _first_moe(M.init_params(mcfg, seed=0, device="cuda"))
    E, k = mcfg.moe.num_experts, mcfg.moe.num_experts_per_tok
    g = torch.Generator(device="cuda").manual_seed(MOE_TOKENS)
    x = torch.randn(1, MOE_TOKENS, mcfg.d_model, generator=g,
                    device="cuda").to(mcfg.dtype)
    counter = DeviceCounter()
    with counter, torch.no_grad():
        y = moe_apply_expert_parallel(p, x, top_k=k, mesh=mesh,
                                      capacity_factor=float(E))
    torch.cuda.synchronize()
    res["moe"] = dict(
        y=y.float().cpu(),
        colls={c: v["count"] for c, v in counter.collectives.items()},
        ref=_moe_dense_by_expert(p, x, k).cpu() if rank == 0 else None)
    torch.save(res, f"{out}.{rank}")
    dist.destroy_process_group()


def phase_shard(info: dict) -> None:
    """(a) the 1 x 1 NCCL mesh against phase 10, (b) two gloo ranks on the
    card against one rank, (c) the production dry-run grid and
    perf_moe."""
    import gc
    import tempfile
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.core.policy import presets
    from repro_torch.launch import train as train_cli
    from repro_torch.nn import model as M
    kernels = _kernel_objs()
    launches = info.setdefault("launches", dict.fromkeys(KERNELS, 0))
    t_phase = time.perf_counter()

    # (a) --mesh host, one NCCL rank, against phase 10's minicpm-2b
    arch, sched = TRAIN_RUNS[1]
    ref = next(r for r in info["train"] if r["arch"] == arch)["steps"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    argv = ["--arch", arch, "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--schedule", sched,
            "--mesh", "host"]
    (state, hist), n, wall = _counted(lambda: train_cli.main(argv), kernels,
                                      launches)
    del state
    for i, (h, r) in enumerate(zip(hist, ref)):
        dl = abs(h["loss"] - r["loss"])
        dg = abs(h["grad_norm"] - r["grad_norm"]) / max(r["grad_norm"], 1e-9)
        print(f"[shard] {arch} --mesh host (1 x 1, nccl) step {i}: loss "
              f"{h['loss']:.6f} vs {r['loss']:.6f} (|d| {dl:.3g}), grad norm "
              f"{h['grad_norm']:.6f} vs {r['grad_norm']:.6f} (rel {dg:.3g}); "
              f"wall {h['wall_s']:.3f} s vs {r['wall_s']:.3f} s, peak "
              f"{h['max_memory_allocated'] / 2**30:.2f} GiB vs "
              f"{r['max_memory_allocated'] / 2**30:.2f} GiB")
        if not (dl <= SHARD_TRAIN_TOL[0] and dg <= SHARD_TRAIN_TOL[1]):
            fail(f"shard: --mesh host step {i} differs from phase 10: loss "
                 f"{dl}, grad norm {dg} (tol {SHARD_TRAIN_TOL})")
    if len(hist) != len(ref) or any(n.values()):
        fail(f"shard: --mesh host ran {len(hist)} steps, launches {n}")
    info["shard_train"] = [dict(loss=h["loss"], grad_norm=h["grad_norm"],
                                wall=h["wall_s"]) for h in hist]
    gc.collect()
    torch.cuda.empty_cache()

    # (b) two gloo ranks on the card: which collectives gloo runs on CUDA
    tmp = tempfile.mkdtemp(prefix="shard_")
    probe = os.path.join(tmp, "probe")
    codes = _spawn(_shard_probe_rank,
                   lambda r: (os.path.join(tmp, "rdv0"), probe), 2, 90,
                   "gloo probe")
    host_ops = []
    for op in _FUNCOL:
        got = []
        for r in range(2):
            try:
                with open(f"{probe}.{r}") as f:
                    got.append(json.load(f).get(
                        op, f"no answer, probe exit codes {codes}"))
            except OSError:
                got.append(f"no answer, probe exit codes {codes}")
        if not all(v is True for v in got):
            host_ops.append(op)
        print(f"[shard] gloo {op} on CUDA tensors: "
              + ("native" if op not in host_ops else
                 f"through host memory ({got[0]})"))
    info["shard_host_ops"] = host_ops

    # the one-rank reference: the same weights, tokens and policies
    cfg = get_config(SHARD_ARCH).replace(num_layers=SHARD_LAYERS)
    params = M.init_params(cfg, seed=0, device="cuda")
    toks = _shard_tokens(cfg, 1).cuda()
    want = {}
    for pname in SHARD_POLICIES:
        spec = presets(budget=BUDGET, window=WINDOW)[pname].spec
        with torch.no_grad():
            logits, cache = _shard_serve(params, cfg, spec, toks,
                                         lambda t: t)
        want[pname] = [lg.float().cpu() for lg in logits]
        del cache, logits
    del params
    gc.collect()
    torch.cuda.empty_cache()

    out = os.path.join(tmp, "rank")
    t1 = time.perf_counter()
    codes = _spawn(_shard_rank, lambda r: (os.path.join(tmp, "rdv1"), out,
                                           host_ops),
                   2, SHARD_DEADLINE, "tp 2")
    if codes != [0, 0]:
        fail(f"shard: a tp-2 rank failed or hung (exit codes {codes})")
    ranks = [torch.load(f"{out}.{r}", weights_only=False) for r in range(2)]
    print(f"[shard] two ranks (mesh 1 x 2, gloo, one card) done in "
          f"{time.perf_counter() - t1:.1f} s")
    n_layers = cfg.num_layers
    for pname in SHARD_POLICIES:
        spec = presets(budget=BUDGET, window=WINDOW)[pname].spec
        flushes = (sum(1 for t in range(SHARD_STEPS) if t % spec.window == 0)
                   if spec.quantized else 0)
        want_n = dict.fromkeys(KERNELS, 0)
        want_n["decode_attn"] = SHARD_STEPS * n_layers
        if not spec.track_scores():
            want_n["flash_prefill"] = n_layers
        if spec.quantized:
            want_n["kvquant"] = (1 + flushes) * n_layers
        d = max(max((a - b).abs().max().item() for a, b in
                    zip(r["runs"][pname]["logits"], want[pname]))
                for r in ranks)
        same_pos = torch.equal(ranks[0]["runs"][pname]["slot_pos"],
                               ranks[1]["runs"][pname]["slot_pos"])
        for r, rk in enumerate(ranks):
            run = rk["runs"][pname]
            print(f"[shard] {SHARD_ARCH} ({SHARD_LAYERS} layers) tp 2 rank "
                  f"{r} {pname}: prefill "
                  f"{SHARD_B} x {SHARD_PROMPT} + {SHARD_STEPS} decode steps "
                  f"in {run['wall']:.2f} s, peak {run['peak'] / 2**30:.2f} "
                  f"GiB, launches " + " ".join(
                      f"{k} {v}" for k, v in run["launches"].items() if v))
            if run["launches"] != want_n:
                fail(f"shard: rank {r} {pname} launches {run['launches']} "
                     f"!= {want_n}")
            for key in KERNELS:
                launches[key] += run["launches"][key]
        print(f"[shard] {SHARD_ARCH} ({SHARD_LAYERS} layers) tp 2 {pname}: "
              f"max|logit - one rank| "
              f"{d:.4f} over {SHARD_STEPS + 1} calls (tol {E2E_LOGIT_TOL}), "
              f"the ranks' kept positions equal: {same_pos}")
        info.setdefault("shard_tp", []).append(dict(policy=pname, d=d,
                                                    same_pos=same_pos))
        if not (math.isfinite(d) and d <= E2E_LOGIT_TOL and same_pos):
            fail(f"shard: tp 2 {pname} logits differ by {d} or kept "
                 f"positions differ ({same_pos})")
    moe = [rk["moe"] for rk in ranks]
    err = check_close("shard: mixtral expert-parallel MoE vs f32 oracle",
                      moe[0]["y"], moe[0]["ref"], *MOE_TOL)
    same = torch.equal(moe[0]["y"], moe[1]["y"])
    print(f"[shard] mixtral-8x22b MoE FFN expert parallel (4 of 8 experts a "
          f"rank, {MOE_TOKENS} tokens, drop-free): max|err| vs f32 oracle "
          f"{err:.4g} (tol {MOE_TOL}), ranks equal {same}, collectives "
          f"{moe[0]['colls']}")
    if not same or moe[0]["colls"]["all-reduce"] != 1 or sum(
            moe[0]["colls"].values()) != 1:
        fail(f"shard: expert-parallel MoE ranks differ ({same}) or "
             f"collectives {moe[0]['colls']} are not one all-reduce")
    info["shard_moe"] = dict(err=err, colls=moe[0]["colls"])

    # (c) the production dry run (started with the script) and perf_moe
    from repro_torch.launch import perf, perf_moe
    end = _DRYRUN["t0"] + SHARD_DRYRUN_DEADLINE
    for p in _DRYRUN["procs"]:
        try:
            p.wait(timeout=max(end - time.time(), 1))
        except subprocess.TimeoutExpired:
            pass
    _stop_dryrun()
    recs, n_ok, last = [], 0, _DRYRUN["t0"]
    for arch in _DRYRUN["archs"]:
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            path = os.path.join(_DRYRUN["out"],
                                f"{arch}__{shape}__single.json")
            try:
                with open(path) as f:
                    rec = json.load(f)
                last = max(last, os.path.getmtime(path))
            except OSError:
                rec = {"arch": arch, "shape": shape, "status": "missing"}
            recs.append(rec)
            if rec["status"] != "ok":
                print(f"[shard] dry run {arch} {shape}: {rec['status']} "
                      f"{rec.get('error', '')}")
                continue
            n_ok += 1
            t = perf.terms(rec)
            coll = sum(v["bytes_weighted_n"] for v in
                       rec["collectives"].values())
            print(f"[shard] dryrun {arch} {shape} lower {rec['lower_s']} s: "
                  f"dot flops/dev {rec['dot_flops_per_device']:.4g}, "
                  f"collective bytes/dev {coll:.4g}; compute "
                  f"{t['compute_s']:.4g} s memory {t['memory_s']:.4g} s "
                  f"collective {t['collective_s']:.4g} s, {t['dominant']}, "
                  f"useful {t['useful_ratio']:.3f}")
    wall = last - _DRYRUN["t0"]
    print(f"[shard] production dry run (16 x 16 fake ranks, meta tensors): "
          f"{n_ok}/{len(recs)} ok, {SHARD_DRYRUN_WORKERS} worker processes, "
          f"the last record written {wall:.1f} s after the script's start "
          f"(lower_s summed {sum(r.get('lower_s', 0) for r in recs):.1f} s)")
    if n_ok != len(recs):
        fail(f"shard: dry run {n_ok}/{len(recs)} ok")
    res = perf_moe.run()
    for name, (total, coll) in res.items():
        print(f"[shard] perf_moe {name}: collective bytes/dev {total:.4g} "
              f"{coll}")
    ratio = res["dtensor_dispatch"][0] / res["expert_parallel"][0]
    print(f"[shard] perf_moe: DTensor dispatch / expert parallel = "
          f"{ratio:.1f}x; phase 11 took {time.perf_counter() - t_phase:.1f} "
          f"s; {info['smi']}")
    info["shard_dryrun"] = dict(ok=n_ok, n=len(recs), wall=wall, moe=ratio)


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs on the card only")
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        fail("src/repro_torch not found beside chip_smoke.py")
    info: dict = {}
    t0 = time.perf_counter()
    start_dryrun()
    for name in PHASES:
        globals()["phase_" + name](info)
        print(f"[{name}] done at {time.perf_counter() - t0:.1f} s",
              flush=True)
    # launches: the serve phase's counts (set to 0 before each run, read
    # right after it, summed over the runs). The serving path runs B6k's
    # and B6v's bodies only inside the fused kvquant launch: their rows
    # carry its count as `fused_launches` beside their own (0).
    kernels = [dict(info["kernel_rows"][key], launches=info["launches"][key])
               for key in KERNELS]
    for row in kernels:
        if row["name"] in ("kquant_cuda", "vquant_cuda"):
            row["fused_launches"] = info["launches"]["kvquant"]
    print(info["smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
