// Fused dequantize-and-attend decode over [main store | residual ring],
// split along the key axis.
//
// Replaces: src/repro/kernels/decode_qattn/kernel.py:decode_attn_pallas
// (body `_kernel`, `_unpack`), the TPU kernel of the serving decode step
// (entry point `decode_attn_launch`), and
// src/repro/kernels/decode_qattn/kernel.py:decode_attn_paged_pallas, its
// block-table variant over a shared paged pool (`decode_attn_paged_launch`).
//
// The two share one kernel body, templated on how main-store row s of
// sequence b is addressed (`main_row`): the dense store reads row
// b*S + s, the paged store row tbl[b, s/bl]*bl + s%bl of the pool, with
// its K scale from group (s%bl)/G of that block. An unmapped entry (-1)
// is clamped to block 0, as the TPU kernel clamps it, and masked by the
// bias; blocks are never skipped, so a free slot (every key masked)
// still gives the reference's uniform softmax. Everything after the row
// address — the splits, the dequant rounding, the online softmax, the
// combine, the mass — is the same code, so on the same rows the paged
// kernel's output and mass are bit-equal to the dense kernel's.
//
// What bounds it on an H100: bytes. One decode query row per sequence
// meets the whole cache once, so the work is ~2*Gq flops per cache
// element read — far below the ~295 flops/byte the card needs before
// its arithmetic is the limit. The cache is read once per step: packed
// 2/4/8-bit codes plus f32 KIVI scales (bits < 16), or the dense 16-bit
// store, plus the full-precision ring.
//
// Design (split-KV). The logical key axis [main | ring] of S+W keys of
// each (sequence, kv head) is cut into n_split splits of split_len keys
// (the wrapper's `decode_splits`: as many as fill one wave of the card),
// one CTA of 4 warps each, so B*Hkv*n_split CTAs fill the card where B*Hkv
// (64 at granite-8b with 8 slots) left half of it idle. Inside a split,
// 32-key tiles stream through a cp.async ring in shared memory (16-byte
// copies of the raw rows: packed codes or 16-bit elements, plus each
// row's bias and V scale / zero; 3 stages, 2 for a quantized store), so
// the next tiles load while one is computed. Each tile takes three steps
// and two __syncthreads (three with codes to unpack):
//   - a quantized tile is dequantized into f32 work tiles, a thread per
//     (row, 4 elements): codes unpacked after the load, __fmul_rn /
//     __fadd_rn (no FMA contraction, to track the plain version's
//     mul-then-add), rounded through bf16 when the model computes in
//     bf16, exactly like the plain version's
//     `(code*scale + zero).to(compute_dtype)`;
//   - scores: a warp per query head, a lane per key, each lane a whole
//     row's dot product read with 16-byte loads from a padded row stride
//     (conflict-free); the warp's max and sum (shuffles) update that
//     head's online softmax once per tile, not once per key;
//   - O = alpha O + P V: a thread per (query head, 4 elements) walks the
//     tile's keys in order.
// All Gq query heads of the kv head share each tile, so every byte of K/V
// is fetched from device memory once for the GQA group (the point of GQA
// on a memory-bound step). Masking is the additive validity bias with a
// finite -1e30 (an all-empty row then softmaxes uniformly, as the
// reference does, instead of NaN).
//
// Combine, in the same launch and deterministic: the CTA writes its
// (acc[D], m, l) per query head to a caller-allocated f32 scratch, then
// takes a ticket from a per-(b, h) int32 counter (zero between launches;
// the last CTA resets it). The last CTA of the (b, h) merges the
// partials in split-index order, whatever order they arrived in, and
// writes `out`. A split whose keys are all
// masked has m = -1e30 and weight exp(m - M) = 0 unless the whole row is
// masked, where every weight is 1 and the result is the uniform average.
//
// Attention mass (H2O statistics): the raw scores go to a caller-allocated
// f32 scratch [B, Hkv, Gq, S+W]; the merging CTA, holding the global M_g
// and L_g, writes sum_g exp(s - M_g) / L_g per key into [B, Hkv, S+W],
// and the wrapper sums over kv heads. No atomics on data: only the ticket.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int NT = 128;            // threads per CTA
constexpr int NW = NT / 32;        // warps
// TS and SPLIT_MAX are kernels/build.py's SPLIT_TILE and SPLIT_MAX (the
// launch refuses a split that breaks them)
constexpr int TS = 32;             // keys per tile
constexpr int GQ_MAX = 16;
constexpr int SPLIT_MAX = 64;      // the merge's weights fit every stage area

struct Params {
  const void* q;          // [B, Hq, D] T
  const void* k;          // [B, S, Hkv, Dp] int8 | [B, S, Hkv, D] T
  const float* k_scale;   // [B, S/G, Hkv, D]
  const float* k_zero;
  const void* v;
  const float* v_scale;   // [B, S, Hkv]
  const float* v_zero;
  const float* bias_main; // [B, S]
  const void* rk;         // [B, W, Hkv, D] T
  const void* rv;
  const float* bias_ring; // [B, W]
  void* out;              // [B, Hq, D] T
  float* scores;          // [B, Hkv, Gq, S+W] or null (no mass)
  float* mass_h;          // [B, Hkv, S+W] or null
  const int* tbl;         // paged: [B, n_max] pool block ids, -1 unmapped
  float* part;            // [B*Hkv, n_split, Gq, D+4]: acc[D], m, l, pad
  int* tickets;           // [B*Hkv], zero between launches
  int B, S, W, Hkv, Gq, G, round_bf16;
  int n_max, bl, n_blocks;  // paged: S = n_max * bl; pool blocks
  int n_split, split_len;
  float scale;
};

// Main-store row s of sequence b: its row in the store's [rows, Hkv, *]
// layout, and its row in the K-scale [groups, Hkv, D] layout.
template <bool PAGED>
__device__ __forceinline__ void main_row(const Params& p, int b, int s,
                                         size_t& row, size_t& grp) {
  if constexpr (PAGED) {
    const int e = p.tbl[(size_t)b * p.n_max + s / p.bl];
    const int blk = min(max(e, 0), p.n_blocks - 1);
    const int r = s % p.bl;
    row = (size_t)blk * p.bl + r;
    grp = (size_t)blk * (p.bl / p.G) + r / p.G;
  } else {
    row = (size_t)b * p.S + s;
    grp = (size_t)b * (p.S / p.G) + s / p.G;
  }
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 4 consecutive elements (8 bytes of bf16, 16 of f32) of shared memory
__device__ __forceinline__ void ld4(const float* src, float* dst) {
  const float4 f = *reinterpret_cast<const float4*>(src);
  dst[0] = f.x; dst[1] = f.y; dst[2] = f.z; dst[3] = f.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* src, float* dst) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), c = __bfloat1622float2(h[1]);
  dst[0] = a.x; dst[1] = a.y; dst[2] = c.x; dst[3] = c.y;
}
// 16 bytes (8 bf16 or 4 f32) of shared memory as f32
__device__ __forceinline__ void ld16(const float* src, float* dst) {
  ld4(src, dst);
}
__device__ __forceinline__ void ld16(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    dst[2 * e] = f.x;
    dst[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// q . k over D elements: k a row of shared memory (bf16 or f32), q f32
template <int D, typename E>
__device__ __forceinline__ float dot_row(const E* k, const float* q) {
  constexpr int V = 16 / (int)sizeof(E);
  float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int c = 0; c < D; c += V) {
    float kv[V], qv[V];
    ld16(k + c, kv);
#pragma unroll
    for (int e = 0; e < V; e += 4) ld4(q + c + e, qv + e);
#pragma unroll
    for (int e = 0; e < V; ++e) a[e % 4] = fmaf(qv[e], kv[e], a[e % 4]);
  }
  return (a[0] + a[1]) + (a[2] + a[3]);
}

// Shared memory layout, per instance (T, BITS, D) and Gq:
//   q [Gq, D] f32 | p [Gq, TS] f32 | alpha [Gq] f32 (padded to 16 bytes)
//   | STAGES stages: K rows at a padded stride (lane-per-key reads are
//     conflict-free), V rows, then per row bias, V scale, V zero, K group
//   | quantized: the current tile dequantized, K [TS, D+4], V [TS, D] f32
template <typename T, int BITS, int D>
struct Layout {
  static constexpr int RB = D * (int)sizeof(T);          // T row bytes
  static constexpr int KRS = (RB / 16) % 2 ? RB : RB + 16;
  static constexpr int STAGES = BITS < 16 ? 2 : 3;
  static constexpr int SB = TS * KRS + TS * RB + 4 * TS * 4;
  static constexpr int KWS = D + 4;                       // work K stride
  static constexpr int WORK = BITS < 16 ? TS * (KWS + D) * 4 : 0;
  __host__ __device__ static constexpr int head(int Gq) {
    return (Gq * D + Gq * TS + ((Gq + 3) / 4) * 4) * 4;
  }
  __host__ __device__ static constexpr int bytes(int Gq) {
    return head(Gq) + STAGES * SB + WORK;
  }
};

template <typename T, int BITS, bool PAGED, int D>
__global__ void __launch_bounds__(NT) decode_attn_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  using L = Layout<T, BITS, D>;
  constexpr int RB = L::RB, KRS = L::KRS, SB = L::SB, STAGES = L::STAGES;
  constexpr int F = BITS < 16 ? 8 / BITS : 1;
  constexpr int MASK = BITS < 16 ? (1 << BITS) - 1 : 0;
  constexpr int RBM = BITS < 16 ? D / F : RB;      // main-store row bytes
  constexpr int D4 = D / 4;                        // PV items per head
  constexpr int ITEMS = (GQ_MAX * D4 + NT - 1) / NT;
  constexpr int GW = (GQ_MAX + NW - 1) / NW;       // heads a warp owns
  static_assert(RBM % 16 == 0 && RB % 16 == 0, "16-byte row chunks");

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int Gq = p.Gq, Hkv = p.Hkv, S = p.S, W = p.W;
  const int Stot = S + W;
  const size_t bh = (size_t)b * Hkv + h;

  float* q_s = reinterpret_cast<float*>(smem);
  float* p_s = q_s + Gq * D;                       // [Gq, TS]
  float* a_s = p_s + Gq * TS;                      // [Gq]
  unsigned char* stage0 = smem + L::head(Gq);
  float* kw = reinterpret_cast<float*>(stage0 + STAGES * SB);
  float* vw = kw + TS * L::KWS;
  const T* q = (const T*)p.q + bh * Gq * D;
  for (int i = t; i < Gq * D; i += NT) q_s[i] = to_f32(q[i]);

  // this split's keys: main rows [kb, me), then ring rows [rb, ke) of
  // the logical axis; tiles never straddle the main / ring boundary
  const int kb = split * p.split_len;
  const int ke = min(Stot, kb + p.split_len);
  const int me = min(ke, S), rb = max(kb, S);
  const int n_main = kb < me ? (me - kb + TS - 1) / TS : 0;
  const int n_ring = rb < ke ? (ke - rb + TS - 1) / TS : 0;
  const int nt = n_main + n_ring;

  auto issue = [&](int i) {
    unsigned char* ks = stage0 + (i % STAGES) * SB;
    unsigned char* vs = ks + TS * KRS;
    float* meta = reinterpret_cast<float*>(vs + TS * RB);
    if (i < n_main) {
      const int s0 = kb + i * TS, n = min(TS, me - s0);
      constexpr int CH = RBM / 16;
      for (int c = t; c < n * CH; c += NT) {
        const int r = c / CH, x = c % CH;
        size_t mrow, grp;
        main_row<PAGED>(p, b, s0 + r, mrow, grp);
        const size_t off = (mrow * Hkv + h) * RBM + x * 16;
        cp16(ks + r * KRS + x * 16, (const char*)p.k + off);
        cp16(vs + r * RBM + x * 16, (const char*)p.v + off);
      }
      if (t < n) {
        cp4(meta + t, p.bias_main + (size_t)b * S + s0 + t);
        if constexpr (BITS < 16) {
          size_t mrow, grp;
          main_row<PAGED>(p, b, s0 + t, mrow, grp);
          cp4(meta + TS + t, p.v_scale + mrow * Hkv + h);
          cp4(meta + 2 * TS + t, p.v_zero + mrow * Hkv + h);
          reinterpret_cast<int*>(meta)[3 * TS + t] = (int)grp;
        }
      }
    } else {
      const int r0 = rb - S + (i - n_main) * TS, n = min(TS, ke - S - r0);
      constexpr int CH = RB / 16;
      for (int c = t; c < n * CH; c += NT) {
        const int r = c / CH, x = c % CH;
        const size_t off = (((size_t)b * W + r0 + r) * Hkv + h) * RB + x * 16;
        cp16(ks + r * KRS + x * 16, (const char*)p.rk + off);
        cp16(vs + r * RB + x * 16, (const char*)p.rv + off);
      }
      if (t < n) cp4(meta + t, p.bias_ring + (size_t)b * W + r0 + t);
    }
  };

  // state: warp w owns query heads w, w+NW, ... (m, l, the same in every
  // lane); thread t owns PV items t, t+NT, ... (head g, elements 4c..4c+3)
  float m[GW], l[GW], acc[ITEMS][4];
#pragma unroll
  for (int k = 0; k < GW; ++k) {
    m[k] = -INFINITY;
    l[k] = 0.f;
  }
#pragma unroll
  for (int it = 0; it < ITEMS; ++it)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[it][e] = 0.f;
  float* sc = p.scores ? p.scores + bh * Gq * Stot : nullptr;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nt) issue(i);
    cp_commit();
  }
  for (int i = 0; i < nt; ++i) {
    cp_wait<STAGES - 2>();   // this thread's copies of tile i have landed
    __syncthreads();         // everyone's; tile i-1's stage, p and alpha
    if (i + STAGES - 1 < nt) issue(i + STAGES - 1);   // are free again
    cp_commit();

    const unsigned char* ks = stage0 + (i % STAGES) * SB;
    const unsigned char* vs = ks + TS * KRS;
    const float* meta = reinterpret_cast<const float*>(vs + TS * RB);
    const bool ring = i >= n_main;
    const int j0 = ring ? rb + (i - n_main) * TS : kb + i * TS;  // logical
    const int n = min(TS, (ring ? ke : me) - j0);
    const bool deq = BITS < 16 && !ring;

    if (deq) {
      // dequantize the tile's codes into f32 work tiles, bit for bit the
      // plain version's (code * scale + zero).to(compute_dtype)
      for (int x = t; x < n * D4; x += NT) {
        const int r = x / D4, d0 = (x % D4) * 4;
        const int8_t* kr = reinterpret_cast<const int8_t*>(ks + r * KRS);
        const int8_t* vr = reinterpret_cast<const int8_t*>(vs + r * RBM);
        const size_t ko =
            ((size_t)reinterpret_cast<const int*>(meta)[3 * TS + r] * Hkv
             + h) * D + d0;
        const float vsc = meta[TS + r], vzr = meta[2 * TS + r];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = d0 + e, sh = (d % F) * BITS;
          const int kc = (((int)kr[d / F] + 128) >> sh) & MASK;
          const int vc = (((int)vr[d / F] + 128) >> sh) & MASK;
          float kv = __fadd_rn(__fmul_rn((float)kc, __ldg(p.k_scale + ko + e)),
                               __ldg(p.k_zero + ko + e));
          float vv = __fadd_rn(__fmul_rn((float)vc, vsc), vzr);
          if (p.round_bf16) {
            kv = __bfloat162float(__float2bfloat16_rn(kv));
            vv = __bfloat162float(__float2bfloat16_rn(vv));
          }
          kw[r * L::KWS + d] = kv;
          vw[r * D + d] = vv;
        }
      }
      __syncthreads();
    }

    // scores and the online softmax: a warp per query head, a lane per key
#pragma unroll
    for (int k = 0; k < GW; ++k) {
      const int g = warp + k * NW;
      if (g < Gq) {
        float s = -INFINITY;
        if (lane < n) {
          const float dot =
              deq ? dot_row<D>(kw + lane * L::KWS, q_s + g * D)
                  : dot_row<D>(reinterpret_cast<const T*>(ks + lane * KRS),
                               q_s + g * D);
          s = dot * p.scale + meta[lane];
          if (sc) sc[(size_t)g * Stot + j0 + lane] = s;
        }
        const float m_new = fmaxf(m[k], warp_max(s));
        const float pj = lane < n ? expf(s - m_new) : 0.f;
        const float alpha = expf(m[k] - m_new);   // m = -inf at first: 0
        l[k] = l[k] * alpha + warp_sum(pj);
        m[k] = m_new;
        p_s[g * TS + lane] = pj;
        if (lane == 0) a_s[g] = alpha;
      }
    }
    __syncthreads();

    // O = alpha O + P V: a thread per (head, 4 elements), keys in order
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int x = t + it * NT;
      if (x < Gq * D4) {
        const int g = x / D4, d0 = (x % D4) * 4;
        const float alpha = a_s[g];
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = acc[it][e] * alpha;
        const float* pr = p_s + g * TS;
        for (int j = 0; j < n; ++j) {
          float vv[4];
          if (deq)
            ld4(vw + j * D + d0, vv);
          else
            ld4(reinterpret_cast<const T*>(vs + j * RB) + d0, vv);
          const float pj = pr[j];
#pragma unroll
          for (int e = 0; e < 4; ++e) o[e] = fmaf(pj, vv[e], o[e]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[it][e] = o[e];
      }
    }
  }
  cp_wait<0>();

  // this split's partial (acc[D], m, l) per query head
  constexpr int PS = D + 4;   // acc[D], m, l, padding: 16-byte rows
  float* part = p.part + (bh * p.n_split + split) * Gq * PS;
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int x = t + it * NT;
    if (x < Gq * D4)
      *reinterpret_cast<float4*>(part + (x / D4) * PS + (x % D4) * 4) =
          make_float4(acc[it][0], acc[it][1], acc[it][2], acc[it][3]);
  }
#pragma unroll
  for (int k = 0; k < GW; ++k) {
    const int g = warp + k * NW;
    if (g < Gq && lane == 0) {
      part[g * PS + D] = m[k];
      part[g * PS + D + 1] = l[k];
    }
  }

  // ticket: the last split of this (b, h) to arrive merges
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (t == 0) is_last = atomicAdd(p.tickets + bh, 1) == p.n_split - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (t == 0) p.tickets[bh] = 0;   // zero again for the next launch

  // the merge: every split's m and l of every head into shared memory
  // (all loads in flight at once), M and L per head summed in split
  // order, then the split weights exp(m - M) in place of m
  __shared__ float M_s[GQ_MAX], L_s[GQ_MAX];
  const float* parts = p.part + bh * p.n_split * Gq * PS;
  const int NSG = p.n_split * Gq;
  float* w_s = reinterpret_cast<float*>(stage0);   // [n_split, Gq]
  float* l_s = w_s + NSG;
  for (int i = t; i < NSG; i += NT) {
    w_s[i] = __ldcg(parts + (size_t)i * PS + D);
    l_s[i] = __ldcg(parts + (size_t)i * PS + D + 1);
  }
  __syncthreads();
  if (t < Gq) {
    float M = -INFINITY, Lsum = 0.f;
    for (int s = 0; s < p.n_split; ++s) M = fmaxf(M, w_s[s * Gq + t]);
    for (int s = 0; s < p.n_split; ++s)
      Lsum += l_s[s * Gq + t] * expf(w_s[s * Gq + t] - M);
    M_s[t] = M;
    L_s[t] = Lsum;
  }
  __syncthreads();
  for (int i = t; i < NSG; i += NT) w_s[i] = expf(w_s[i] - M_s[i % Gq]);
  __syncthreads();
  T* out = (T*)p.out + bh * Gq * D;
  for (int x = t; x < Gq * D4; x += NT) {
    const int g = x / D4, d0 = (x % D4) * 4;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int s = 0; s < p.n_split; ++s) {
      const float4 a = __ldcg(
          reinterpret_cast<const float4*>(parts + (s * Gq + g) * PS + d0));
      const float w = w_s[s * Gq + g];
      o[0] += a.x * w;
      o[1] += a.y * w;
      o[2] += a.z * w;
      o[3] += a.w * w;
    }
    const float l_g = fmaxf(L_s[g], 1e-30f);
#pragma unroll
    for (int e = 0; e < 4; ++e) out[g * D + d0 + e] = from_f32<T>(o[e] / l_g);
  }
  if (sc) {
    float* mass = p.mass_h + bh * Stot;
    for (int j = t; j < Stot; j += NT) {
      float sv[GQ_MAX];
#pragma unroll
      for (int g = 0; g < GQ_MAX; ++g)
        if (g < Gq) sv[g] = __ldcg(sc + (size_t)g * Stot + j);
      float sum = 0.f;
#pragma unroll
      for (int g = 0; g < GQ_MAX; ++g)
        if (g < Gq) sum += expf(sv[g] - M_s[g]) / fmaxf(L_s[g], 1e-30f);
      mass[j] = sum;
    }
  }
}

template <typename T, int BITS, bool PAGED, int D>
cudaError_t launch_one(const Params& p, cudaStream_t st) {
  static bool configured = false;   // opt in to >48 KB once per instance
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_attn_kernel<T, BITS, PAGED, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        Layout<T, BITS, D>::bytes(GQ_MAX));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid(p.n_split, p.Hkv, p.B);
  decode_attn_kernel<T, BITS, PAGED, D>
      <<<grid, NT, Layout<T, BITS, D>::bytes(p.Gq), st>>>(p);
  return cudaGetLastError();
}

template <typename T, bool PAGED, int D>
cudaError_t launch_bits(const Params& p, int bits, cudaStream_t st) {
  switch (bits) {
    case 2: return launch_one<T, 2, PAGED, D>(p, st);
    case 4: return launch_one<T, 4, PAGED, D>(p, st);
    case 8: return launch_one<T, 8, PAGED, D>(p, st);
    case 16: return launch_one<T, 16, PAGED, D>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

template <bool PAGED>
cudaError_t launch_d(const Params& p, int D, int bits, int dtype,
                     cudaStream_t st) {
  if (D == 128)
    return dtype == 1 ? launch_bits<__nv_bfloat16, PAGED, 128>(p, bits, st)
                      : launch_bits<float, PAGED, 128>(p, bits, st);
  if (D == 64)
    return dtype == 1 ? launch_bits<__nv_bfloat16, PAGED, 64>(p, bits, st)
                      : launch_bits<float, PAGED, 64>(p, bits, st);
  return cudaErrorInvalidValue;
}

int launch(Params& p, int D, int bits, int dtype, bool paged, void* stream) {
  const int Stot = p.S + p.W;
  if (p.Gq > GQ_MAX || p.Gq < 1 || p.S < 1 || p.G < 1 || p.n_split < 1
      || p.n_split > SPLIT_MAX
      || p.split_len < 1 || p.split_len % TS
      || (long)(p.n_split - 1) * p.split_len >= Stot
      || (long)p.n_split * p.split_len < Stot)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(paged ? launch_d<true>(p, D, bits, dtype, st)
                     : launch_d<false>(p, D, bits, dtype, st));
}

Params make_params(const void* q, const void* k, const void* k_scale,
                   const void* k_zero, const void* v, const void* v_scale,
                   const void* v_zero, const void* bias_main, const void* rk,
                   const void* rv, const void* bias_ring, void* out,
                   void* scores, void* mass_h, void* part, void* tickets,
                   int B, int S, int W, int Hkv, int Gq, int G,
                   int round_bf16, int n_split, int split_len, float scale) {
  Params p;
  p.q = q; p.k = k; p.k_scale = (const float*)k_scale;
  p.k_zero = (const float*)k_zero; p.v = v;
  p.v_scale = (const float*)v_scale; p.v_zero = (const float*)v_zero;
  p.bias_main = (const float*)bias_main; p.rk = rk; p.rv = rv;
  p.bias_ring = (const float*)bias_ring; p.out = out;
  p.scores = (float*)scores; p.mass_h = (float*)mass_h;
  p.tbl = nullptr;
  p.part = (float*)part; p.tickets = (int*)tickets;
  p.B = B; p.S = S; p.W = W; p.Hkv = Hkv; p.Gq = Gq; p.G = G;
  p.round_bf16 = round_bf16; p.scale = scale;
  p.n_max = 0; p.bl = 0; p.n_blocks = 0;
  p.n_split = n_split; p.split_len = split_len;
  return p;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, out, ring and the dense store);
// head_dim D must be 64 or 128. scores/mass_h null: no attention mass.
// part: f32 scratch [B*Hkv, n_split, Gq, D+4]; tickets: int32 [B*Hkv],
// zero before the launch and zero again after it. The key axis [main |
// ring] splits into n_split <= 64 runs of split_len keys (whole 32-key
// tiles), none empty.
extern "C" int decode_attn_launch(
    const void* q, const void* k, const void* k_scale, const void* k_zero,
    const void* v, const void* v_scale, const void* v_zero,
    const void* bias_main, const void* rk, const void* rv,
    const void* bias_ring, void* out, void* scores, void* mass_h,
    void* part, void* tickets, int B, int S, int W, int Hkv, int Gq, int D,
    int G, int bits, int dtype, int round_bf16, int n_split, int split_len,
    float scale, void* stream) {
  Params p = make_params(q, k, k_scale, k_zero, v, v_scale, v_zero,
                         bias_main, rk, rv, bias_ring, out, scores, mass_h,
                         part, tickets, B, S, W, Hkv, Gq, G, round_bf16,
                         n_split, split_len, scale);
  return launch(p, D, bits, dtype, false, stream);
}

// The paged store: k/v/scale pointers are the pools [n_blocks, bl, Hkv, *]
// (K scales [n_blocks, bl/G, Hkv, D], V scales [n_blocks, bl, Hkv]),
// tbl [B, n_max] int32; the main store is S = n_max * bl rows long.
extern "C" int decode_attn_paged_launch(
    const void* q, const void* tbl, const void* pk, const void* pk_scale,
    const void* pk_zero, const void* pv, const void* pv_scale,
    const void* pv_zero, const void* bias_main, const void* rk,
    const void* rv, const void* bias_ring, void* out, void* scores,
    void* mass_h, void* part, void* tickets, int B, int n_max, int bl,
    int n_blocks, int W, int Hkv, int Gq, int D, int G, int bits, int dtype,
    int round_bf16, int n_split, int split_len, float scale, void* stream) {
  if (n_max < 1 || bl < 1 || n_blocks < 1 || bl % G)
    return (int)cudaErrorInvalidValue;
  Params p = make_params(q, pk, pk_scale, pk_zero, pv, pv_scale, pv_zero,
                         bias_main, rk, rv, bias_ring, out, scores, mass_h,
                         part, tickets, B, n_max * bl, W, Hkv, Gq, G,
                         round_bf16, n_split, split_len, scale);
  p.tbl = (const int*)tbl;
  p.n_max = n_max; p.bl = bl; p.n_blocks = n_blocks;
  return launch(p, D, bits, dtype, true, stream);
}
