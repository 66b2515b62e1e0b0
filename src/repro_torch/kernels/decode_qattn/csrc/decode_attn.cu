// Fused dequantize-and-attend decode over [main store | residual ring].
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
// address — the dequant rounding, the online softmax, the ring tile, the
// mass scratch — is the same code, so on the same rows the paged
// kernel's output and mass are bit-equal to the dense kernel's. A 32-key
// tile may span several pool blocks (dense stores use 16-row blocks):
// each row is addressed on its own.
//
// What bounds it on an H100: bytes. One decode query row per sequence
// meets the whole cache once, so the work is ~2*Gq flops per cache
// element read — far below the ~295 flops/byte the card needs before
// its arithmetic is the limit. The cache is read once per step: packed
// 2/4/8-bit codes plus f32 KIVI scales (bits < 16), or the dense 16-bit
// store, plus the full-precision ring.
//
// Design: one CTA per (kv head, sequence) walks key tiles of the main
// store, then of the ring, in one online softmax — the loop replaces the
// TPU's sequential grid axis. All Gq query heads of the kv head share
// each tile, so every byte of K/V is fetched once for the GQA group
// (the point of GQA on a memory-bound step). Codes are unpacked right
// after the load, dequantized with __fmul_rn/__fadd_rn (no FMA
// contraction, to track the plain version's mul-then-add) and rounded
// through bf16 when the model computes in bf16, exactly like the plain
// version's `(code*scale + zero).to(compute_dtype)`. Masking is the
// additive validity bias with a finite -1e30 (an all-empty row then
// softmaxes uniformly, as the reference does, instead of NaN). Tiles
// need not divide the store: the tail tile is simply shorter.
//
// Attention mass (H2O statistics): the TPU kept a [Gq, S+W] probability
// scratch in VMEM rescaled as the max moved; that does not fit shared
// memory at long S. Instead the raw scores go to a caller-allocated f32
// scratch [B, Hkv, Gq, S+W]; after the loop the same CTA writes
// sum_g exp(s - m_g) / l_g per key into [B, Hkv, S+W], and the wrapper
// sums over kv heads. No atomics: the summation order is fixed.
//
// Occupancy note: B*Hkv CTAs (64 at granite-8b with 8 slots, on 132
// SMs). Splitting the key axis across CTAs is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int NT = 128;            // threads per CTA
constexpr int TS = 32;             // keys per tile
constexpr int D_MAX = 128;
constexpr int GQ_MAX = 16;
constexpr int ACC_PER_THREAD = GQ_MAX * D_MAX / NT;
constexpr float NEG_INF = -1e30f;

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
  int B, S, W, Hkv, Gq, D, G, round_bf16;
  int n_max, bl, n_blocks;  // paged: S = n_max * bl; pool blocks
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
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

template <typename T, int BITS, bool PAGED>
__global__ void __launch_bounds__(NT) decode_attn_kernel(Params p) {
  __shared__ float q_s[GQ_MAX * D_MAX];
  __shared__ float k_s[TS * (D_MAX + 1)];   // padded rows: no bank conflicts
  __shared__ float v_s[TS * D_MAX];
  __shared__ float s_s[GQ_MAX * TS];        // scores, then probabilities
  __shared__ float m_s[GQ_MAX], l_s[GQ_MAX], a_s[GQ_MAX];

  const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int Gq = p.Gq, D = p.D, Hkv = p.Hkv, S = p.S, W = p.W;
  const int KS = D + 1;
  const int Stot = S + W;
  const size_t bh = (size_t)b * Hkv + h;

  const T* q = (const T*)p.q + bh * Gq * D;
  for (int i = t; i < Gq * D; i += NT) q_s[i] = to_f32(q[i]);
  if (t < Gq) { m_s[t] = NEG_INF; l_s[t] = 0.f; }
  float acc[ACC_PER_THREAD];
#pragma unroll
  for (int i = 0; i < ACC_PER_THREAD; ++i) acc[i] = 0.f;
  float* sc = p.scores ? p.scores + bh * Gq * Stot : nullptr;
  __syncthreads();

  // one online-softmax update over keys [j0, j0+n) of the [main | ring]
  // axis; the tile's K/V rows and bias are already in shared memory
  auto attend = [&](const float* bias, int j0, int n) {
    for (int i = t; i < Gq * TS; i += NT) {
      const int g = i / TS, j = i % TS;
      if (j < n) {
        const float* qr = q_s + g * D;
        const float* kr = k_s + j * KS;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        const float s = dot * p.scale + bias[j];
        s_s[i] = s;
        if (sc) sc[(size_t)g * Stot + j0 + j] = s;
      }
    }
    __syncthreads();
    const int warp = t / 32, lane = t % 32;
    for (int g = warp; g < Gq; g += NT / 32) {
      const float s = lane < n ? s_s[g * TS + lane] : -INFINITY;
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float pj = lane < n ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(pj);
      s_s[g * TS + lane] = pj;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < ACC_PER_THREAD; ++k) {
      const int i = t + k * NT;
      if (i < Gq * D) {
        const int g = i / D, d = i % D;
        const float* pr = s_s + g * TS;
        float a = acc[k] * a_s[g];
        for (int j = 0; j < n; ++j) a = fmaf(pr[j], v_s[j * D + d], a);
        acc[k] = a;
      }
    }
    __syncthreads();
  };

  __shared__ float bias_s[TS];
  constexpr int F = BITS < 16 ? 8 / BITS : 1;
  constexpr int MASK = BITS < 16 ? (1 << BITS) - 1 : 0;
  const int Dp = D / F;

  // ---- main store ----
  for (int s0 = 0; s0 < S; s0 += TS) {
    const int n = min(TS, S - s0);
    for (int i = t; i < n * D; i += NT) {
      const int r = i / D, d = i % D;
      size_t mrow, grp;
      main_row<PAGED>(p, b, s0 + r, mrow, grp);
      const size_t row = mrow * Hkv + h;
      float kv, vv;
      if constexpr (BITS < 16) {
        const int sh = (d % F) * BITS;
        const int kc = (((int)((const int8_t*)p.k)[row * Dp + d / F] + 128)
                        >> sh) & MASK;
        const int vc = (((int)((const int8_t*)p.v)[row * Dp + d / F] + 128)
                        >> sh) & MASK;
        const size_t ko = (grp * Hkv + h) * D + d;
        kv = __fadd_rn(__fmul_rn((float)kc, p.k_scale[ko]), p.k_zero[ko]);
        vv = __fadd_rn(__fmul_rn((float)vc, p.v_scale[row]), p.v_zero[row]);
        if (p.round_bf16) {
          kv = __bfloat162float(__float2bfloat16_rn(kv));
          vv = __bfloat162float(__float2bfloat16_rn(vv));
        }
      } else {
        kv = to_f32(((const T*)p.k)[row * D + d]);
        vv = to_f32(((const T*)p.v)[row * D + d]);
      }
      k_s[r * KS + d] = kv;
      v_s[r * D + d] = vv;
    }
    if (t < n) bias_s[t] = p.bias_main[(size_t)b * S + s0 + t];
    __syncthreads();
    attend(bias_s, s0, n);
  }

  // ---- residual ring: trailing tiles of the same online softmax ----
  for (int s0 = 0; s0 < W; s0 += TS) {
    const int n = min(TS, W - s0);
    for (int i = t; i < n * D; i += NT) {
      const int r = i / D, d = i % D;
      const size_t row = ((size_t)b * W + s0 + r) * Hkv + h;
      k_s[r * KS + d] = to_f32(((const T*)p.rk)[row * D + d]);
      v_s[r * D + d] = to_f32(((const T*)p.rv)[row * D + d]);
    }
    if (t < n) bias_s[t] = p.bias_ring[(size_t)b * W + s0 + t];
    __syncthreads();
    attend(bias_s, S + s0, n);
  }

  T* out = (T*)p.out + bh * Gq * D;
#pragma unroll
  for (int k = 0; k < ACC_PER_THREAD; ++k) {
    const int i = t + k * NT;
    if (i < Gq * D) out[i] = from_f32<T>(acc[k] / fmaxf(l_s[i / D], 1e-30f));
  }
  if (sc) {
    // every score of this (b, h) was written by this CTA before the last
    // __syncthreads inside `attend`, so it is visible here
    float* mass = p.mass_h + bh * Stot;
    for (int j = t; j < Stot; j += NT) {
      float sum = 0.f;
      for (int g = 0; g < Gq; ++g)
        sum += expf(sc[(size_t)g * Stot + j] - m_s[g]) / fmaxf(l_s[g], 1e-30f);
      mass[j] = sum;
    }
  }
}

template <typename T, bool PAGED>
cudaError_t launch_bits(const Params& p, int bits, cudaStream_t st) {
  dim3 grid(p.Hkv, p.B);
  switch (bits) {
    case 2: decode_attn_kernel<T, 2, PAGED><<<grid, NT, 0, st>>>(p); break;
    case 4: decode_attn_kernel<T, 4, PAGED><<<grid, NT, 0, st>>>(p); break;
    case 8: decode_attn_kernel<T, 8, PAGED><<<grid, NT, 0, st>>>(p); break;
    case 16: decode_attn_kernel<T, 16, PAGED><<<grid, NT, 0, st>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

int launch(Params& p, int bits, int dtype, bool paged, void* stream) {
  if (p.D > D_MAX || p.Gq > GQ_MAX || p.Gq < 1 || p.D < 1 || p.S < 1
      || p.G < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (paged)
    e = dtype == 1 ? launch_bits<__nv_bfloat16, true>(p, bits, st)
                   : launch_bits<float, true>(p, bits, st);
  else
    e = dtype == 1 ? launch_bits<__nv_bfloat16, false>(p, bits, st)
                   : launch_bits<float, false>(p, bits, st);
  return (int)e;
}

Params make_params(const void* q, const void* k, const void* k_scale,
                   const void* k_zero, const void* v, const void* v_scale,
                   const void* v_zero, const void* bias_main, const void* rk,
                   const void* rv, const void* bias_ring, void* out,
                   void* scores, void* mass_h, int B, int S, int W, int Hkv,
                   int Gq, int D, int G, int round_bf16, float scale) {
  Params p;
  p.q = q; p.k = k; p.k_scale = (const float*)k_scale;
  p.k_zero = (const float*)k_zero; p.v = v;
  p.v_scale = (const float*)v_scale; p.v_zero = (const float*)v_zero;
  p.bias_main = (const float*)bias_main; p.rk = rk; p.rv = rv;
  p.bias_ring = (const float*)bias_ring; p.out = out;
  p.scores = (float*)scores; p.mass_h = (float*)mass_h;
  p.tbl = nullptr;
  p.B = B; p.S = S; p.W = W; p.Hkv = Hkv; p.Gq = Gq; p.D = D; p.G = G;
  p.round_bf16 = round_bf16; p.scale = scale;
  p.n_max = 0; p.bl = 0; p.n_blocks = 0;
  return p;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, out, ring and the dense store).
// scores/mass_h null: no attention mass.
extern "C" int decode_attn_launch(
    const void* q, const void* k, const void* k_scale, const void* k_zero,
    const void* v, const void* v_scale, const void* v_zero,
    const void* bias_main, const void* rk, const void* rv,
    const void* bias_ring, void* out, void* scores, void* mass_h,
    int B, int S, int W, int Hkv, int Gq, int D, int G, int bits, int dtype,
    int round_bf16, float scale, void* stream) {
  Params p = make_params(q, k, k_scale, k_zero, v, v_scale, v_zero,
                         bias_main, rk, rv, bias_ring, out, scores, mass_h,
                         B, S, W, Hkv, Gq, D, G, round_bf16, scale);
  return launch(p, bits, dtype, false, stream);
}

// The paged store: k/v/scale pointers are the pools [n_blocks, bl, Hkv, *]
// (K scales [n_blocks, bl/G, Hkv, D], V scales [n_blocks, bl, Hkv]),
// tbl [B, n_max] int32; the main store is S = n_max * bl rows long.
extern "C" int decode_attn_paged_launch(
    const void* q, const void* tbl, const void* pk, const void* pk_scale,
    const void* pk_zero, const void* pv, const void* pv_scale,
    const void* pv_zero, const void* bias_main, const void* rk,
    const void* rv, const void* bias_ring, void* out, void* scores,
    void* mass_h, int B, int n_max, int bl, int n_blocks, int W, int Hkv,
    int Gq, int D, int G, int bits, int dtype, int round_bf16, float scale,
    void* stream) {
  if (n_max < 1 || bl < 1 || n_blocks < 1 || bl % G)
    return (int)cudaErrorInvalidValue;
  Params p = make_params(q, pk, pk_scale, pk_zero, pv, pv_scale, pv_zero,
                         bias_main, rk, rv, bias_ring, out, scores, mass_h,
                         B, n_max * bl, W, Hkv, Gq, D, G, round_bf16, scale);
  p.tbl = (const int*)tbl;
  p.n_max = n_max; p.bl = bl; p.n_blocks = n_blocks;
  return launch(p, bits, dtype, true, stream);
}
