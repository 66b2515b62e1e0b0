// Blocked causal (optionally sliding-window) flash attention for prefill.
//
// Replaces: src/repro/kernels/flash_prefill/kernel.py:flash_prefill_pallas
// (body `_kernel`), the TPU prompt-prefill attention of the policies that
// read no attention mass (full / streaming / quantized-only), entry point
// `flash_prefill_launch`; src/repro/kernels/flash_prefill/kernel.py:
// flash_prefill_chunk_pallas (body `_chunk_kernel`), its rectangular
// chunked-prefill variant, entry point `flash_prefill_chunk_launch`; and
// src/repro/kernels/flash_prefill/kernel.py:flash_verify_pallas (body
// `_verify_kernel`), the speculative-verify attention, entry point
// `flash_verify_launch` (its own kernel, at the end of this file).
//
// One kernel serves both. A Tq-row prompt segment sits at absolute rows
// q_offset .. q_offset+Tq-1 and attends the Tk-row prompt scratch under
// a causal test on absolute positions; the monolithic prefill is the
// case q_offset = 0, Tq = Tk. Scratch rows past the segment's end are
// still zero: they are masked by position, never trusted to be zero.
// q_offset is a kernel argument (one build, any offset). With segment
// offsets on the 64-row tile grid, a segment's query tiles are the whole
// prompt's tiles and visit the same key tiles in the same order, and a
// masked key adds an exact zero, so concatenated segment outputs are
// bit-equal to the monolithic kernel's.
//
// What bounds it on an H100: operations. Each 64x64 score tile costs
// 2*64*64*D flops for QK^T and as many for PV against 2*64*D loaded
// elements, so at D = 128 the kernel does hundreds of flops per byte;
// causal T = 2048 is ~2*T^2*D flops per head (half the square).
//
// Design: one CTA of 256 threads per (64-row query tile, query head,
// sequence); the CTA loops over 64-row key tiles from the window's start
// up to the causal diagonal of its last absolute row — the loop replaces the TPU's sequential kv
// grid axis, and fully masked tiles are never visited at all. GQA maps
// query head h to kv head h / Gq. Q/K/V tiles and the probability tile
// live in shared memory as f32 (dynamic shared memory, ~113 KB at
// D = 128); each thread owns a 4-row x (D/16)-column block of the output
// accumulator and a 4x4 block of every score tile, so its inner loops
// are register-blocked scalar FMAs. The online softmax runs in f32 with
// the reference's finite -1e30 mask. Query tiles are issued longest
// first (the diagonal tiles near the end of the prompt do the most
// work), which evens out the causal imbalance across SMs.
//
// Simple first: scalar f32 FMAs, not tensor cores. bf16 mma/wgmma with
// f32 accumulation is later work; the plain version's f32 products of
// bf16 inputs are exact in f32, so only the summation order would move.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int BQ = 64, BK = 64, NT = 256;
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;   // [B, Tq, Hq, D] rows at absolute q_offset + t
  const void* k;   // [B, Tk, Hkv, D]
  const void* v;
  void* out;       // [B, Tq, Hq, D]
  int B, Tq, Tk, q_offset, Hq, Hkv, window;
  float scale;
};

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

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D
                          + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_prefill_kernel(Params p) {
  extern __shared__ float smem[];
  constexpr int QS = D + 1, KS = D + 1, PS = BK + 1, DJ = D / 16;
  float* Qs = smem;
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + BK * KS;
  float* Ps = Vs + BK * D;

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest tiles first
  const int hq = blockIdx.y, b = blockIdx.z;
  const int Gq = p.Hq / p.Hkv, hk = hq / Gq;
  const int Tq = p.Tq, Tk = p.Tk;
  const int q0 = qt * BQ;                // first segment row of the tile
  const int qa0 = p.q_offset + q0;       // its absolute position
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const T* qg = (const T*)p.q;
  const T* kg = (const T*)p.k;
  const T* vg = (const T*)p.v;

  for (int i = t; i < BQ * D; i += NT) {
    const int r = i / D, d = i % D, qrow = q0 + r;
    Qs[r * QS + d] = qrow < Tq
        ? to_f32(qg[(((size_t)b * Tq + qrow) * p.Hq + hq) * D + d]) : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // last absolute row of the tile, and the last key it can see
  const int q_last = p.q_offset + min(q0 + BQ, Tq) - 1;
  const int k_last = min(q_last, Tk - 1);
  for (int k0 = 0; k0 <= k_last; k0 += BK) {
    if (p.window > 0 && k0 + BK - 1 <= qa0 - p.window) continue;
    __syncthreads();   // the previous tile's K/V/P are consumed
    for (int i = t; i < BK * D; i += NT) {
      const int r = i / D, d = i % D, kpos = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kpos < Tk) {
        const size_t o = (((size_t)b * Tk + kpos) * p.Hkv + hk) * D + d;
        kv = to_f32(kg[o]);
        vv = to_f32(vg[o]);
      }
      Ks[r * KS + d] = kv;
      Vs[r * D + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, qpos = qa0 + r;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos <= qpos && kpos < Tk;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        s[i][j] = ok ? s[i][j] * p.scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of one row are 16 consecutive lanes of a warp
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = expf(s[i][j] - m_new);
        Ps[r * PS + tx + 16 * j] = pv;
        ps += pv;
      }
      for (int o = 8; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* og = (T*)p.out;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qrow = q0 + ty * 4 + i;
    if (qrow >= Tq) continue;
    const float l_i = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      og[(((size_t)b * Tq + qrow) * p.Hq + hq) * D + tx + 16 * j] =
          from_f32<T>(acc[i][j] / l_i);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t st) {
  static bool configured = false;   // opt in to >48 KB once per instance
  constexpr size_t smem = smem_bytes<D>();
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((p.Tq + BQ - 1) / BQ, p.Hq, p.B);
  flash_prefill_kernel<T, D><<<grid, NT, smem, st>>>(p);
  return cudaGetLastError();
}

int launch_any(const Params& p, int D, int dtype, void* stream) {
  if (p.Tq < 1 || p.Tk < 1 || p.q_offset < 0 || p.q_offset + p.Tq > p.Tk
      || p.Hkv < 1 || p.Hq % p.Hkv)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (D == 128)
    e = dtype == 1 ? launch<__nv_bfloat16, 128>(p, st)
                   : launch<float, 128>(p, st);
  else if (D == 64)
    e = dtype == 1 ? launch<__nv_bfloat16, 64>(p, st)
                   : launch<float, 64>(p, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. head_dim must be 64 or 128.
extern "C" int flash_prefill_launch(const void* q, const void* k,
                                    const void* v, void* out, int B, int T,
                                    int Hq, int Hkv, int D, int window,
                                    int dtype, float scale, void* stream) {
  Params p{q, k, v, out, B, T, T, 0, Hq, Hkv, window, scale};
  return launch_any(p, D, dtype, stream);
}

// One Tq-row segment at absolute rows q_offset.. against the Tk-row
// prompt scratch (q_offset + Tq <= Tk).
extern "C" int flash_prefill_chunk_launch(const void* q, const void* k,
                                          const void* v, void* out, int B,
                                          int Tq, int Tk, int q_offset,
                                          int Hq, int Hkv, int D, int window,
                                          int dtype, float scale,
                                          void* stream) {
  Params p{q, k, v, out, B, Tq, Tk, q_offset, Hq, Hkv, window, scale};
  return launch_any(p, D, dtype, stream);
}


// ---------------------------------------------------------------------------
// Speculative verify: an L-row segment against the materialized cache view
// ---------------------------------------------------------------------------
//
// Computes flash_verify_ref (kernels/flash_prefill/ref.py): each sequence's
// L speculated rows (last committed token + drafts, already appended to the
// cache) attend its materialized view [main store | ring] of Tk rows. The
// view has no arange structure: key s carries an explicit absolute position
// kv_pos[s] and an additive validity bias[s]; it is visible to row t iff
// kv_pos[s] <= q_pos[t] (and kv_pos[s] > q_pos[t] - window). A row with no
// visible key softmaxes uniformly over all Tk keys, as the plain version's
// finite -1e30 mask does (a slot with valid_len 0 still runs its rows).
//
// What bounds it on an H100: bytes. L is tiny (gamma + 1 = 5 at the serve
// shape), so every K/V row read does only 4*Gq*L flops per element pair;
// at B 8, Tk 2112, Hkv 8, D 128 in bf16 the kernel reads ~69 MB of K/V
// against ~0.7 GFLOP.
//
// Design: one CTA of 128 threads per (sequence, kv head, 32-row tile of
// that kv head's query rows). The Gq query heads sharing a kv head and the
// L segment rows are packed into rows r = t*Gq + g, so granite-8b's 4 x 5
// = 20 rows fill one tile and each K/V tile is read once for all of them
// (not padded to a 64-row tile, nor L to 8: any L <= 16). The CTA loops
// over 64-row key tiles staged in shared memory as f32 (16-byte loads)
// with their kv_pos and bias; each thread owns a 4-row x 4-key block of every score tile and
// a 4-row x (D/16)-column block of the output, as in the prefill kernel.
// The online softmax runs in f32; keys past Tk take no part (p = 0), so
// the uniform average of a fully masked row is over exactly Tk keys.
// 64 CTAs on 132 SMs at 8 slots: a split-KV combine is later work.

namespace {

constexpr int VQ = 32, VT = 128, VL_MAX = 16;

struct VParams {
  const void* q;       // [B, L, Hq, D]
  const void* k;       // [B, Tk, Hkv, D]
  const void* v;
  const int* kv_pos;   // [B, Tk]
  const float* bias;   // [B, Tk]
  const int* q_pos;    // [B, L]
  void* out;           // [B, L, Hq, D]
  int B, L, Tk, Hq, Hkv, window;
  float scale;
};

template <int D>
constexpr size_t verify_smem_bytes() {
  return sizeof(float) * (VQ * (D + 1) + BK * (D + 1) + BK * D
                          + VQ * (BK + 1) + BK)
         + sizeof(int) * BK;
}

// 16 bytes of a row (8 bf16 or 4 f32, 16-byte aligned) as f32
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    dst[2 * e] = f.x;
    dst[2 * e + 1] = f.y;
  }
}
__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 f = *reinterpret_cast<const float4*>(src);
  dst[0] = f.x;
  dst[1] = f.y;
  dst[2] = f.z;
  dst[3] = f.w;
}

template <typename T, int D>
__global__ void __launch_bounds__(VT) flash_verify_kernel(VParams p) {
  extern __shared__ float smem[];
  constexpr int QS = D + 1, KS = D + 1, PS = BK + 1, DJ = D / 16;
  constexpr int VEC = 16 / sizeof(T), CPR = D / VEC;   // 16-byte chunks
  static_assert(BK * CPR % VT == 0, "whole 16-byte chunks per thread");
  float* Qs = smem;
  float* Ks = Qs + VQ * QS;
  float* Vs = Ks + BK * KS;
  float* Ps = Vs + BK * D;
  float* Bs = Ps + VQ * PS;
  int* KP = (int*)(Bs + BK);

  const int hk = blockIdx.y, b = blockIdx.z;
  const int Gq = p.Hq / p.Hkv, R = Gq * p.L, Tk = p.Tk;
  const int r0 = blockIdx.x * VQ;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const T* qg = (const T*)p.q;
  const T* kg = (const T*)p.k;
  const T* vg = (const T*)p.v;

  // query row r of the tile: segment row (r0 + r) / Gq, head hk*Gq + g
  for (int i = t; i < VQ * D; i += VT) {
    const int r = i / D, d = i % D, rr = r0 + r;
    float x = 0.f;
    if (rr < R)
      x = to_f32(qg[(((size_t)b * p.L + rr / Gq) * p.Hq + hk * Gq + rr % Gq)
                    * D + d]);
    Qs[r * QS + d] = x;
  }

  int qpos[4];
  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = r0 + ty * 4 + i;
    qpos[i] = rr < R ? p.q_pos[(size_t)b * p.L + rr / Gq] : 0;
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < Tk; k0 += BK) {
    __syncthreads();   // the previous tile's K/V/P are consumed
    // 16-byte loads: VEC elements a load, all of a thread's in flight
#pragma unroll
    for (int j = 0; j < BK * CPR / VT; ++j) {
      const int i = t + j * VT;
      const int r = i / CPR, c = (i % CPR) * VEC, kpos = k0 + r;
      float kv[VEC], vv[VEC];
      if (kpos < Tk) {
        const size_t o = (((size_t)b * Tk + kpos) * p.Hkv + hk) * D + c;
        load16(kg + o, kv);
        load16(vg + o, vv);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kv[e] = vv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        Ks[r * KS + c + e] = kv[e];
        Vs[r * D + c + e] = vv[e];
      }
    }
    for (int r = t; r < BK; r += VT) {
      const int kpos = k0 + r;
      KP[r] = kpos < Tk ? p.kv_pos[(size_t)b * Tk + kpos] : INT_MAX;
      Bs[r] = kpos < Tk ? p.bias[(size_t)b * Tk + kpos] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kp = KP[c];
        bool ok = kp <= qpos[i];
        if (p.window > 0) ok = ok && kp > qpos[i] - p.window;
        s[i][j] = ok ? s[i][j] * p.scale + Bs[c] : NEG_INF;
        if (k0 + c < Tk) mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of one row are 16 consecutive lanes of a warp
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float pv = k0 + c < Tk ? expf(s[i][j] - m_new) : 0.f;
        Ps[r * PS + c] = pv;
        ps += pv;
      }
      for (int o = 8; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* og = (T*)p.out;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = r0 + ty * 4 + i;
    if (rr >= R) continue;
    const float l_i = fmaxf(l[i], 1e-30f);
    const size_t o = (((size_t)b * p.L + rr / Gq) * p.Hq + hk * Gq + rr % Gq)
                     * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      og[o + tx + 16 * j] = from_f32<T>(acc[i][j] / l_i);
  }
}

template <typename T, int D>
cudaError_t launch_verify(const VParams& p, cudaStream_t st) {
  static bool configured = false;   // opt in to >48 KB once per instance
  constexpr size_t smem = verify_smem_bytes<D>();
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_verify_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int R = (p.Hq / p.Hkv) * p.L;
  dim3 grid((R + VQ - 1) / VQ, p.Hkv, p.B);
  flash_verify_kernel<T, D><<<grid, VT, smem, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// One L-row speculated segment per sequence (1 <= L <= 16) at absolute
// positions q_pos [B, L] against its materialized cache view of Tk rows
// (kv_pos [B, Tk] int32, bias [B, Tk] float32). dtype as above.
extern "C" int flash_verify_launch(const void* q, const void* k,
                                   const void* v, const int* kv_pos,
                                   const float* bias, const int* q_pos,
                                   void* out, int B, int L, int Tk, int Hq,
                                   int Hkv, int D, int window, int dtype,
                                   float scale, void* stream) {
  if (B < 1 || L < 1 || L > VL_MAX || Tk < 1 || Hkv < 1 || Hq % Hkv)
    return (int)cudaErrorInvalidValue;
  VParams p{q, k, v, kv_pos, bias, q_pos, out, B, L, Tk, Hq, Hkv, window,
            scale};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (D == 128)
    e = dtype == 1 ? launch_verify<__nv_bfloat16, 128>(p, st)
                   : launch_verify<float, 128>(p, st);
  else if (D == 64)
    e = dtype == 1 ? launch_verify<__nv_bfloat16, 64>(p, st)
                   : launch_verify<float, 64>(p, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
