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
// causal T = 2048 is ~2*T^2*D flops per head (half the square). Only the
// tensor cores reach that rate: the card's f32 CUDA cores give 67 TFLOP/s
// against 989 in bf16.
//
// Design (bf16, `flash_prefill_mma_kernel`), FlashAttention-2 shaped: one
// CTA of 4 warps per (64-row query tile, query head, sequence), each warp
// 16 query rows; the CTA loops over 64-row key tiles from the window's
// start up to the causal diagonal of its last absolute row — the loop
// replaces the TPU's sequential kv grid axis, and fully masked tiles are
// never visited. GQA maps query head h to kv head h / Gq. Q, K and V
// tiles are bf16 in shared memory in an XOR-swizzled layout (16-byte
// chunk c of row r at chunk c ^ (r % 8): ldmatrix reads conflict-free),
// filled by 16-byte cp.async copies (rows past the end zero-filled) in a
// two-stage ring, so the next key tile loads while this one computes.
// S = Q K^T and O += P V run on mma.sync.m16n8k16 (bf16 in, f32
// accumulate), fed by ldmatrix (V transposed on the load); S and O stay in
// registers, and the online softmax (exp2 of log2e-scaled scores, finite
// -1e30 mask) reuses S's accumulator layout as PV's A operand. P is
// split into a bf16 high part and a bf16 remainder, two products into
// the same accumulator: rounding P to one bf16 (FlashAttention's choice)
// leaves ~2^-9 relative error per weight, more than the plain version's
// bound allows where a row of few keys cancels; the pair keeps ~16 bits.
// Query tiles are issued longest first (the diagonal tiles near the end
// of the prompt do the most work), which evens out the causal imbalance.
// A masked key's weight is exactly 0 and every row a tile holds is finite
// (rows past Tk are zero-filled by the copy; a segment's tiles end at its
// last row), so chunked segments stay bit-equal to the monolithic run.
// wgmma with TMA and warp specialisation is the next step (ROADMAP B).
//
// f32 keeps a scalar body (`flash_prefill_kernel<float, D>`): it serves
// the f32 correctness gates only, which bf16 tensor cores (or TF32)
// cannot reproduce. Each thread owns a 4-row x (D/16)-column block of the
// output accumulator and a 4x4 block of every score tile; Q/K/V tiles
// and the probability tile live in shared memory as f32.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

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

// ---- bf16 on tensor cores ------------------------------------------------

constexpr int MT = 128;   // 4 warps x 16 query rows

using bf16 = __nv_bfloat16;

template <int D>
constexpr size_t mma_smem_bytes() {   // Q tile + 2 stages of K and V
  return sizeof(bf16) * (BQ * D + 2 * 2 * BK * D);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared; src_bytes 0 zero-fills
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}
__device__ __forceinline__ void ldsm_x4(unsigned addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// c[16x8] += a[16x16] * b[16x8], bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
// (x0, x1) as a bf16 pair, and the pair of what that rounding left
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - f.x, x1 - f.y);
}

// element offset of 16-byte chunk c of row r in a swizzled [rows][D] tile
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((c ^ (r & 7)) << 3);
}

// rows r0 .. r0+ROWS-1 of a [rows, *, D] bf16 tensor (row stride
// `stride` elements) into a swizzled tile; rows >= n_rows become zeros
template <int D, int ROWS = BK>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* base,
                                          size_t stride, int r0, int n_rows,
                                          int t) {
  constexpr int CPR = D / 8;
#pragma unroll
  for (int i = t; i < ROWS * CPR; i += MT) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = r0 + r < n_rows;
    const bf16* src = base + (size_t)(ok ? r0 + r : 0) * stride + c * 8;
    cp_async16(smem_u32(tile + swz<D>(r, c)), src, ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(MT) flash_prefill_mma_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int NK = D / 16;        // k-steps of QK^T; n-tile pairs of PV
  constexpr int NS = BK / 8;        // n-tiles of a score row block
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* KV = Qs + BQ * D;           // stage s: K at KV + 2*s*BK*D, V after

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest tiles first
  const int hq = blockIdx.y, b = blockIdx.z;
  const int Gq = p.Hq / p.Hkv, hk = hq / Gq;
  const int Tq = p.Tq, Tk = p.Tk;
  const int q0 = qt * BQ;                // first segment row of the tile
  const int qa0 = p.q_offset + q0;       // its absolute position
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int g = lane >> 2, tig = lane & 3;
  const size_t qstride = (size_t)p.Hq * D, kstride = (size_t)p.Hkv * D;
  const bf16* qg = (const bf16*)p.q + ((size_t)b * Tq * p.Hq + hq) * D;
  const bf16* kg = (const bf16*)p.k + ((size_t)b * Tk * p.Hkv + hk) * D;
  const bf16* vg = (const bf16*)p.v + ((size_t)b * Tk * p.Hkv + hk) * D;

  // key tiles kt_begin .. kt_end: the window's first tile that any row of
  // this tile sees, up to the tile of the last key its last row sees
  const int q_last = p.q_offset + min(q0 + BQ, Tq) - 1;
  const int kt_end = min(q_last, Tk - 1) / BK;
  int kt_begin = 0;
  if (p.window > 0 && qa0 - p.window >= BK - 1)
    kt_begin = (qa0 - p.window - (BK - 1)) / BK + 1;
  const int n_tiles = kt_end - kt_begin + 1;

  load_tile<D>(Qs, qg, qstride, q0, Tq, t);
  load_tile<D>(KV, kg, kstride, kt_begin * BK, Tk, t);
  load_tile<D>(KV + BK * D, vg, kstride, kt_begin * BK, Tk, t);
  cp_async_commit();

  uint32_t qf[NK][4];
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  const float sl2 = p.scale * 1.4426950408889634f;   // scale * log2(e)
  const int wrow = qa0 + warp * 16;                    // warp's first row
  const int row0 = wrow + g;                           // and row0 + 8

  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = (kt_begin + i) * BK;
    cp_async_wait_all();   // tile i (and Q) landed for this thread
    __syncthreads();       // for every thread; stage (i+1)&1 is free
    if (i + 1 < n_tiles) {
      bf16* nk = KV + ((i + 1) & 1) * 2 * BK * D;
      load_tile<D>(nk, kg, kstride, k0 + BK, Tk, t);
      load_tile<D>(nk + BK * D, vg, kstride, k0 + BK, Tk, t);
    }
    cp_async_commit();
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
        ldsm_x4(smem_u32(Qs + swz<D>(warp * 16 + (lane & 15),
                                     kk * 2 + (lane >> 4))), qf[kk]);
    }
    const bf16* Ks = KV + (i & 1) * 2 * BK * D;
    const bf16* Vs = Ks + BK * D;

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
      for (int nn = 0; nn < NS / 2; ++nn) {
        uint32_t bk[4];
        ldsm_x4(smem_u32(Ks + swz<D>(nn * 16 + (lane & 7) + ((lane >> 4) << 3),
                                     kk * 2 + ((lane >> 3) & 1))), bk);
        mma16816(s[2 * nn], qf[kk], bk[0], bk[1]);
        mma16816(s[2 * nn + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // mask (only tiles the diagonal, the window edge or the end cuts),
    // then the online softmax of the thread's rows row0 and row0 + 8
    const bool whole = k0 + BK - 1 <= wrow && k0 + BK <= Tk
                       && (p.window == 0 || k0 > wrow + 15 - p.window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sl2;
        if (!whole) {
          const int kpos = k0 + n * 8 + 2 * tig + (e & 1);
          const int qpos = row0 + (e >> 1) * 8;
          bool ok = kpos <= qpos && kpos < Tk;
          if (p.window > 0) ok = ok && kpos > qpos - p.window;
          x = ok ? x : NEG_INF;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the 4 threads of a row are the 4 lanes of a quad
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = exp2f(s[n][e] - m_r[e >> 1]);
        s[n][e] = pv;
        rs[e >> 1] += pv;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + rs[r];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: S's accumulators of n-tiles 2kk, 2kk+1 are the A operand
    // of key step kk
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ah[4], al[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], al[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
      for (int dd = 0; dd < NK; ++dd) {
        uint32_t bv[4];
        ldsm_x4_t(smem_u32(Vs + swz<D>(kk * 16 + (lane & 7)
                                           + (((lane >> 3) & 1) << 3),
                                       dd * 2 + (lane >> 4))), bv);
        mma16816(o[2 * dd], ah, bv[0], bv[1]);
        mma16816(o[2 * dd], al, bv[0], bv[1]);
        mma16816(o[2 * dd + 1], ah, bv[2], bv[3]);
        mma16816(o[2 * dd + 1], al, bv[2], bv[3]);
      }
    }
  }

  bf16* og = (bf16*)p.out;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float l_i = fmaxf(l, 1e-30f);
    const int qrow = q0 + warp * 16 + g + r * 8;
    if (qrow >= Tq) continue;
    bf16* orow = og + (((size_t)b * Tq + qrow) * p.Hq + hq) * D + 2 * tig;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(o[n][2 * r] / l_i, o[n][2 * r + 1] / l_i);
  }
}

template <typename K>
cudaError_t opt_in(K kernel, size_t smem, bool& configured) {
  if (configured) return cudaSuccess;   // >48 KB needs the opt-in, once
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  configured = e == cudaSuccess;
  return e;
}

template <int D>
cudaError_t launch(const Params& p, bool bf16_in, cudaStream_t st) {
  dim3 grid((p.Tq + BQ - 1) / BQ, p.Hq, p.B);
  if (bf16_in) {
    static bool configured = false;
    constexpr size_t smem = mma_smem_bytes<D>();
    cudaError_t e = opt_in(flash_prefill_mma_kernel<D>, smem, configured);
    if (e != cudaSuccess) return e;
    flash_prefill_mma_kernel<D><<<grid, MT, smem, st>>>(p);
  } else {
    static bool configured = false;
    constexpr size_t smem = smem_bytes<D>();
    cudaError_t e = opt_in(flash_prefill_kernel<float, D>, smem, configured);
    if (e != cudaSuccess) return e;
    flash_prefill_kernel<float, D><<<grid, NT, smem, st>>>(p);
  }
  return cudaGetLastError();
}

int launch_any(const Params& p, int D, int dtype, void* stream) {
  if (p.Tq < 1 || p.Tk < 1 || p.q_offset < 0 || p.q_offset + p.Tq > p.Tk
      || p.Hkv < 1 || p.Hq % p.Hkv)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (D == 128)
    e = launch<128>(p, dtype == 1, st);
  else if (D == 64)
    e = launch<64>(p, dtype == 1, st);
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
// shape), so every K/V element read does only 2*Gq*L multiply-adds; at
// B 8, Tk 2112, Hkv 8, D 128 in bf16 the kernel reads ~69 MB of K/V
// (20.7 us at 3.35 TB/s) against 1.4 GFLOP (1.4 us on the tensor cores).
//
// Design (split-KV, like the decode kernel). The Gq query heads sharing a
// kv head and the L segment rows are packed into rows r = t*Gq + g, so
// granite-8b's 4 x 5 = 20 rows fill one 32-row tile and each K/V tile is
// read once for all of them (any L <= 16; Gq*L > 32 takes several row
// tiles). The key axis of each (sequence, kv head, row tile) is cut into
// n_split splits of whole 32-key tiles (the wrapper's `verify_splits`: as
// many as fill one wave of 4 CTAs an SM; 8 at the serve shape, 512 CTAs
// where one CTA per row tile gave 64), one CTA of 4 warps each. Inside a
// split, K/V tiles stream through a two-stage ring of 16-byte cp.async
// copies in their own dtype (keys past the split zero-filled), with each
// key's kv_pos and bias, so the next tile loads while this one computes.
//
// bf16 (`flash_verify_mma_kernel`): the score and PV products run on
// mma.sync.m16n8k16 (bf16 in, f32 accumulate) fed by ldmatrix from
// XOR-swizzled tiles, as in the prefill kernel. Warp w takes query rows
// 16*(w%2) .. +15 of the tile against keys 16*(w/2) .. +15 of every key
// tile: each warp keeps its own online softmax over its half of the keys
// (no cross-warp step per tile), and the two halves merge through shared
// memory at the end of the split. P is split into a bf16 high part and
// a bf16 remainder, two products into one accumulator (~16 bits of P,
// as in the prefill kernel: one bf16 P misses the bf16 bound where a row
// of few keys cancels). f32 (`flash_verify_f32_kernel`, the correctness
// gates only): a scalar body, each thread a 4-row x 2-key block of the
// score tile and a 4-row x (D/16)-column block of the output.
//
// Masking, exact: a masked key scores the finite -1e30 and takes part in
// the softmax; a key past the split's end (the tail of the last split)
// takes none (p = 0). So a row with no visible key averages over exactly
// Tk keys, and a split whose keys are all masked for a row has m = -1e30
// and weight exp(m - M) = 0 as soon as another split holds a visible key.
//
// Combine, in the same launch and deterministic: each CTA writes its
// (acc[D], m, l) per row to a caller-allocated f32 scratch, then takes a
// ticket from a per-(sequence, kv head, row tile) int32 counter (zero
// between launches; the last CTA resets it). The last CTA to arrive
// merges the partials in split order, whatever order they arrived in, and
// writes `out`. No atomics on data: only the ticket.

namespace {

constexpr int VQ = 32;        // packed query rows per CTA
// VK and V_SPLIT_MAX are kernels/build.py's SPLIT_TILE and SPLIT_MAX (the
// launch refuses a split that breaks them)
constexpr int VK = 32;        // keys per tile; a split is whole tiles
constexpr int VT = 128;       // threads per CTA
constexpr int VL_MAX = 16;
constexpr int V_SPLIT_MAX = 64;

struct VParams {
  const void* q;       // [B, L, Hq, D]
  const void* k;       // [B, Tk, Hkv, D]
  const void* v;
  const int* kv_pos;   // [B, Tk]
  const float* bias;   // [B, Tk]
  const int* q_pos;    // [B, L]
  void* out;           // [B, L, Hq, D]
  float* part;         // [B*Hkv*n_rt, n_split, VQ, D+4]: acc[D], m, l, pad
  int* tickets;        // [B*Hkv*n_rt], zero between launches
  int B, L, Tk, Hq, Hkv, window, n_rt, n_split, split_len;
  float scale;
};

// element offset of packed row rr (segment row rr / Gq, query head
// hk*Gq + rr % Gq) of sequence b in q / out
__device__ __forceinline__ size_t vrow(const VParams& p, int b, int hk,
                                       int Gq, int rr, int D) {
  return (((size_t)b * p.L + rr / Gq) * p.Hq + hk * Gq + rr % Gq) * D;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src));
}

// kv_pos and bias of keys k0 .. k0+VK-1 (keys >= ke: INT_MAX and 0)
__device__ __forceinline__ void load_meta(int* kp, float* bs,
                                          const VParams& p, int b, int k0,
                                          int ke, int t) {
  if (t < VK) {
    const int key = k0 + t;
    if (key < ke) {
      cp_async4(kp + t, p.kv_pos + (size_t)b * p.Tk + key);
      cp_async4(bs + t, p.bias + (size_t)b * p.Tk + key);
    } else {
      kp[t] = INT_MAX;
      bs[t] = 0.f;
    }
  }
}

__device__ __forceinline__ bool visible(int kp, int qp, int window) {
  return kp <= qp && (window <= 0 || kp > qp - window);
}

// The last CTA of a (sequence, kv head, row tile): merge the n_split
// partials in split order and write the tile's rows of `out`. ws: shared
// memory for 2 * n_split * VQ floats.
template <typename T, int D>
__device__ void verify_merge(const VParams& p, size_t bhr, int b, int hk,
                             int Gq, int r0, int R, float* ws) {
  constexpr int PS = D + 4, D4 = D / 4;
  __shared__ float L_s[VQ];
  const int t = threadIdx.x, ns = p.n_split, nr = min(VQ, R - r0);
  const float* parts = p.part + bhr * ns * VQ * PS;
  float* w_s = ws;             // [ns, VQ]: each split's m, then its weight
  float* l_s = ws + ns * VQ;   // [ns, VQ]
  for (int i = t; i < ns * VQ; i += VT) {
    if (i % VQ < nr) {
      w_s[i] = __ldcg(parts + (size_t)i * PS + D);
      l_s[i] = __ldcg(parts + (size_t)i * PS + D + 1);
    }
  }
  __syncthreads();
  if (t < nr) {
    float M = -INFINITY, Ls = 0.f;
    for (int s = 0; s < ns; ++s) M = fmaxf(M, w_s[s * VQ + t]);
    for (int s = 0; s < ns; ++s) {
      const float w = expf(w_s[s * VQ + t] - M);
      w_s[s * VQ + t] = w;
      Ls += l_s[s * VQ + t] * w;
    }
    L_s[t] = fmaxf(Ls, 1e-30f);
  }
  __syncthreads();
  T* og = (T*)p.out;
  for (int x = t; x < nr * D4; x += VT) {
    const int r = x / D4, d0 = (x % D4) * 4;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int s = 0; s < ns; ++s) {
      const float4 a = __ldcg(reinterpret_cast<const float4*>(
          parts + ((size_t)s * VQ + r) * PS + d0));
      const float w = w_s[s * VQ + r];
      o[0] += a.x * w;
      o[1] += a.y * w;
      o[2] += a.z * w;
      o[3] += a.w * w;
    }
    T* dst = og + vrow(p, b, hk, Gq, r0 + r, D) + d0;
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[e] = from_f32<T>(o[e] / L_s[r]);
  }
}

// After the CTA's partial is written: the last CTA of its (b, hk, row
// tile) to arrive merges (true), the others leave (false).
__device__ __forceinline__ bool verify_ticket(const VParams& p, size_t bhr) {
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(p.tickets + bhr, 1) == p.n_split - 1;
  __syncthreads();
  if (!is_last) return false;
  __threadfence();
  if (threadIdx.x == 0) p.tickets[bhr] = 0;   // zero for the next launch
  return true;
}

// ---- bf16 on tensor cores ------------------------------------------------

template <int D>
struct VerifyMma {
  static constexpr int TILE = VK * D;                        // elements
  static constexpr int STAGE = 2 * TILE * 2 + VK * 8;        // K, V, meta
  static constexpr int Q_BYTES = VQ * D * 2;
  static constexpr int BYTES = Q_BYTES + 2 * STAGE;
  // the end-of-split half merge and the split merge reuse the stages
  static_assert(2 * 32 * (D / 2 + 4) * 4 <= 2 * STAGE, "half merge fits");
  static_assert(2 * V_SPLIT_MAX * VQ * 4 <= 2 * STAGE, "split merge fits");
};

// 4 CTAs an SM (the wave `verify_splits` sizes the grid for): at most 128
// registers a thread
template <int D>
__global__ void __launch_bounds__(VT, 4) flash_verify_mma_kernel(VParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  using LY = VerifyMma<D>;
  constexpr int NK = D / 16, NO = D / 8, PS = D + 4;
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  unsigned char* stage0 = smem_raw + LY::Q_BYTES;

  const int split = blockIdx.x % p.n_split, rt = blockIdx.x / p.n_split;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int Gq = p.Hq / p.Hkv, R = Gq * p.L, r0 = rt * VQ;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int mt = warp & 1, kh = warp >> 1;   // row half, key half
  const int g = lane >> 2, tig = lane & 3;
  const int kb = split * p.split_len, ke = min(p.Tk, kb + p.split_len);
  const int n_tiles = (ke - kb + VK - 1) / VK;
  const size_t kstride = (size_t)p.Hkv * D;
  const size_t kvo = ((size_t)b * p.Tk * p.Hkv + hk) * D;
  const bf16* kg = (const bf16*)p.k + kvo;
  const bf16* vg = (const bf16*)p.v + kvo;

  {  // the tile's query rows, swizzled; rows past R zero-filled
    constexpr int CPR = D / 8;
    const bf16* qg = (const bf16*)p.q;
    for (int i = t; i < VQ * CPR; i += VT) {
      const int r = i / CPR, c = i % CPR, rr = r0 + r;
      const bool ok = rr < R;
      cp_async16(smem_u32(Qs + swz<D>(r, c)),
                 qg + (ok ? vrow(p, b, hk, Gq, rr, D) : 0) + c * 8,
                 ok ? 16 : 0);
    }
  }
  auto issue = [&](int i) {
    unsigned char* st = stage0 + (i & 1) * LY::STAGE;
    bf16* Ks = reinterpret_cast<bf16*>(st);
    int* kp = reinterpret_cast<int*>(Ks + 2 * LY::TILE);
    const int k0 = kb + i * VK;
    load_tile<D, VK>(Ks, kg, kstride, k0, ke, t);
    load_tile<D, VK>(Ks + LY::TILE, vg, kstride, k0, ke, t);
    load_meta(kp, reinterpret_cast<float*>(kp + VK), p, b, k0, ke, t);
  };
  issue(0);
  cp_async_commit();

  // the thread's two rows (g and g + 8 of the warp's 16): their positions
  // (a row past R sees every key; it is never written)
  int qpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = r0 + mt * 16 + g + r * 8;
    qpos[r] = rr < R ? p.q_pos[(size_t)b * p.L + rr / Gq] : INT_MAX;
  }
  const bool active = r0 + mt * 16 < R;   // the warp holds a query row
  uint32_t qf[NK][4];
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait_all();   // tile i (and Q) landed for this thread
    __syncthreads();       // for every thread; stage (i+1)&1 is free
    if (i + 1 < n_tiles) issue(i + 1);
    cp_async_commit();
    if (!active) continue;
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
        ldsm_x4(smem_u32(Qs + swz<D>(mt * 16 + (lane & 15),
                                     kk * 2 + (lane >> 4))), qf[kk]);
    }
    const unsigned char* st = stage0 + (i & 1) * LY::STAGE;
    const bf16* Ks = reinterpret_cast<const bf16*>(st);
    const bf16* Vs = Ks + LY::TILE;
    const int* kp = reinterpret_cast<const int*>(Vs + LY::TILE);
    const float* bs = reinterpret_cast<const float*>(kp + VK);
    const int k0 = kb + i * VK;

    // S = Q K^T over the warp's 16 keys kh*16 .. kh*16+15
    float s[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t bk[4];
      ldsm_x4(smem_u32(Ks + swz<D>(kh * 16 + (lane & 7) + ((lane >> 4) << 3),
                                   kk * 2 + ((lane >> 3) & 1))), bk);
      mma16816(s[0], qf[kk], bk[0], bk[1]);
      mma16816(s[1], qf[kk], bk[2], bk[3]);
    }

    // scale, bias, mask; the online softmax of rows g and g + 8
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = kh * 16 + n * 8 + 2 * tig + (e & 1);
        float x = visible(kp[c], qpos[e >> 1], p.window)
                      ? s[n][e] * p.scale + bs[c] : NEG_INF;
        x = k0 + c < ke ? x : -INFINITY;   // past the split: no part
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the 4 threads of a row are the 4 lanes of a quad
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = expf(m_r[r] - m_new);
      m_r[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = expf(s[n][e] - m_r[e >> 1]);
        s[n][e] = pv;
        rs[e >> 1] += pv;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + rs[r];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V over the warp's 16 keys: S's accumulators are the A operand
    uint32_t ah[4], al[4];
    split_bf16(s[0][0], s[0][1], ah[0], al[0]);
    split_bf16(s[0][2], s[0][3], ah[1], al[1]);
    split_bf16(s[1][0], s[1][1], ah[2], al[2]);
    split_bf16(s[1][2], s[1][3], ah[3], al[3]);
#pragma unroll
    for (int dd = 0; dd < NK; ++dd) {
      uint32_t bv[4];
      ldsm_x4_t(smem_u32(Vs + swz<D>(kh * 16 + (lane & 7)
                                         + (((lane >> 3) & 1) << 3),
                                     dd * 2 + (lane >> 4))), bv);
      mma16816(o[2 * dd], ah, bv[0], bv[1]);
      mma16816(o[2 * dd], al, bv[0], bv[1]);
      mma16816(o[2 * dd + 1], ah, bv[2], bv[3]);
      mma16816(o[2 * dd + 1], al, bv[2], bv[3]);
    }
  }
  cp_async_wait_all();
  __syncthreads();   // every stage consumed: the stages become scratch

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  // merge the key halves: warp (mt, 1) hands its state to warp (mt, 0),
  // lane for lane (the two hold the same rows and columns)
  float* red = reinterpret_cast<float*>(stage0) + mt * (NO * 4 + 4) * 32
               + lane;
  if (active && kh == 1) {
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(n * 4 + e) * 32] = o[n][e];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      red[(NO * 4 + r) * 32] = m_r[r];
      red[(NO * 4 + 2 + r) * 32] = l_r[r];
    }
  }
  __syncthreads();
  const size_t bhr = ((size_t)b * p.Hkv + hk) * p.n_rt + rt;
  if (active && kh == 0) {
    float* part = p.part + (bhr * p.n_split + split) * VQ * PS;
    float w0[2], w1[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = red[(NO * 4 + r) * 32];
      const float M = fmaxf(m_r[r], m1);
      w0[r] = expf(m_r[r] - M);
      w1[r] = expf(m1 - M);
      l_r[r] = l_r[r] * w0[r] + red[(NO * 4 + 2 + r) * 32] * w1[r];
      m_r[r] = M;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = mt * 16 + g + r * 8;
      if (r0 + row >= R) continue;
      float* dst = part + (size_t)row * PS;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<float2*>(dst + n * 8 + 2 * tig) = make_float2(
            o[n][2 * r] * w0[r] + red[(n * 4 + 2 * r) * 32] * w1[r],
            o[n][2 * r + 1] * w0[r] + red[(n * 4 + 2 * r + 1) * 32] * w1[r]);
      if (tig == 0) {
        dst[D] = m_r[r];
        dst[D + 1] = l_r[r];
      }
    }
  }
  if (verify_ticket(p, bhr))
    verify_merge<bf16, D>(p, bhr, b, hk, Gq, r0, R,
                          reinterpret_cast<float*>(stage0));
}

// ---- f32: a scalar body (the correctness gates) ----------------------------

template <int D>
struct VerifyF32 {
  static constexpr int QS = D + 4, KS = D + 4, PS = VK + 1;  // float strides
  static constexpr int STAGE = (VK * KS + VK * D) * 4 + VK * 8;
  static constexpr int HEAD = (VQ * QS + VQ * PS) * 4;
  static constexpr int BYTES = HEAD + 2 * STAGE;
  static_assert(HEAD % 16 == 0 && STAGE % 16 == 0, "16-byte copies");
  static_assert(2 * V_SPLIT_MAX * VQ * 4 <= 2 * STAGE, "split merge fits");
};

// rows k0 .. k0+VK-1 of a [rows, *, D] f32 tensor into a [VK][ld] tile;
// rows >= n_rows zero-filled
template <int D>
__device__ __forceinline__ void load_tile_f32(float* tile, int ld,
                                              const float* base,
                                              size_t stride, int k0,
                                              int n_rows, int t) {
  constexpr int CPR = D / 4;
  for (int i = t; i < VK * CPR; i += VT) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = k0 + r < n_rows;
    cp_async16(smem_u32(tile + r * ld + c * 4),
               base + (size_t)(ok ? k0 + r : 0) * stride + c * 4,
               ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(VT) flash_verify_f32_kernel(VParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  using LY = VerifyF32<D>;
  constexpr int QS = LY::QS, KS = LY::KS, PS = LY::PS, DJ = D / 16;
  constexpr int PPS = D + 4;   // partial row
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ps = Qs + VQ * QS;
  unsigned char* stage0 = smem_raw + LY::HEAD;

  const int split = blockIdx.x % p.n_split, rt = blockIdx.x / p.n_split;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int Gq = p.Hq / p.Hkv, R = Gq * p.L, r0 = rt * VQ;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int kb = split * p.split_len, ke = min(p.Tk, kb + p.split_len);
  const int n_tiles = (ke - kb + VK - 1) / VK;
  const size_t kstride = (size_t)p.Hkv * D;
  const size_t kvo = ((size_t)b * p.Tk * p.Hkv + hk) * D;
  const float* kg = (const float*)p.k + kvo;
  const float* vg = (const float*)p.v + kvo;

  {
    constexpr int CPR = D / 4;
    const float* qg = (const float*)p.q;
    for (int i = t; i < VQ * CPR; i += VT) {
      const int r = i / CPR, c = i % CPR, rr = r0 + r;
      const bool ok = rr < R;
      cp_async16(smem_u32(Qs + r * QS + c * 4),
                 qg + (ok ? vrow(p, b, hk, Gq, rr, D) : 0) + c * 4,
                 ok ? 16 : 0);
    }
  }
  auto issue = [&](int i) {
    float* Ks = reinterpret_cast<float*>(stage0 + (i & 1) * LY::STAGE);
    float* Vs = Ks + VK * KS;
    int* kp = reinterpret_cast<int*>(Vs + VK * D);
    const int k0 = kb + i * VK;
    load_tile_f32<D>(Ks, KS, kg, kstride, k0, ke, t);
    load_tile_f32<D>(Vs, D, vg, kstride, k0, ke, t);
    load_meta(kp, reinterpret_cast<float*>(kp + VK), p, b, k0, ke, t);
  };
  issue(0);
  cp_async_commit();

  int qpos[4];
  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = r0 + ty * 4 + i;
    qpos[i] = rr < R ? p.q_pos[(size_t)b * p.L + rr / Gq] : INT_MAX;
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();   // tile it landed; the other stage and P are free
    if (it + 1 < n_tiles) issue(it + 1);
    cp_async_commit();
    const float* Ks = reinterpret_cast<const float*>(
        stage0 + (it & 1) * LY::STAGE);
    const float* Vs = Ks + VK * KS;
    const int* kp = reinterpret_cast<const int*>(Vs + VK * D);
    const float* bs = reinterpret_cast<const float*>(kp + VK);
    const int k0 = kb + it * VK;

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * QS + d);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * KS + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = tx + 16 * j;
        float x = visible(kp[c], qpos[i], p.window)
                      ? s[i][j] * p.scale + bs[c] : NEG_INF;
        x = k0 + c < ke ? x : -INFINITY;   // past the split: no part
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // the 16 threads of one row are 16 consecutive lanes of a warp
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
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

    for (int c = 0; c < VK; ++c) {
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
  cp_async_wait_all();
  __syncthreads();   // the stages become the merge's scratch

  const size_t bhr = ((size_t)b * p.Hkv + hk) * p.n_rt + rt;
  float* part = p.part + (bhr * p.n_split + split) * VQ * PPS;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty * 4 + i;
    if (r0 + row >= R) continue;
    float* dst = part + (size_t)row * PPS;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dst[tx + 16 * j] = acc[i][j];
    if (tx == 0) {
      dst[D] = m[i];
      dst[D + 1] = l[i];
    }
  }
  if (verify_ticket(p, bhr))
    verify_merge<float, D>(p, bhr, b, hk, Gq, r0, R,
                           reinterpret_cast<float*>(stage0));
}

template <int D>
cudaError_t launch_verify(const VParams& p, bool bf16_in, cudaStream_t st) {
  dim3 grid(p.n_rt * p.n_split, p.Hkv, p.B);
  if (bf16_in) {
    static bool configured = false;
    constexpr size_t smem = VerifyMma<D>::BYTES;
    cudaError_t e = opt_in(flash_verify_mma_kernel<D>, smem, configured);
    if (e != cudaSuccess) return e;
    flash_verify_mma_kernel<D><<<grid, VT, smem, st>>>(p);
  } else {
    static bool configured = false;
    constexpr size_t smem = VerifyF32<D>::BYTES;
    cudaError_t e = opt_in(flash_verify_f32_kernel<D>, smem, configured);
    if (e != cudaSuccess) return e;
    flash_verify_f32_kernel<D><<<grid, VT, smem, st>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// One L-row speculated segment per sequence (1 <= L <= 16) at absolute
// positions q_pos [B, L] against its materialized cache view of Tk rows
// (kv_pos [B, Tk] int32, bias [B, Tk] float32). dtype as above. The key
// axis splits into n_split <= 64 runs of split_len keys (split_len whole
// 32-key tiles; the last run may be shorter), none empty. part: f32
// scratch [B*Hkv*n_rt, n_split, 32, D+4] (or larger) with n_rt =
// ceil(Hq/Hkv*L / 32); tickets: int32
// [B*Hkv*n_rt], zero before the launch and zero again after it.
extern "C" int flash_verify_launch(const void* q, const void* k,
                                   const void* v, const int* kv_pos,
                                   const float* bias, const int* q_pos,
                                   void* out, void* part, void* tickets,
                                   int B, int L, int Tk, int Hq, int Hkv,
                                   int D, int window, int dtype, int n_split,
                                   int split_len, float scale, void* stream) {
  if (B < 1 || L < 1 || L > VL_MAX || Tk < 1 || Hkv < 1 || Hq % Hkv
      || n_split < 1 || n_split > V_SPLIT_MAX || split_len < 1
      || split_len % VK || (long)(n_split - 1) * split_len >= Tk
      || (long)n_split * split_len < Tk)
    return (int)cudaErrorInvalidValue;
  const int n_rt = ((Hq / Hkv) * L + VQ - 1) / VQ;
  VParams p{q, k, v, kv_pos, bias, q_pos, out, (float*)part, (int*)tickets,
            B, L, Tk, Hq, Hkv, window, n_rt, n_split, split_len, scale};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (D == 128)
    e = launch_verify<128>(p, dtype == 1, st);
  else if (D == 64)
    e = launch_verify<64>(p, dtype == 1, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}
