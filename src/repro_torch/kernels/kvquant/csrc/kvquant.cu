// Fused KIVI quantize-and-pack: keys per channel over G-row groups
// (`kquant_launch`), values per token over the head dim (`vquant_launch`).
//
// Replaces: src/repro/kernels/kvquant/kernel.py:kquant_pallas (body
// `_kquant_kernel`) and :vquant_pallas (body `_vquant_kernel`), both
// through `_pack_along_last`. On the serving path they quantize the
// residual ring at each KIVI flush and the selected prompt rows at each
// quantized admission (`core/cache.py:plan_group_flush`,
// `compress_prompt`).
//
// What it computes (the Pallas kernels' function, and the port's plain
// `core/quantization.py` + `pack_codes`): lo / hi = min / max of the f32
// inputs over the reduced axis, scale = max(hi - lo, 1e-8) / levels with
// levels = 2^bits - 1, code = clip(rint((x - lo) / scale), 0, levels),
// rint rounding half to even as jnp.round / torch.round do. Codes go
// 8/bits to a byte along the head dim, little-endian in bit order, and
// the byte is stored biased by -128 as int8. Every division is IEEE
// (__fdiv_rn: no reciprocal, no fast-math), so on the same inputs the
// codes, scales and zeros are bit-equal to the plain version's when that
// divides exactly too. min / max are exact and each output is written by
// one thread in a fixed order: no atomics, so a block of a shared prefix
// quantizes identically in every admission.
//
// What bounds it on an H100: bytes. A handful of flops per element read
// (one subtract, one divide, one round, a shift) against 2-4 bytes read
// and bits/8 written: far below the ~295 flops/byte at which the card's
// arithmetic would be the limit.
//
// Design. kquant (one pass over device memory): a CTA of 128 threads per
// (16-channel slice, group, sequence), so the kivi2 ring flush of 8 slots
// ([8, 128, 8, 128]) runs 512 CTAs and the prompt compressions [1, 512 |
// 1920, 8, 128] 256 and 960 (32-byte slices of packed bytes gave 64, 32
// and 120 on 132 SMs). A thread owns one 16-byte chunk of a row (8 bf16 or 4 f32
// channels: whole packed bytes at 2, 4 and 8 bits) for the rows ty, ty +
// TY, ... of the group, loads each with one vector load and keeps up to
// KQ_RPT of them in registers, so the quantize pass reads no row again
// (a group longer than KQ_RPT * TY rows re-reads the rest). min / max
// fold over the warp's row lanes by shuffles, then over the warps through
// shared memory; each thread then writes its row's packed bytes in one
// store, row lanes 0 / 1 the chunk's scales / zeros. A row whose width
// is not a whole number of aligned chunks takes element loads and byte
// stores (the same arithmetic). (The previous design read each row
// twice, the second time from L2, with 2-byte loads: 0.0119 ms of device
// time at the flush shape on an H100.)
// vquant: one warp per (b, s, h) row; each lane owns
// packed bytes lane, lane+32, ... of the row, min / max reduce through
// warp shuffles (exact, order-independent), lane 0 writes scale / zero.
// The TPU kernel's grid over (b, group) ran in order on one core; here
// the channel slices and groups run in parallel, which the per-channel
// (K) and per-row (V) reductions allow.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int KQ_CW = 16;            // kquant channels per CTA
constexpr int KQ_NT = 128;           // kquant threads per CTA
constexpr int KQ_RPT = 4;            // kquant rows a thread keeps in registers
constexpr int VQ_WARPS = 8;          // vquant rows (warps) per CTA

template <typename T> __device__ __forceinline__ float ld(const T* p);
template <> __device__ __forceinline__ float ld<float>(const float* p) {
  return __ldg(p);
}
template <> __device__ __forceinline__ float ld<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float scale_of(float lo, float hi, int levels) {
  return __fdiv_rn(fmaxf(__fsub_rn(hi, lo), 1e-8f), (float)levels);
}

__device__ __forceinline__ uint32_t code_of(float x, float lo, float scale,
                                            int levels) {
  float c = rintf(__fdiv_rn(__fsub_rn(x, lo), scale));
  c = fminf(fmaxf(c, 0.0f), (float)levels);
  return (uint32_t)c;
}

// 16 bytes of k as raw bits: one vector load when `vec` (the chunk is
// whole and 16-byte aligned), else the chunk's nc elements one by one
// (the rest zero: they take no part)
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* p, int nc, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if constexpr (sizeof(T) == 4) {
    for (int e = 0; e < 4; ++e)
      if (e < nc) w[e] = __ldg(reinterpret_cast<const unsigned*>(p) + e);
  } else {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
    for (int e = 0; e < 8; ++e)
      if (e < nc) w[e / 2] |= (uint32_t)__ldg(h + e) << (16 * (e % 2));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the chunk's 16 bytes as f32 channels (exact: bf16 is the top half of f32)
template <typename T>
__device__ __forceinline__ void expand(uint4 u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if constexpr (sizeof(T) == 4) {
      f[e] = __uint_as_float(w[e]);
    } else {
      f[2 * e] = __uint_as_float(w[e] << 16);
      f[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  }
}

// k [B, S, H*D] T -> codes [B, S, H*D*BITS/8] int8, scale / zero
// [B, S/G, H*D] f32. grid (ceil(HD / KQ_CW), S/G, B), KQ_NT threads:
// thread t owns the VEC-channel chunk c0 = x*KQ_CW + (t % TX)*VEC (16
// bytes of a row) of rows t / TX, t / TX + TY, ... of the group, and
// keeps the first KQ_RPT of them in registers between the two passes.
template <typename T, int BITS>
__global__ void __launch_bounds__(KQ_NT) kquant_kernel(
    const T* __restrict__ k, int8_t* __restrict__ codes,
    float* __restrict__ scale, float* __restrict__ zero, int S, int HD,
    int G, int vec_ok) {
  constexpr int VEC = 16 / (int)sizeof(T);   // channels a 16-byte load
  constexpr int F = 8 / BITS;                // channels a packed byte
  constexpr int NB = VEC / F;                // packed bytes a chunk
  constexpr int TX = KQ_CW / VEC, TY = KQ_NT / TX, NW = KQ_NT / 32;
  constexpr int LEVELS = (1 << BITS) - 1;
  __shared__ float s_lo[NW][TX][VEC], s_hi[NW][TX][VEC];
  const int t = threadIdx.x, tx = t % TX, ty = t / TX;
  const int warp = t / 32, lane = t % 32;
  const int c0 = blockIdx.x * KQ_CW + tx * VEC;   // first channel
  const int nc = max(0, min(VEC, HD - c0));       // a tail chunk has fewer
  const bool vec = vec_ok && nc == VEC;
  const int g = blockIdx.y, b = blockIdx.z;
  const size_t row0 = (size_t)b * S + (size_t)g * G;
  const T* src = k + row0 * HD + c0;

  // pass 1: one 16-byte load a row, min / max per channel
  float lo[VEC], hi[VEC], f[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) { lo[e] = INFINITY; hi[e] = -INFINITY; }
  uint4 held[KQ_RPT];
  auto fold = [&](uint4 u) {
    expand<T>(u, f);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      if (e < nc) {
        lo[e] = fminf(lo[e], f[e]);
        hi[e] = fmaxf(hi[e], f[e]);
      }
  };
  if (nc > 0) {
#pragma unroll
    for (int i = 0; i < KQ_RPT; ++i) {
      const int r = ty + i * TY;
      if (r < G) held[i] = load_chunk(src + (size_t)r * HD, nc, vec);
    }
#pragma unroll
    for (int i = 0; i < KQ_RPT; ++i)
      if (ty + i * TY < G) fold(held[i]);
    for (int r = ty + KQ_RPT * TY; r < G; r += TY)   // G > KQ_RPT * TY
      fold(load_chunk(src + (size_t)r * HD, nc, vec));
  }
  // fold the row lanes: the warp's lanes of one chunk by shuffles, then
  // the warps through shared memory (min / max are exact: any order)
#pragma unroll
  for (int o = TX; o < 32; o <<= 1)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      lo[e] = fminf(lo[e], __shfl_xor_sync(0xffffffffu, lo[e], o));
      hi[e] = fmaxf(hi[e], __shfl_xor_sync(0xffffffffu, hi[e], o));
    }
  if (lane < TX) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      s_lo[warp][tx][e] = lo[e];
      s_hi[warp][tx][e] = hi[e];
    }
  }
  __syncthreads();
  if (nc == 0) return;   // a chunk past the row's end
  float sc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    lo[e] = s_lo[0][tx][e];
    hi[e] = s_hi[0][tx][e];
#pragma unroll
    for (int w = 1; w < NW; ++w) {
      lo[e] = fminf(lo[e], s_lo[w][tx][e]);
      hi[e] = fmaxf(hi[e], s_hi[w][tx][e]);
    }
    sc[e] = scale_of(lo[e], hi[e], LEVELS);
  }
  if (ty < 2) {   // row lane 0 writes the scales, row lane 1 the zeros
    float* dst = (ty == 0 ? scale : zero)
                 + ((size_t)b * (S / G) + g) * HD + c0;
    const float* val = ty == 0 ? sc : lo;
    if (vec) {
#pragma unroll
      for (int e = 0; e < VEC; e += 4)
        *reinterpret_cast<float4*>(dst + e) =
            make_float4(val[e], val[e + 1], val[e + 2], val[e + 3]);
    } else {
      for (int e = 0; e < nc; ++e) dst[e] = val[e];
    }
  }
  // pass 2: each row's NB packed bytes, one store
  int8_t* dst = codes + row0 * (HD / F) + c0 / F;
  auto put = [&](uint4 u, int r) {
    expand<T>(u, f);
    uint64_t word = 0;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      uint32_t packed = 0;
#pragma unroll
      for (int i = 0; i < F; ++i)
        packed |= code_of(f[j * F + i], lo[j * F + i], sc[j * F + i],
                          LEVELS) << (i * BITS);
      word |= (uint64_t)(uint8_t)((int)packed - 128) << (8 * j);
    }
    int8_t* out = dst + (size_t)r * (HD / F);
    if (vec) {
      if constexpr (NB == 8) *reinterpret_cast<uint64_t*>(out) = word;
      else if constexpr (NB == 4) *reinterpret_cast<uint32_t*>(out) =
          (uint32_t)word;
      else if constexpr (NB == 2) *reinterpret_cast<uint16_t*>(out) =
          (uint16_t)word;
      else *out = (int8_t)word;
    } else {
      for (int j = 0; j < nc / F; ++j) out[j] = (int8_t)(word >> (8 * j));
    }
  };
#pragma unroll
  for (int i = 0; i < KQ_RPT; ++i) {
    const int r = ty + i * TY;
    if (r < G) put(held[i], r);
  }
  for (int r = ty + KQ_RPT * TY; r < G; r += TY)
    put(load_chunk(src + (size_t)r * HD, nc, vec), r);
}

// v [R, D] T (R = B*S*H rows) -> codes [R, D*BITS/8] int8, scale / zero
// [R] f32. grid ceil(R / VQ_WARPS), VQ_WARPS warps per CTA.
template <typename T, int BITS>
__global__ void __launch_bounds__(VQ_WARPS * 32) vquant_kernel(
    const T* __restrict__ v, int8_t* __restrict__ codes,
    float* __restrict__ scale, float* __restrict__ zero, long long R,
    int D) {
  constexpr int F = 8 / BITS;
  constexpr int LEVELS = (1 << BITS) - 1;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * VQ_WARPS + (threadIdx.x >> 5);
  if (row >= R) return;                       // whole warp leaves together
  const int Dp = D / F;
  const T* src = v + row * D;
  float lo = INFINITY, hi = -INFINITY;
  for (int j = lane; j < Dp; j += 32) {
#pragma unroll
    for (int i = 0; i < F; ++i) {
      float x = ld(src + j * F + i);
      lo = fminf(lo, x);
      hi = fmaxf(hi, x);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  const float sc = scale_of(lo, hi, LEVELS);
  if (lane == 0) {
    scale[row] = sc;
    zero[row] = lo;
  }
  int8_t* dst = codes + row * Dp;
  for (int j = lane; j < Dp; j += 32) {
    uint32_t packed = 0;
#pragma unroll
    for (int i = 0; i < F; ++i)
      packed |= code_of(ld(src + j * F + i), lo, sc, LEVELS) << (i * BITS);
    dst[j] = (int8_t)((int)packed - 128);
  }
}

template <typename T>
int kquant_dispatch(const void* k, void* codes, void* scale, void* zero,
                    int B, int S, int HD, int G, int bits,
                    cudaStream_t st) {
  const dim3 grid((HD + KQ_CW - 1) / KQ_CW, S / G, B);
  const T* x = (const T*)k;
  int8_t* c = (int8_t*)codes;
  float* s = (float*)scale;
  float* z = (float*)zero;
  // 16-byte loads and stores need whole aligned chunks in every row
  const auto a16 = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  const int v = HD % (16 / (int)sizeof(T)) == 0 && a16(k) && a16(codes)
                && a16(scale) && a16(zero);
  if (bits == 2)
    kquant_kernel<T, 2><<<grid, KQ_NT, 0, st>>>(x, c, s, z, S, HD, G, v);
  else if (bits == 4)
    kquant_kernel<T, 4><<<grid, KQ_NT, 0, st>>>(x, c, s, z, S, HD, G, v);
  else if (bits == 8)
    kquant_kernel<T, 8><<<grid, KQ_NT, 0, st>>>(x, c, s, z, S, HD, G, v);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

template <typename T>
int vquant_dispatch(const void* v, void* codes, void* scale, void* zero,
                    long long R, int D, int bits, cudaStream_t st) {
  const unsigned grid = (unsigned)((R + VQ_WARPS - 1) / VQ_WARPS);
  const T* x = (const T*)v;
  int8_t* c = (int8_t*)codes;
  float* s = (float*)scale;
  float* z = (float*)zero;
  if (bits == 2)
    vquant_kernel<T, 2><<<grid, VQ_WARPS * 32, 0, st>>>(x, c, s, z, R, D);
  else if (bits == 4)
    vquant_kernel<T, 4><<<grid, VQ_WARPS * 32, 0, st>>>(x, c, s, z, R, D);
  else if (bits == 8)
    vquant_kernel<T, 8><<<grid, VQ_WARPS * 32, 0, st>>>(x, c, s, z, R, D);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// k: [B, S, H, D] contiguous, dtype 0 = f32, 1 = bf16; codes [B, S, H,
// D*bits/8] int8; scale / zero [B, S/G, H, D] f32. Needs S % G == 0 and
// D*bits % 8 == 0 (the wrapper checks; refused here too).
extern "C" int kquant_launch(const void* k, void* codes, void* scale,
                             void* zero, int B, int S, int H, int D, int G,
                             int bits, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || D < 1 || G < 1 || S % G ||
      (D * bits) % 8 || S / G > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return kquant_dispatch<float>(k, codes, scale, zero, B, S, H * D, G,
                                  bits, st);
  if (dtype == 1)
    return kquant_dispatch<__nv_bfloat16>(k, codes, scale, zero, B, S, H * D,
                                          G, bits, st);
  return (int)cudaErrorInvalidValue;
}

// v: [B, S, H, D] contiguous (read as B*S*H rows of D); codes [B, S, H,
// D*bits/8] int8; scale / zero [B, S, H] f32.
extern "C" int vquant_launch(const void* v, void* codes, void* scale,
                             void* zero, int B, int S, int H, int D,
                             int bits, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || D < 1 || (D * bits) % 8)
    return (int)cudaErrorInvalidValue;
  const long long R = (long long)B * S * H;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return vquant_dispatch<float>(v, codes, scale, zero, R, D, bits, st);
  if (dtype == 1)
    return vquant_dispatch<__nv_bfloat16>(v, codes, scale, zero, R, D, bits,
                                          st);
  return (int)cudaErrorInvalidValue;
}
