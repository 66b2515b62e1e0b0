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
// Design. kquant: a CTA per (slice of KQ_TX packed bytes, group,
// sequence); column tx owns packed byte j of the row, i.e. the 8/bits
// consecutive channels j*8/bits .. of the H*D row, so neighbouring threads
// read neighbouring addresses, and the KQ_TY row lanes split the group's
// G rows. Pass 1 takes each lane's min / max, folded through shared
// memory; pass 2 walks the rows again (from L2: a group is at most
// G*H*D*4 bytes) to quantize and write one byte per row; lane 0 writes
// the channels' scale and zero. (A first version walked all G rows in
// one thread per byte: 16 CTAs at the flush shape, 0.083 ms a call.) vquant: one warp per (b, s, h) row; each lane owns
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

constexpr int KQ_TX = 32;            // kquant packed bytes per CTA
constexpr int KQ_TY = 8;             // kquant row lanes per CTA
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

// k [B, S, H*D] T -> codes [B, S, H*D*BITS/8] int8, scale / zero
// [B, S/G, H*D] f32. grid (ceil(HDp / KQ_TX), S/G, B), block
// (KQ_TX, KQ_TY): thread (tx, ty) owns packed byte j = x*KQ_TX + tx of
// rows ty, ty + KQ_TY, ... of the group.
template <typename T, int BITS>
__global__ void __launch_bounds__(KQ_TX * KQ_TY) kquant_kernel(
    const T* __restrict__ k, int8_t* __restrict__ codes,
    float* __restrict__ scale, float* __restrict__ zero, int S, int HD,
    int G) {
  constexpr int F = 8 / BITS;
  constexpr int LEVELS = (1 << BITS) - 1;
  __shared__ float s_lo[KQ_TY][F][KQ_TX], s_hi[KQ_TY][F][KQ_TX];
  const int HDp = HD / F;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * KQ_TX + tx;                   // packed byte
  const bool live = j < HDp;        // the tail slice: no early return,
                                    // every thread reaches the barriers
  const int g = blockIdx.y, b = blockIdx.z;
  const size_t row0 = (size_t)b * S + (size_t)g * G;
  const T* src = k + row0 * HD + (size_t)j * F;
  float lo[F], hi[F];
#pragma unroll
  for (int i = 0; i < F; ++i) { lo[i] = INFINITY; hi[i] = -INFINITY; }
  if (live) {
    for (int r = ty; r < G; r += KQ_TY) {
#pragma unroll
      for (int i = 0; i < F; ++i) {
        float x = ld(src + (size_t)r * HD + i);
        lo[i] = fminf(lo[i], x);
        hi[i] = fmaxf(hi[i], x);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < F; ++i) {
    s_lo[ty][i][tx] = lo[i];
    s_hi[ty][i][tx] = hi[i];
  }
  __syncthreads();
  // every thread folds the KQ_TY partials of its byte itself (min / max
  // are exact, so the order does not matter)
  float sc[F];
#pragma unroll
  for (int i = 0; i < F; ++i) {
    lo[i] = s_lo[0][i][tx];
    hi[i] = s_hi[0][i][tx];
#pragma unroll
    for (int y = 1; y < KQ_TY; ++y) {
      lo[i] = fminf(lo[i], s_lo[y][i][tx]);
      hi[i] = fmaxf(hi[i], s_hi[y][i][tx]);
    }
    sc[i] = scale_of(lo[i], hi[i], LEVELS);
  }
  if (!live) return;
  if (ty == 0) {
    const size_t sz = ((size_t)b * (S / G) + g) * HD + (size_t)j * F;
#pragma unroll
    for (int i = 0; i < F; ++i) {
      scale[sz + i] = sc[i];
      zero[sz + i] = lo[i];
    }
  }
  int8_t* dst = codes + row0 * HDp + j;
  for (int r = ty; r < G; r += KQ_TY) {
    uint32_t packed = 0;
#pragma unroll
    for (int i = 0; i < F; ++i)
      packed |= code_of(ld(src + (size_t)r * HD + i), lo[i], sc[i], LEVELS)
                << (i * BITS);
    dst[(size_t)r * HDp] = (int8_t)((int)packed - 128);
  }
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
  const int HDp = HD * bits / 8;
  const dim3 grid((HDp + KQ_TX - 1) / KQ_TX, S / G, B);
  const dim3 block(KQ_TX, KQ_TY);
  const T* x = (const T*)k;
  int8_t* c = (int8_t*)codes;
  float* s = (float*)scale;
  float* z = (float*)zero;
  if (bits == 2)
    kquant_kernel<T, 2><<<grid, block, 0, st>>>(x, c, s, z, S, HD, G);
  else if (bits == 4)
    kquant_kernel<T, 4><<<grid, block, 0, st>>>(x, c, s, z, S, HD, G);
  else if (bits == 8)
    kquant_kernel<T, 8><<<grid, block, 0, st>>>(x, c, s, z, S, HD, G);
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
