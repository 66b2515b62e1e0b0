// Fused KIVI quantize-and-pack: keys per channel over G-row groups
// (`kquant_launch`), values per token over the head dim (`vquant_launch`),
// and both of one flush or admission in one launch (`kvquant_launch`).
//
// Replaces: src/repro/kernels/kvquant/kernel.py:kquant_pallas (body
// `_kquant_kernel`) and :vquant_pallas (body `_vquant_kernel`), both
// through `_pack_along_last`. On the serving path they quantize the
// residual ring at each KIVI flush and the selected prompt rows at each
// quantized admission (`core/cache.py:quantize_kv`, called from
// `plan_group_flush` and `compress_prompt`), K and V together through
// `kvquant_launch`.
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
// arithmetic would be the limit. At the serve path's sizes (2.4 MB a
// flush, a bound of ~0.7 us) a launch's fixed latency and each CTA's
// dependent chain (a DRAM round trip, the min / max fold, the divisions)
// take most of the time, so both bodies read each row once and fold
// without a barrier where they can, and one launch runs both.
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
// vquant (one pass): a row of D channels takes TPR lanes of a warp, the
// power of two that covers its 16-byte chunks (D 128: 16 lanes in bf16,
// 32 in f32; at most 32, a lane then owning several chunks), so a CTA of
// VQ_NT threads holds VQ_NT / TPR rows (the flush's 8192 bf16 rows: 1024
// CTAs, ~1000 threads an SM, one wave). Lane l owns chunks l, l + TPR,
// ...; it issues every load first (one 16-byte __ldg each, the first
// VQ_HELD kept in registers), folds min / max, and the row's lanes fold
// with __shfl_xor_sync over offsets below TPR: no shared memory, no
// barrier. The row's one scale gives one reciprocal, so a code costs a
// multiplication, with the IEEE division only within 1e-4 of a rounding
// tie (`code_rcp`: bit-equal). Each lane then writes its chunk's packed
// bytes in one 2-8 byte store (the row's lanes write neighbouring bytes:
// one coalesced store a warp), and row lane 0 writes the row's scale and
// zero. Row and lane come from shifts, not divisions. One lane a row,
// not a gather through shared memory: the warp's rows sit side by side,
// so its scale (and zero) stores already coalesce into one sector, and a
// gather would put a barrier on the chain. Rows past the end still take
// part in the shuffles and store nothing.
// kvquant: one flat grid, kquant's CTAs first (block x -> slice, group,
// sequence, by two 32-bit divisions: 64-bit ones are a software routine
// ahead of every load), then vquant's, both bodies in 128-thread CTAs;
// the block index picks the body. A flat grid has no 65535 limit on
// groups or sequences. The value CTAs' short chains run beside the key
// CTAs' longer one, so the launch takes about as long as its key part.
// The TPU kernel's grid over (b, group) ran in order on one core; here
// the channel slices, groups and rows run in parallel, which the
// per-channel (K) and per-row (V) reductions allow.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int KQ_CW = 16;            // kquant channels per CTA
constexpr int KQ_NT = 128;           // kquant threads per CTA
constexpr int KQ_RPT = 4;            // kquant rows a thread keeps in registers
constexpr int VQ_NT = KQ_NT;         // vquant threads per CTA (one launch
                                     // runs both bodies)
constexpr int VQ_LG_NT = 7;          // log2(VQ_NT)
static_assert(VQ_NT == 1 << VQ_LG_NT, "VQ_LG_NT");
constexpr int VQ_HELD = 2;           // vquant chunks a lane keeps in registers

__device__ __forceinline__ float scale_of(float lo, float hi, int levels) {
  return __fdiv_rn(fmaxf(__fsub_rn(hi, lo), 1e-8f), (float)levels);
}

__device__ __forceinline__ uint32_t code_of(float x, float lo, float scale,
                                            int levels) {
  float c = rintf(__fdiv_rn(__fsub_rn(x, lo), scale));
  c = fminf(fmaxf(c, 0.0f), (float)levels);
  return (uint32_t)c;
}

// code_of with one multiplication in place of the division, bit-equal
// to it: with rs = 1 / scale rounded, q = (x - lo) * rs rounded lies
// within 3 * 2^-24 * |q| of the IEEE quotient (x - lo) / scale, and
// |q| <= levels (1 + 2^-23) <= 256 (x - lo <= hi - lo; below the 1e-8
// floor too), so within 4.6e-5 of it. Their rints differ only if a .5
// tie lies between them: q within 1e-4 of a tie takes the exact
// division.
__device__ __forceinline__ uint32_t code_rcp(float x, float lo, float scale,
                                             float rs, int levels) {
  const float d = __fsub_rn(x, lo);
  float q = __fmul_rn(d, rs);
  if (fabsf(fabsf(q - rintf(q)) - 0.5f) < 1e-4f) q = __fdiv_rn(d, scale);
  const float c = fminf(fmaxf(rintf(q), 0.0f), (float)levels);
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

// NB packed bytes (one little-endian word) at `out`: one store when
// `vec`, else the first nb bytes one by one
template <int NB>
__device__ __forceinline__ void store_packed(int8_t* out, uint64_t word,
                                             bool vec, int nb) {
  if (vec) {
    if constexpr (NB == 8) *reinterpret_cast<uint64_t*>(out) = word;
    else if constexpr (NB == 4) *reinterpret_cast<uint32_t*>(out) =
        (uint32_t)word;
    else if constexpr (NB == 2) *reinterpret_cast<uint16_t*>(out) =
        (uint16_t)word;
    else *out = (int8_t)word;
  } else {
    for (int j = 0; j < nb; ++j) out[j] = (int8_t)(word >> (8 * j));
  }
}

// k [B, S, H*D] T -> codes [B, S, H*D*BITS/8] int8, scale / zero
// [B, S/G, H*D] f32, for the CTA of (channel slice x, group g, sequence
// b), KQ_NT threads: thread t owns the VEC-channel chunk c0 = x*KQ_CW +
// (t % TX)*VEC (16 bytes of a row) of rows t / TX, t / TX + TY, ... of
// the group, and keeps the first KQ_RPT of them in registers between the
// two passes.
template <typename T, int BITS>
__device__ __forceinline__ void kquant_body(
    const T* __restrict__ k, int8_t* __restrict__ codes,
    float* __restrict__ scale, float* __restrict__ zero, int S, int HD,
    int G, int vec_ok, int x, int g, int b) {
  constexpr int VEC = 16 / (int)sizeof(T);   // channels a 16-byte load
  constexpr int F = 8 / BITS;                // channels a packed byte
  constexpr int NB = VEC / F;                // packed bytes a chunk
  constexpr int TX = KQ_CW / VEC, TY = KQ_NT / TX, NW = KQ_NT / 32;
  constexpr int LEVELS = (1 << BITS) - 1;
  __shared__ float s_lo[NW][TX][VEC], s_hi[NW][TX][VEC];
  const int t = threadIdx.x, tx = t % TX, ty = t / TX;
  const int warp = t / 32, lane = t % 32;
  const int c0 = x * KQ_CW + tx * VEC;            // first channel
  const int nc = max(0, min(VEC, HD - c0));       // a tail chunk has fewer
  const bool vec = vec_ok && nc == VEC;
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
    store_packed<NB>(dst + (size_t)r * (HD / F), word, vec, nc / F);
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
// [R] f32, for the rows of CTA `cta`: tpr = 2^lg lanes a row (at most
// 32, covering the row's 16-byte chunks where it can), VQ_NT / tpr rows
// a CTA (shifts: no integer division on the way to the loads). Lane lr
// of a row owns its chunks lr, lr + tpr, ... and keeps the first
// VQ_HELD of them in registers between the two passes.
// `vec_ok`: D is whole chunks and v / codes are 16-byte aligned.
template <typename T, int BITS>
__device__ __forceinline__ void vquant_body(
    const T* __restrict__ v, int8_t* __restrict__ codes,
    float* __restrict__ scale, float* __restrict__ zero, long long R,
    int D, int lg, int vec_ok, unsigned cta) {
  constexpr int VEC = 16 / (int)sizeof(T);   // channels a 16-byte load
  constexpr int F = 8 / BITS;                // channels a packed byte
  constexpr int NB = VEC / F;                // packed bytes a chunk
  constexpr int LEVELS = (1 << BITS) - 1;
  const int t = threadIdx.x, tpr = 1 << lg, lr = t & (tpr - 1);
  const long long row = ((long long)cta << (VQ_LG_NT - lg)) + (t >> lg);
  const bool live = row < R;       // a row past the end only shuffles
  const int n_chunk = (D + VEC - 1) / VEC;
  const T* src = v + (live ? row : 0) * D;
  const auto nc_of = [&](int c) { return min(VEC, D - c * VEC); };

  // pass 1: every load first, then min / max over the lane's channels
  float lo = INFINITY, hi = -INFINITY, f[VEC];
  uint4 held[VQ_HELD];
  auto fold = [&](uint4 u, int nc) {
    expand<T>(u, f);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      if (e < nc) {
        lo = fminf(lo, f[e]);
        hi = fmaxf(hi, f[e]);
      }
  };
  if (live) {
#pragma unroll
    for (int i = 0; i < VQ_HELD; ++i) {
      const int c = lr + i * tpr;
      if (c < n_chunk) held[i] = load_chunk(src + c * VEC, nc_of(c), vec_ok);
    }
#pragma unroll
    for (int i = 0; i < VQ_HELD; ++i) {
      const int c = lr + i * tpr;
      if (c < n_chunk) fold(held[i], nc_of(c));
    }
    for (int c = lr + VQ_HELD * tpr; c < n_chunk; c += tpr)
      fold(load_chunk(src + c * VEC, nc_of(c), vec_ok), nc_of(c));
  }
  // the row's lanes (xor offsets below tpr stay inside the row)
  for (int o = 1; o < tpr; o <<= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (!live) return;
  const float sc = scale_of(lo, hi, LEVELS), rs = __frcp_rn(sc);
  if (lr == 0) {
    scale[row] = sc;
    zero[row] = lo;
  }
  // pass 2: each chunk's NB packed bytes, one store
  int8_t* dst = codes + row * (D / F);
  auto put = [&](uint4 u, int c) {
    expand<T>(u, f);
    uint64_t word = 0;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      uint32_t packed = 0;
#pragma unroll
      for (int i = 0; i < F; ++i)
        packed |= code_rcp(f[j * F + i], lo, sc, rs, LEVELS) << (i * BITS);
      word |= (uint64_t)(uint8_t)((int)packed - 128) << (8 * j);
    }
    store_packed<NB>(dst + c * NB, word, vec_ok, nc_of(c) / F);
  };
#pragma unroll
  for (int i = 0; i < VQ_HELD; ++i) {
    const int c = lr + i * tpr;
    if (c < n_chunk) put(held[i], c);
  }
  for (int c = lr + VQ_HELD * tpr; c < n_chunk; c += tpr)
    put(load_chunk(src + c * VEC, nc_of(c), vec_ok), c);
}

// grid (ceil(HD / KQ_CW), S/G, B)
template <typename T, int BITS>
__global__ void __launch_bounds__(KQ_NT) kquant_kernel(
    const T* __restrict__ k, int8_t* __restrict__ codes,
    float* __restrict__ scale, float* __restrict__ zero, int S, int HD,
    int G, int vec_ok) {
  kquant_body<T, BITS>(k, codes, scale, zero, S, HD, G, vec_ok, blockIdx.x,
                       blockIdx.y, blockIdx.z);
}

// grid ceil(R / (VQ_NT >> lg))
template <typename T, int BITS>
__global__ void __launch_bounds__(VQ_NT) vquant_kernel(
    const T* __restrict__ v, int8_t* __restrict__ codes,
    float* __restrict__ scale, float* __restrict__ zero, long long R,
    int D, int lg, int vec_ok) {
  vquant_body<T, BITS>(v, codes, scale, zero, R, D, lg, vec_ok,
                       blockIdx.x);
}

// one flat grid: n_kq = nx * ng * B kquant CTAs (nx channel slices, ng
// groups; slice fastest), then vquant's. Block indices are 32-bit (the
// launcher keeps the grid below 2^31): two unsigned divisions find a K
// CTA's (slice, group, sequence).
template <typename T, int BITS>
__global__ void __launch_bounds__(KQ_NT) kvquant_kernel(
    const T* __restrict__ k, const T* __restrict__ v,
    int8_t* __restrict__ k_codes, float* __restrict__ k_scale,
    float* __restrict__ k_zero, int8_t* __restrict__ v_codes,
    float* __restrict__ v_scale, float* __restrict__ v_zero, int S, int HD,
    int G, int k_vec, unsigned nx, unsigned ng, unsigned n_kq, long long R,
    int D, int lg, int v_vec) {
  const unsigned bid = blockIdx.x;
  if (bid < n_kq) {
    const unsigned r = bid / nx, b = r / ng;
    kquant_body<T, BITS>(k, k_codes, k_scale, k_zero, S, HD, G, k_vec,
                         bid - r * nx, r - b * ng, b);
  } else {
    vquant_body<T, BITS>(v, v_codes, v_scale, v_zero, R, D, lg, v_vec,
                         bid - n_kq);
  }
}

bool a16(const void* p) { return (uintptr_t)p % 16 == 0; }

// log2 of vquant's lanes a row: the power of two that covers the row's
// 16-byte chunks at `per_lane` chunks a lane, at most 32
int lanes_log2(int D, int elem_bytes, int per_lane) {
  const int n_lane = ((D * elem_bytes + 15) / 16 + per_lane - 1) / per_lane;
  int lg = 0;
  while ((1 << lg) < n_lane && lg < 5) ++lg;
  return lg;
}

// vquant's CTAs for R rows at 2^lg lanes a row
long long vquant_ctas(long long R, int lg) {
  const long long rows = VQ_NT >> lg;
  return (R + rows - 1) / rows;
}

constexpr long long MAX_GRID = 0x7fffffffLL;

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
  const int lg = lanes_log2(D, (int)sizeof(T), 1);
  const long long grid = vquant_ctas(R, lg);
  if (grid > MAX_GRID) return (int)cudaErrorInvalidValue;
  const T* x = (const T*)v;
  int8_t* c = (int8_t*)codes;
  float* s = (float*)scale;
  float* z = (float*)zero;
  const int vec = D % (16 / (int)sizeof(T)) == 0 && a16(v) && a16(codes);
  const unsigned g = (unsigned)grid;
  if (bits == 2)
    vquant_kernel<T, 2><<<g, VQ_NT, 0, st>>>(x, c, s, z, R, D, lg, vec);
  else if (bits == 4)
    vquant_kernel<T, 4><<<g, VQ_NT, 0, st>>>(x, c, s, z, R, D, lg, vec);
  else if (bits == 8)
    vquant_kernel<T, 8><<<g, VQ_NT, 0, st>>>(x, c, s, z, R, D, lg, vec);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// the fused launch's arguments past the pointers
struct KvArgs {
  int S, HD, G, k_vec;
  unsigned nx, ng, n_kq;
  long long R;
  int D, lg, v_vec;
};

template <typename T, int BITS>
void kvquant_go(unsigned grid, cudaStream_t st, const void* k,
                const void* v, void* kc, void* ks, void* kz, void* vc,
                void* vs, void* vz, const KvArgs& a) {
  kvquant_kernel<T, BITS><<<grid, KQ_NT, 0, st>>>(
      (const T*)k, (const T*)v, (int8_t*)kc, (float*)ks, (float*)kz,
      (int8_t*)vc, (float*)vs, (float*)vz, a.S, a.HD, a.G, a.k_vec, a.nx,
      a.ng, a.n_kq, a.R, a.D, a.lg, a.v_vec);
}

template <typename T>
int kvquant_dispatch(const void* k, const void* v, void* kc, void* ks,
                     void* kz, void* vc, void* vs, void* vz, int B, int S,
                     int H, int D, int G, int bits, cudaStream_t st) {
  constexpr int VEC = 16 / (int)sizeof(T);
  KvArgs a;
  a.S = S;
  a.HD = H * D;
  a.G = G;
  a.k_vec = a.HD % VEC == 0 && a16(k) && a16(kc) && a16(ks) && a16(kz);
  a.nx = (unsigned)((a.HD + KQ_CW - 1) / KQ_CW);
  a.ng = (unsigned)(S / G);
  const long long n_kq = (long long)a.nx * a.ng * B;
  a.R = (long long)B * S * H;
  a.D = D;
  a.lg = lanes_log2(D, (int)sizeof(T), 1);
  a.v_vec = D % VEC == 0 && a16(v) && a16(vc);
  const long long n_vq = vquant_ctas(a.R, a.lg);
  if (n_kq + n_vq > MAX_GRID) return (int)cudaErrorInvalidValue;
  a.n_kq = (unsigned)n_kq;
  const unsigned grid = (unsigned)(n_kq + n_vq);
  if (bits == 2)
    kvquant_go<T, 2>(grid, st, k, v, kc, ks, kz, vc, vs, vz, a);
  else if (bits == 4)
    kvquant_go<T, 4>(grid, st, k, v, kc, ks, kz, vc, vs, vz, a);
  else if (bits == 8)
    kvquant_go<T, 8>(grid, st, k, v, kc, ks, kz, vc, vs, vz, a);
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

// k, v: [B, S, H, D] contiguous, one dtype (0 = f32, 1 = bf16): kquant's
// outputs (k_codes [B, S, H, D*bits/8] int8, k_scale / k_zero [B, S/G,
// H, D] f32) and vquant's (v_codes [B, S, H, D*bits/8], v_scale / v_zero
// [B, S, H] f32) in one launch. Needs S % G == 0 and D*bits % 8 == 0.
extern "C" int kvquant_launch(const void* k, const void* v, void* k_codes,
                              void* k_scale, void* k_zero, void* v_codes,
                              void* v_scale, void* v_zero, int B, int S,
                              int H, int D, int G, int bits, int dtype,
                              void* stream) {
  if (B < 1 || S < 1 || H < 1 || D < 1 || G < 1 || S % G || (D * bits) % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return kvquant_dispatch<float>(k, v, k_codes, k_scale, k_zero, v_codes,
                                   v_scale, v_zero, B, S, H, D, G, bits, st);
  if (dtype == 1)
    return kvquant_dispatch<__nv_bfloat16>(k, v, k_codes, k_scale, k_zero,
                                           v_codes, v_scale, v_zero, B, S,
                                           H, D, G, bits, st);
  return (int)cudaErrorInvalidValue;
}
