// B5–B9 — per-chunk collective quantization for Hopper: the dense passes
// of the quantized two-step all-reduce (core/parallel_exec.py ·
// quantized_psum).
//
// Replaces, in src/repro/kernels/quant_collective/quant_kernel.py:
//   B5 chunk_amax_kernel        <- chunk_amax_pallas
//   B6 chunk_quantize_kernel    <- chunk_quantize_pallas (int8, fp8)
//   B9 chunk_dequantize_kernel  <- chunk_dequantize_pallas (int8, fp8)
// and, on the int8/fp8 wire of a TP decode step, B9 fused with the residual
// add and the RMSNorm after it (B1, rownorm.cuh):
//   B9 + add + B1 dequantize_add_rmsnorm <- chunk_dequantize_pallas, the
//           add x + ... (src/repro/core/parallel_exec.py), rms_norm_pallas
// and, on the int4 wire, fused with the work beside them:
//   B6 + B7 chunk_quantize_pack_kernel       <- chunk_quantize_pallas,
//                                               nibble_pack_pallas
//   B8 + B7 nibble_reduce_requant_kernel     <- nibble_unpack_pallas, the
//           jnp sum / round / clip (src/repro/core/parallel_exec.py:176–180),
//           nibble_pack_pallas
//   B8 + B9 nibble_unpack_dequantize_kernel  <- nibble_unpack_pallas,
//                                               chunk_dequantize_pallas
//
// Bound on the H100: device-memory bytes.  Each pass reads its input once
// and writes its output once with a few operations per element, far below
// the card's ~295 operations per byte.  On the decode path a call sees one
// rank's rows, [4, 3072] bf16 (24 KB): the bound is nanoseconds and the
// launch sets the time.  So the design is plain and exact, and the int4
// wire, which launched B6, B7, B8, the torch ops of the sum and the
// requantize, and B7 again on every rank, then B8 and B9 once, launches
// three fused kernels: no int8 intermediate and no int32 sum goes through
// device memory.
//   * B5: one warp per (row, chunk), 16-byte loads when h and chunk are
//     multiples of the vector width, a scalar loop otherwise (a ragged
//     last chunk, h % chunk != 0, reads nothing past h);
//   * B6, B9: a grid-stride loop, one element per thread per step; the
//     scale of element j of a row is scales[row, j / chunk];
//   * the three int4 passes: a 2-D grid (row steps x rows), no 64-bit
//     index division; chunk_quantize_pack reads 16 bytes of x per thread
//     per step (8 bf16 or 4 f32 values -> 4 or 2 packed bytes) when x is
//     16-byte aligned and h a multiple of the vector width, one pair -> one
//     byte otherwise; nibble_reduce_requant and nibble_unpack_dequantize
//     take one packed byte per thread per step.  Every element uses its own
//     chunk's scale (looked up once a step where the step lies in one
//     chunk), so with an odd chunk a pair may straddle two scales.
// Numerics are those of the plain versions (ref.py), bit for bit:
//   * B5 propagates NaN (torch.amax and jnp.max do; fmaxf would drop it);
//   * B6 divides x / scale as written (IEEE division: the library is built
//     without --use_fast_math), rounds half to even with rintf, then clips
//     to [-127, 127] for int8 (and for int4, whose nibble is then the low 4
//     bits, so an out-of-grid value packs as the unfused chain packs it);
//     for fp8 it clips to +-448 first and rounds once to e4m3 with
//     __nv_cvt_float_to_fp8(..., __NV_SATFINITE, E4M3);
//   * B6 takes every zero scale as 1, as the JAX package's Pallas wrapper
//     does (quant_kernel.py:83) — its jnp reference divides by the zero;
//   * the requantize sums the t source nibbles exactly in int32, divides by
//     t in f32 (IEEE), rounds half to even with rintf (torch.round and
//     jnp.round do) and clips to [-7, 7]: at t = 2, r = 1 -> 0, 3 -> 2;
//   * a nibble n sign-extends as (n ^ 8) - 8;
//   * B9 multiplies in f32 and rounds once to the output type;
//     dequantize_add_rmsnorm rounds that product to x's type as B9 does
//     (__fmul_rn, so the add after it is not contracted into an FMA), adds
//     x and rounds again, as the chain's x + d does: s is bit for bit the
//     chain's, and n is B1's of s.  One launch in place of three, and
//     neither the dequantized tensor nor s is read back from memory.
#include <cuda_fp8.h>

#include <algorithm>

#include "common.cuh"
#include "rownorm.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 132 * 16;   // grid-stride cap: 16 blocks per SM

// max that keeps a NaN from either side (a != a only for NaN: the library
// is built without fast math)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a >= b) ? a : b;
}

int grid_for(int64_t n) {
  return static_cast<int>(std::min<int64_t>((n + kThreads - 1) / kThreads,
                                            kMaxBlocks));
}

// ---------------------------------------------------------------- B5
template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads)
chunk_amax_kernel(const T* __restrict__ x, float* __restrict__ out,
                  int64_t rows, int h, int chunk, int K) {
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarps +
                    threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (w >= rows * K) return;   // uniform over the warp
  const int64_t row = w / K;
  const int c = static_cast<int>(w - row * K);
  const T* xr = x + row * h;
  const int start = c * chunk, end = min(start + chunk, h);
  float m = 0.f;               // |x| >= 0: the zero padding of the plain version
  if constexpr (kVector) {
    constexpr int N = Vec16<T>::N;
    for (int i = start + lane * N; i < end; i += 32 * N) {
      float f[N];
      Vec16<T>::load(xr + i, f);
#pragma unroll
      for (int j = 0; j < N; ++j) m = nan_max(m, fabsf(f[j]));
    }
  } else {
    for (int i = start + lane; i < end; i += 32) {
      m = nan_max(m, fabsf(to_f32(xr[i])));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, o));
  }
  if (lane == 0) out[row * K + c] = m;
}

template <typename T>
cudaError_t launch_amax(const void* x, float* out, int64_t rows, int h,
                        int chunk, cudaStream_t stream) {
  const int K = (h + chunk - 1) / chunk;
  const int64_t warps = rows * K;
  const int blocks = static_cast<int>((warps + kWarps - 1) / kWarps);
  constexpr int N = Vec16<T>::N;
  const bool vector = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      h % N == 0 && chunk % N == 0;
  const T* xp = static_cast<const T*>(x);
  if (vector)
    chunk_amax_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        xp, out, rows, h, chunk, K);
  else
    chunk_amax_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        xp, out, rows, h, chunk, K);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- B6
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);   // keeps a NaN, as jnp.clip does
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
chunk_quantize_kernel(const T* __restrict__ x,
                      const float* __restrict__ scales,
                      uint8_t* __restrict__ out, int64_t n, int h, int chunk,
                      int K) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t row = i / h;
    const int j = static_cast<int>(i - row * h);
    float s = scales[row * K + j / chunk];
    if (s == 0.f) s = 1.f;
    float v = to_f32(x[i]) / s;
    if constexpr (kMode == kInt8) {
      v = clip(rintf(v), -127.f, 127.f);
      out[i] = static_cast<uint8_t>(static_cast<int8_t>(v));
    } else {
      v = clip(v, -448.f, 448.f);
      out[i] = __nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
    }
  }
}

template <typename T>
cudaError_t launch_quantize(const void* x, const float* scales, void* out,
                            int64_t rows, int h, int chunk, int qdtype,
                            cudaStream_t stream) {
  const int K = (h + chunk - 1) / chunk;
  const int64_t n = rows * h;
  const T* xp = static_cast<const T*>(x);
  uint8_t* op = static_cast<uint8_t*>(out);
  if (qdtype == kInt8)
    chunk_quantize_kernel<T, kInt8><<<grid_for(n), kThreads, 0, stream>>>(
        xp, scales, op, n, h, chunk, K);
  else if (qdtype == kFloat8E4M3)
    chunk_quantize_kernel<T, kFloat8E4M3>
        <<<grid_for(n), kThreads, 0, stream>>>(xp, scales, op, n, h, chunk,
                                               K);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// ---------------------------------------------------------------- B9
template <int kMode>
__device__ __forceinline__ float wire_to_f32(uint8_t q) {
  if constexpr (kMode == kInt8) {
    return static_cast<float>(static_cast<int8_t>(q));
  } else {
    // e4m3 -> half is exact, half -> f32 is exact
    return __half2float(__half(__nv_cvt_fp8_to_halfraw(q, __NV_E4M3)));
  }
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
chunk_dequantize_kernel(const uint8_t* __restrict__ q,
                        const float* __restrict__ scales,
                        T* __restrict__ out, int64_t n, int h, int chunk,
                        int K) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t row = i / h;
    const int j = static_cast<int>(i - row * h);
    out[i] = from_f32<T>(wire_to_f32<kMode>(q[i]) *
                         scales[row * K + j / chunk]);
  }
}

template <typename T>
cudaError_t launch_dequantize(const void* q, const float* scales, void* out,
                              int64_t rows, int h, int chunk, int qdtype,
                              cudaStream_t stream) {
  const int K = (h + chunk - 1) / chunk;
  const int64_t n = rows * h;
  const uint8_t* qp = static_cast<const uint8_t*>(q);
  T* op = static_cast<T*>(out);
  if (qdtype == kInt8)
    chunk_dequantize_kernel<T, kInt8><<<grid_for(n), kThreads, 0, stream>>>(
        qp, scales, op, n, h, chunk, K);
  else if (qdtype == kFloat8E4M3)
    chunk_dequantize_kernel<T, kFloat8E4M3>
        <<<grid_for(n), kThreads, 0, stream>>>(qp, scales, op, n, h, chunk,
                                               K);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// ------------------------------------------------- B9 + add + B1
// the rows of x + dequantize(q) (x, q and the outputs contiguous), each
// value as the chain rounds it: d = round(q * scale), s = round(x + d)
template <typename T, int kMode>
struct DequantAddSrc {
  static constexpr bool kStore = true;
  static constexpr int N = Vec16<T>::N;
  struct Raw {
    uint4 x;
    uint2 q;    // N bytes: all 8 (bf16) or the first 4 (f32)
    float s;    // the scale of element e
  };
  const uint8_t* q;
  const float* scales;
  const T* x;
  int h, chunk, K;

  __device__ float value(float x_e, uint8_t q_e, float scale) const {
    return round_to<T>(
        x_e + round_to<T>(__fmul_rn(wire_to_f32<kMode>(q_e), scale)));
  }
  // q: N bytes at an N-byte boundary (the launch checks it)
  __device__ void fetch(int64_t row, int e, Raw& r) const {
    r.x = load16(x + row * h + e);
    if constexpr (N == 8)
      r.q = *reinterpret_cast<const uint2*>(q + row * h + e);
    else
      r.q.x = *reinterpret_cast<const uint32_t*>(q + row * h + e);
    r.s = scales[row * K + e / chunk];
  }
  __device__ void values(int64_t row, int e, const Raw& r,
                         float (&f)[N]) const {
    Vec16<T>::unpack(r.x, f);
    uint8_t b[N];
#pragma unroll
    for (int j = 0; j < N; ++j)
      b[j] = static_cast<uint8_t>((j < 4 ? r.q.x : r.q.y) >> (8 * (j % 4)));
    if (chunk % N == 0) {   // the N values share e's chunk
#pragma unroll
      for (int j = 0; j < N; ++j) f[j] = value(f[j], b[j], r.s);
    } else {
      const float* sr = scales + row * K;
#pragma unroll
      for (int j = 0; j < N; ++j) f[j] = value(f[j], b[j], sr[(e + j) / chunk]);
    }
  }
  __device__ float at(int64_t row, int e) const {
    return value(to_f32(x[row * h + e]), q[row * h + e],
                 scales[row * K + e / chunk]);
  }
};

template <typename T>
cudaError_t launch_dequantize_add_rmsnorm(const void* q, const float* scales,
                                          const void* x, const void* w,
                                          void* s, void* n, int64_t rows,
                                          int h, int chunk, float eps,
                                          int qdtype, cudaStream_t stream) {
  const int K = (h + chunk - 1) / chunk;
  const uint8_t* qp = static_cast<const uint8_t*>(q);
  const T* xp = static_cast<const T*>(x);
  const bool vector =
      aligned16(x) && reinterpret_cast<uintptr_t>(q) % Vec16<T>::N == 0;
  const T* wp = static_cast<const T*>(w);
  T* sp = static_cast<T*>(s);
  T* np = static_cast<T*>(n);
  if (qdtype == kInt8)
    return launch_rownorm<T>(DequantAddSrc<T, kInt8>{qp, scales, xp, h, chunk,
                                                     K},
                             vector, wp, sp, np, rows, h, eps, stream);
  if (qdtype == kFloat8E4M3)
    return launch_rownorm<T>(
        DequantAddSrc<T, kFloat8E4M3>{qp, scales, xp, h, chunk, K}, vector,
        wp, sp, np, rows, h, eps, stream);
  return cudaErrorInvalidValue;
}

// ------------------------------------------------- int4: B6+B7, B8+B9
// The three passes walk a 2-D grid, x over a row's steps and y over rows,
// so no thread divides a 64-bit flat index by the row width: at the
// decode shape a step is a few hundred cycles and such a division would
// be a large share of it.  A step's scale is looked up once where the
// step lies inside one chunk.
constexpr int kRowThreads = 128;

dim3 row_grid(int64_t rows, int steps) {
  return dim3(std::min((steps + kRowThreads - 1) / kRowThreads, kMaxBlocks),
              static_cast<unsigned>(std::min<int64_t>(rows, 65535)));
}

// the low 4 bits of B6's int8 value of x / s
__device__ __forceinline__ uint32_t quantize_nibble(float x, float s) {
  if (s == 0.f) s = 1.f;
  const float v = clip(rintf(x / s), -127.f, 127.f);
  return static_cast<uint32_t>(static_cast<int>(v)) & 0xFu;
}

// the nibble at bit ``shift`` of b, sign-extended
__device__ __forceinline__ int nibble_value(uint32_t b, int shift) {
  return static_cast<int>(((b >> shift) & 0xFu) ^ 8u) - 8;
}

// a step: kPer elements (16 bytes of T, or one pair) -> kPer / 2 packed
// bytes; element 2i in the low nibble of byte i, 2i + 1 in the high one
template <typename T, bool kVector, bool kOneScale>
__global__ void __launch_bounds__(kRowThreads)
chunk_quantize_pack_kernel(const T* __restrict__ x,
                           const float* __restrict__ scales,
                           uint8_t* __restrict__ out, int64_t rows, int h,
                           int chunk, int K) {
  constexpr int kPer = kVector ? Vec16<T>::N : 2;
  const int steps = h / kPer;
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const T* xr = x + row * h;
    const float* sr = scales + row * K;
    uint8_t* orow = out + row * (h / 2);
    for (int c = blockIdx.x * kRowThreads + threadIdx.x; c < steps;
         c += gridDim.x * kRowThreads) {
      const int j = c * kPer;
      float f[kPer];
      if constexpr (kVector) {
        Vec16<T>::load(xr + j, f);
      } else {
        f[0] = to_f32(xr[j]);
        f[1] = to_f32(xr[j + 1]);
      }
      uint32_t word = 0;
      if constexpr (kOneScale) {
        const float s = sr[j / chunk];
#pragma unroll
        for (int k = 0; k < kPer; ++k)
          word |= quantize_nibble(f[k], s) << (4 * k);
      } else {
#pragma unroll
        for (int k = 0; k < kPer; ++k)
          word |= quantize_nibble(f[k], sr[(j + k) / chunk]) << (4 * k);
      }
      uint8_t* o = orow + j / 2;
      if constexpr (kPer == 8)
        *reinterpret_cast<uint32_t*>(o) = word;
      else if constexpr (kPer == 4)
        *reinterpret_cast<uint16_t*>(o) = static_cast<uint16_t>(word);
      else
        *o = static_cast<uint8_t>(word);
    }
  }
}

template <typename T, bool kVector>
void launch_quantize_pack_v(const T* x, const float* scales, uint8_t* out,
                            int64_t rows, int h, int chunk, int K,
                            cudaStream_t stream) {
  constexpr int kPer = kVector ? Vec16<T>::N : 2;
  const dim3 grid = row_grid(rows, h / kPer);
  if (chunk % kPer == 0)
    chunk_quantize_pack_kernel<T, kVector, true>
        <<<grid, kRowThreads, 0, stream>>>(x, scales, out, rows, h, chunk, K);
  else
    chunk_quantize_pack_kernel<T, kVector, false>
        <<<grid, kRowThreads, 0, stream>>>(x, scales, out, rows, h, chunk, K);
}

template <typename T>
cudaError_t launch_quantize_pack(const void* x, const float* scales,
                                 uint8_t* out, int64_t rows, int h, int chunk,
                                 cudaStream_t stream) {
  const int K = (h + chunk - 1) / chunk;
  const T* xp = static_cast<const T*>(x);
  if (reinterpret_cast<uintptr_t>(x) % 16 == 0 && h % Vec16<T>::N == 0)
    launch_quantize_pack_v<T, true>(xp, scales, out, rows, h, chunk, K,
                                    stream);
  else
    launch_quantize_pack_v<T, false>(xp, scales, out, rows, h, chunk, K,
                                     stream);
  return cudaGetLastError();
}

// requantize an exact sum r of t int4 values: rint(r / t) clipped to +-7
__device__ __forceinline__ uint32_t requant_nibble(int r, int t) {
  const float v = clip(rintf(static_cast<float>(r) / static_cast<float>(t)),
                       -7.f, 7.f);
  return static_cast<uint32_t>(static_cast<int>(v)) & 0xFu;
}

// a row of ``in`` is the t source ranks' copies of this rank's block, mb
// bytes each, in rank order; output byte c of the row sums byte c of each.
// kT > 0 fixes t at compile time, so the t loads of a step are unrolled and
// in flight together (kT = 0: t at run time)
template <int kT>
__global__ void __launch_bounds__(kRowThreads)
nibble_reduce_requant_kernel(const uint8_t* __restrict__ in,
                             uint8_t* __restrict__ out, int64_t rows, int mb,
                             int t_run) {
  const int t = kT > 0 ? kT : t_run;
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const uint8_t* src = in + row * mb * t;
    for (int c = blockIdx.x * kRowThreads + threadIdx.x; c < mb;
         c += gridDim.x * kRowThreads) {
      int lo = 0, hi = 0;                  // exact: |r| <= 8t
#pragma unroll
      for (int s = 0; s < t; ++s) {
        const uint32_t b = src[s * mb + c];
        lo += nibble_value(b, 0);
        hi += nibble_value(b, 4);
      }
      out[row * mb + c] = static_cast<uint8_t>(
          requant_nibble(lo, t) | (requant_nibble(hi, t) << 4));
    }
  }
}

cudaError_t launch_reduce_requant(const uint8_t* in, uint8_t* out,
                                  int64_t rows, int mb, int t,
                                  cudaStream_t stream) {
  const dim3 grid = row_grid(rows, mb);
  if (t == 2)
    nibble_reduce_requant_kernel<2><<<grid, kRowThreads, 0, stream>>>(
        in, out, rows, mb, t);
  else if (t == 4)
    nibble_reduce_requant_kernel<4><<<grid, kRowThreads, 0, stream>>>(
        in, out, rows, mb, t);
  else if (t == 8)
    nibble_reduce_requant_kernel<8><<<grid, kRowThreads, 0, stream>>>(
        in, out, rows, mb, t);
  else
    nibble_reduce_requant_kernel<0><<<grid, kRowThreads, 0, stream>>>(
        in, out, rows, mb, t);
  return cudaGetLastError();
}

// packed byte c of a row holds elements 2c and 2c + 1, each scaled by its
// own chunk's scale (one lookup when chunk is even)
template <typename T, bool kOneScale>
__global__ void __launch_bounds__(kRowThreads)
nibble_unpack_dequantize_kernel(const uint8_t* __restrict__ b,
                                const float* __restrict__ scales,
                                T* __restrict__ out, int64_t rows, int m,
                                int chunk, int K) {
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const uint8_t* br = b + row * m;
    const float* sr = scales + row * K;
    T* orow = out + row * 2 * m;
    for (int c = blockIdx.x * kRowThreads + threadIdx.x; c < m;
         c += gridDim.x * kRowThreads) {
      const int j = 2 * c;
      const uint32_t v = br[c];
      const float s0 = sr[j / chunk];
      const float s1 = kOneScale ? s0 : sr[(j + 1) / chunk];
      orow[j] = from_f32<T>(static_cast<float>(nibble_value(v, 0)) * s0);
      orow[j + 1] = from_f32<T>(static_cast<float>(nibble_value(v, 4)) * s1);
    }
  }
}

template <typename T>
cudaError_t launch_unpack_dequantize(const uint8_t* b, const float* scales,
                                     void* out, int64_t rows, int m,
                                     int chunk, cudaStream_t stream) {
  const int K = (2 * m + chunk - 1) / chunk;
  const dim3 grid = row_grid(rows, m);
  T* op = static_cast<T*>(out);
  if (chunk % 2 == 0)
    nibble_unpack_dequantize_kernel<T, true>
        <<<grid, kRowThreads, 0, stream>>>(b, scales, op, rows, m, chunk, K);
  else
    nibble_unpack_dequantize_kernel<T, false>
        <<<grid, kRowThreads, 0, stream>>>(b, scales, op, rows, m, chunk, K);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

REPRO_EXPORT int repro_chunk_amax(const void* x, void* out, long long rows,
                                  int h, int chunk, int dtype,
                                  void* stream) {
  if (rows <= 0 || h <= 0 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == repro::kFloat32)
    return repro::launch_amax<float>(x, o, rows, h, chunk, s);
  if (dtype == repro::kBFloat16)
    return repro::launch_amax<__nv_bfloat16>(x, o, rows, h, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_EXPORT int repro_chunk_quantize(const void* x, const void* scales,
                                      void* out, long long rows, int h,
                                      int chunk, int dtype, int qdtype,
                                      void* stream) {
  if (rows <= 0 || h <= 0 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scales);
  if (dtype == repro::kFloat32)
    return repro::launch_quantize<float>(x, sc, out, rows, h, chunk, qdtype,
                                         s);
  if (dtype == repro::kBFloat16)
    return repro::launch_quantize<__nv_bfloat16>(x, sc, out, rows, h, chunk,
                                                 qdtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_EXPORT int repro_chunk_dequantize(const void* q, const void* scales,
                                        void* out, long long rows, int h,
                                        int chunk, int qdtype, int dtype,
                                        void* stream) {
  if (rows <= 0 || h <= 0 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scales);
  if (dtype == repro::kFloat32)
    return repro::launch_dequantize<float>(q, sc, out, rows, h, chunk, qdtype,
                                           s);
  if (dtype == repro::kBFloat16)
    return repro::launch_dequantize<__nv_bfloat16>(q, sc, out, rows, h, chunk,
                                                   qdtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_EXPORT int repro_chunk_quantize_pack(const void* x, const void* scales,
                                           void* out, long long rows, int h,
                                           int chunk, int dtype,
                                           void* stream) {
  if (rows <= 0 || h <= 0 || h % 2 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scales);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (dtype == repro::kFloat32)
    return repro::launch_quantize_pack<float>(x, sc, o, rows, h, chunk, s);
  if (dtype == repro::kBFloat16)
    return repro::launch_quantize_pack<__nv_bfloat16>(x, sc, o, rows, h,
                                                      chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_EXPORT int repro_nibble_reduce_requant(const void* in, void* out,
                                             long long rows, int mb, int t,
                                             void* stream) {
  if (rows <= 0 || mb <= 0 || t <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return repro::launch_reduce_requant(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), rows, mb,
      t, static_cast<cudaStream_t>(stream));
}

REPRO_EXPORT int repro_nibble_unpack_dequantize(const void* b,
                                                const void* scales, void* out,
                                                long long rows, int m,
                                                int chunk, int dtype,
                                                void* stream) {
  if (rows <= 0 || m <= 0 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* bp = static_cast<const uint8_t*>(b);
  const float* sc = static_cast<const float*>(scales);
  if (dtype == repro::kFloat32)
    return repro::launch_unpack_dequantize<float>(bp, sc, out, rows, m, chunk,
                                                  s);
  if (dtype == repro::kBFloat16)
    return repro::launch_unpack_dequantize<__nv_bfloat16>(bp, sc, out, rows,
                                                          m, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_EXPORT int repro_dequantize_add_rmsnorm(const void* q,
                                              const void* scales,
                                              const void* x, const void* w,
                                              void* s, void* n, long long rows,
                                              int h, int chunk, float eps,
                                              int qdtype, int dtype,
                                              void* stream) {
  if (rows <= 0 || h <= 0 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scales);
  if (dtype == repro::kFloat32)
    return repro::launch_dequantize_add_rmsnorm<float>(
        q, sc, x, w, s, n, rows, h, chunk, eps, qdtype, st);
  if (dtype == repro::kBFloat16)
    return repro::launch_dequantize_add_rmsnorm<__nv_bfloat16>(
        q, sc, x, w, s, n, rows, h, chunk, eps, qdtype, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
