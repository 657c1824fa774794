// B5–B9 — per-chunk collective quantization for Hopper: the five dense
// passes of the quantized two-step all-reduce (core/parallel_exec.py ·
// quantized_psum).
//
// Replaces, in src/repro/kernels/quant_collective/quant_kernel.py:
//   B5 chunk_amax_kernel        <- chunk_amax_pallas
//   B6 chunk_quantize_kernel    <- chunk_quantize_pallas
//   B7 nibble_pack_kernel       <- nibble_pack_pallas
//   B8 nibble_unpack_kernel     <- nibble_unpack_pallas
//   B9 chunk_dequantize_kernel  <- chunk_dequantize_pallas
//
// Bound on the H100: device-memory bytes.  Each pass reads its input once
// and writes its output once with one or two operations per element, far
// below the card's ~295 operations per byte.  On the decode path a call
// sees one rank's rows, [4, 3072] bf16 (24 KB): the bound is nanoseconds
// and the launch sets the time.  So the design is plain and exact:
//   * B5: one warp per (row, chunk), 16-byte loads when h and chunk are
//     multiples of the vector width, a scalar loop otherwise (a ragged
//     last chunk, h % chunk != 0, reads nothing past h);
//   * B6, B9: a grid-stride loop, one element per thread per step; the
//     scale of element j of a row is scales[row, j / chunk];
//   * B7, B8: one packed byte per thread per step.
// Numerics are those of the plain versions (ref.py), bit for bit:
//   * B5 propagates NaN (torch.amax and jnp.max do; fmaxf would drop it);
//   * B6 divides x / scale as written (IEEE division: the library is built
//     without --use_fast_math), rounds half to even with rintf, then clips
//     to [-127, 127] for int8; for fp8 it clips to +-448 first and rounds
//     once to e4m3 with __nv_cvt_float_to_fp8(..., __NV_SATFINITE, E4M3);
//   * B6 takes every zero scale as 1, as the JAX package's Pallas wrapper
//     does (quant_kernel.py:83) — its jnp reference divides by the zero;
//   * B9 multiplies in f32 and rounds once to the output type.
#include <cuda_fp8.h>

#include <algorithm>

#include "common.cuh"

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

// 16 bytes of T as f32
template <typename T>
struct Load16;
template <>
struct Load16<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float (&f)[N]) {
    float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
};
template <>
struct Load16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&f)[N]) {
    uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

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
    constexpr int N = Load16<T>::N;
    for (int i = start + lane * N; i < end; i += 32 * N) {
      float f[N];
      Load16<T>::load(xr + i, f);
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
  constexpr int N = Load16<T>::N;
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

// ------------------------------------------------------------ B7, B8
__global__ void __launch_bounds__(kThreads)
nibble_pack_kernel(const int8_t* __restrict__ q, uint8_t* __restrict__ out,
                   int64_t n_bytes) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_bytes; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int lo = q[2 * i], hi = q[2 * i + 1];
    out[i] = static_cast<uint8_t>((lo & 0xF) | ((hi & 0xF) << 4));
  }
}

__global__ void __launch_bounds__(kThreads)
nibble_unpack_kernel(const uint8_t* __restrict__ b, int8_t* __restrict__ out,
                     int64_t n_bytes) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_bytes; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int v = b[i];
    out[2 * i] = static_cast<int8_t>(((v & 0xF) ^ 8) - 8);
    out[2 * i + 1] = static_cast<int8_t>((((v >> 4) & 0xF) ^ 8) - 8);
  }
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

REPRO_EXPORT int repro_nibble_pack(const void* q, void* out,
                                   long long n_bytes, void* stream) {
  if (n_bytes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  repro::nibble_pack_kernel<<<repro::grid_for(n_bytes), repro::kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<uint8_t*>(out), n_bytes);
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXPORT int repro_nibble_unpack(const void* b, void* out,
                                     long long n_bytes, void* stream) {
  if (n_bytes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  repro::nibble_unpack_kernel<<<repro::grid_for(n_bytes), repro::kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(b), static_cast<int8_t*>(out), n_bytes);
  return static_cast<int>(cudaGetLastError());
}
