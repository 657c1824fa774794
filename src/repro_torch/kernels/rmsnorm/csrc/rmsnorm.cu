// B1 — fused RMSNorm for Hopper: out = x * rsqrt(mean(x^2) + eps) * (1 + w).
//
// Replaces: src/repro/kernels/rmsnorm/rmsnorm_kernel.py · rms_norm_pallas.
//
// Bound on the H100: device-memory bytes.  Each row is read once and
// written once (rows*h*2 bytes in bf16) plus the h weights; the arithmetic
// is a handful of FLOPs per element, far below the card's ratio of ~295
// operations per byte.  So the design only has to stream bytes well:
//   * one CTA per row (h = 3072 at full width is 6 KB of bf16, small enough
//     that the second pass over the row hits L1/L2, not device memory);
//   * 16-byte vector loads and stores whenever h and the pointers allow it,
//     neighbouring threads on neighbouring addresses;
//   * the f32 sum of squares reduced with warp shuffles and one small
//     shared-memory exchange between warps.
// Numerics follow the reference: f32 throughout, (x * r) * (1 + w), cast
// to the input type at the store.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;

template <typename T>
struct Vec;  // 16 bytes of T
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float (&f)[N]) {
    float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  __device__ static void store(float* p, const float (&f)[N]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <>
struct Vec<__nv_bfloat16> {
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
  __device__ static void store(__nv_bfloat16* p, const float (&f)[N]) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = v;
  }
};

__device__ float block_sum(float v) {
  __shared__ float partial[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? partial[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) partial[0] = v;
  }
  __syncthreads();
  return partial[0];
}

template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, int h, float eps) {
  const T* xr = x + static_cast<int64_t>(blockIdx.x) * h;
  T* orow = out + static_cast<int64_t>(blockIdx.x) * h;
  float ss = 0.f;
  if constexpr (kVector) {
    constexpr int N = Vec<T>::N;
    for (int i = threadIdx.x * N; i < h; i += kThreads * N) {
      float f[N];
      Vec<T>::load(xr + i, f);
#pragma unroll
      for (int j = 0; j < N; ++j) ss += f[j] * f[j];
    }
  } else {
    for (int i = threadIdx.x; i < h; i += kThreads) {
      float f = to_f32(xr[i]);
      ss += f * f;
    }
  }
  const float r = rsqrtf(block_sum(ss) / static_cast<float>(h) + eps);
  if constexpr (kVector) {
    constexpr int N = Vec<T>::N;
    for (int i = threadIdx.x * N; i < h; i += kThreads * N) {
      float f[N], g[N];
      Vec<T>::load(xr + i, f);
      Vec<T>::load(w + i, g);
#pragma unroll
      for (int j = 0; j < N; ++j) f[j] = (f[j] * r) * (1.f + g[j]);
      Vec<T>::store(orow + i, f);
    }
  } else {
    for (int i = threadIdx.x; i < h; i += kThreads) {
      orow[i] = from_f32<T>((to_f32(xr[i]) * r) * (1.f + to_f32(w[i])));
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* out, int rows, int h,
                   float eps, cudaStream_t stream) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
        reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const bool vector = aligned && h % Vec<T>::N == 0;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  if (vector)
    rmsnorm_kernel<T, true><<<rows, kThreads, 0, stream>>>(xp, wp, op, h, eps);
  else
    rmsnorm_kernel<T, false><<<rows, kThreads, 0, stream>>>(xp, wp, op, h, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

REPRO_EXPORT int repro_rmsnorm(const void* x, const void* w, void* out,
                               int rows, int h, float eps, int dtype,
                               void* stream) {
  if (rows <= 0 || h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::launch<float>(x, w, out, rows, h, eps, s);
  if (dtype == repro::kBFloat16)
    return repro::launch<__nv_bfloat16>(x, w, out, rows, h, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
