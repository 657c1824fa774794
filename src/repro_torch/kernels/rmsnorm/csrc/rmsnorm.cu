// B1 — RMSNorm for Hopper, out = x * rsqrt(mean(x^2) + eps) * (1 + w), and
// add_rms_norm, B1 with the residual add before it fused in:
// s = x + y (rounded to x's type, as torch's x + y rounds), n = B1(s).
//
// Replaces: src/repro/kernels/rmsnorm/rmsnorm_kernel.py · rms_norm_pallas;
// add_rms_norm also replaces the add that the JAX package's blocks run before
// each norm (src/repro/models/blocks.py, x = x + ...).
//
// Bound on the H100: device-memory bytes.  The design (rownorm.cuh, shared
// with the dequantize variant in quant_collective.cu) reads each input once
// and keeps the row in registers between the sum and the store; fusing the
// add saves its launch and a write and a read of s on the way to the norm.
// x and y may be row-strided (a last-axis-contiguous view, such as the last
// position of each sequence); the outputs are contiguous.
// Numerics: f32 throughout, (s * r) * (1 + w), cast once at the store; the
// sum of squares in the earlier B1's order (rownorm.cuh).
#include "rownorm.cuh"

namespace repro {
namespace {

// the rows of x (kAdd false), or of x + y rounded to T; row strides in
// elements
template <typename T, bool kAdd>
struct AddSrc {
  static constexpr bool kStore = kAdd;
  static constexpr int N = Vec16<T>::N;
  struct Raw {
    uint4 x, y;
  };
  const T* x;
  const T* y;
  int64_t xs, ys;

  __device__ void fetch(int64_t row, int e, Raw& r) const {
    r.x = load16(x + row * xs + e);
    if constexpr (kAdd) r.y = load16(y + row * ys + e);
  }
  __device__ void values(int64_t, int, const Raw& r, float (&f)[N]) const {
    Vec16<T>::unpack(r.x, f);
    if constexpr (kAdd) {
      float g[N];
      Vec16<T>::unpack(r.y, g);
#pragma unroll
      for (int j = 0; j < N; ++j) f[j] = round_to<T>(f[j] + g[j]);
    }
  }
  __device__ float at(int64_t row, int e) const {
    float v = to_f32(x[row * xs + e]);
    if constexpr (kAdd) v = round_to<T>(v + to_f32(y[row * ys + e]));
    return v;
  }
};

template <typename T>
bool strided_rows_aligned(const void* p, int64_t stride) {
  return aligned16(p) && (stride * static_cast<int64_t>(sizeof(T))) % 16 == 0;
}

template <typename T>
cudaError_t launch_rmsnorm(const void* x, const void* w, void* out,
                           int64_t rows, int h, float eps,
                           cudaStream_t stream) {
  const AddSrc<T, false> src{static_cast<const T*>(x), nullptr, h, 0};
  return launch_rownorm<T>(src, strided_rows_aligned<T>(x, h),
                           static_cast<const T*>(w), static_cast<T*>(nullptr),
                           static_cast<T*>(out), rows, h, eps, stream);
}

template <typename T>
cudaError_t launch_add_rmsnorm(const void* x, int64_t xs, const void* y,
                               int64_t ys, const void* w, void* s, void* n,
                               int64_t rows, int h, float eps,
                               cudaStream_t stream) {
  const AddSrc<T, true> src{static_cast<const T*>(x),
                            static_cast<const T*>(y), xs, ys};
  const bool vector = strided_rows_aligned<T>(x, xs) &&
                      strided_rows_aligned<T>(y, ys);
  return launch_rownorm<T>(src, vector, static_cast<const T*>(w),
                           static_cast<T*>(s), static_cast<T*>(n), rows, h,
                           eps, stream);
}

}  // namespace
}  // namespace repro

REPRO_EXPORT int repro_rmsnorm(const void* x, const void* w, void* out,
                               int rows, int h, float eps, int dtype,
                               void* stream) {
  if (rows <= 0 || h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::launch_rmsnorm<float>(x, w, out, rows, h, eps, s);
  if (dtype == repro::kBFloat16)
    return repro::launch_rmsnorm<__nv_bfloat16>(x, w, out, rows, h, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_EXPORT int repro_add_rmsnorm(const void* x, long long x_stride,
                                   const void* y, long long y_stride,
                                   const void* w, void* s, void* n,
                                   long long rows, int h, float eps, int dtype,
                                   void* stream) {
  if (rows <= 0 || h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return repro::launch_add_rmsnorm<float>(x, x_stride, y, y_stride, w, s, n,
                                            rows, h, eps, st);
  if (dtype == repro::kBFloat16)
    return repro::launch_add_rmsnorm<__nv_bfloat16>(x, x_stride, y, y_stride,
                                                    w, s, n, rows, h, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
