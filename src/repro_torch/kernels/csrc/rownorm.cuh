// The row RMSNorm shared by B1 (rmsnorm.cu), add_rms_norm (rmsnorm.cu) and
// dequantize_add_rms_norm (quant_collective.cu):
//
//   s = the row's values (x; x + y; x + dequantize(q)), each rounded once
//       to T as the unfused chain rounds it,
//   n = (s * rsqrt(mean(s^2) + eps)) * (1 + w), in f32, rounded at the store.
//
// Bound on the H100: device-memory bytes (x, y or q read once, s and n
// written once; a few operations per element).  At the decode shape, 4 rows
// of 3072, the launch and one round trip to memory set the time, so:
//   * one read of the inputs: a 16-byte aligned row of up to kNormMaxVec
//     vectors (8192 bf16 or 4096 f32 values) stays in registers, V <= 8
//     vectors of 8 bf16 or 4 f32 values a thread, from the load through
//     the sum to the store (at V = 16 ptxas spilled); wider or unaligned
//     rows take the element path, which reads the inputs again for the
//     store (the second read hits L1: the same thread read them);
//   * kNormThreads threads a row, vector c on thread c % kNormThreads, so at
//     h = 3072 (384 bf16 vectors) and 4096 (512) every thread holds the same
//     number;
//   * every load of a row issued before its first value is computed (one
//     round trip to memory, not one per dependent step);
//   * w loaded once per CTA, before its row loop; the grid is as many CTAs
//     as the card holds at once (or one per row), so at many rows each CTA
//     takes every gridDim-th row and no SM waits on a tail.
// The sum of squares keeps the tree of the earlier B1 (one 256-thread CTA a
// row): 256 lanes, lane l summing vectors l, l + 256, ... in order, then a
// butterfly in each warp and the eight warp sums by warp 0.  Each thread
// carries two lanes (u and u + 128), so n is bit for bit that kernel's and
// the same in all three kernels for the same s.
#pragma once

#include <algorithm>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kNormThreads = 128;
constexpr int kNormLanes = 2 * kNormThreads;
constexpr int kNormMaxVec = 8 * kNormThreads;   // 16-byte vectors a row

// The sum over the 256 lanes, lane u in a and lane u + 128 in b: each warp's
// lanes by butterflies, then the eight warp sums (lanes 0-127 in warps 0-3,
// lanes 128-255 in warps 4-7, as the earlier B1's warps held them) by warp 0.
// partial has kNormLanes / 32 + 1 floats; the total goes to the last, so
// the next row's partials cannot overwrite it before every thread read it.
__device__ __forceinline__ float norm_block_sum(float a, float b,
                                                float* partial) {
  constexpr int kWarps = kNormThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    partial[warp] = a;
    partial[warp + kWarps] = b;
  }
  __syncthreads();
  if (warp == 0) {
    float v = lane < kNormLanes / 32 ? partial[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) partial[kNormLanes / 32] = v;
  }
  __syncthreads();
  return partial[kNormLanes / 32];
}

// Src gives a row's values before the norm, already rounded to T:
//   fetch(row, e, raw)     loads what the Vec16<T>::N values at e.. need
//                          into registers, and nothing else (16-byte path)
//   values(row, e, raw, f) computes them from raw
//   at(row, e)             the value at e (element path)
// and kStore says whether they are the kernel's s output.  Every load of a
// row is issued before the first value is computed, so the row costs one
// round trip to memory.
// V > 0: the row in registers, V vectors a thread; V == 0: element path.
template <typename T, typename Src, int V>
__global__ void __launch_bounds__(kNormThreads)
rownorm_kernel(const Src src, const T* __restrict__ w, T* __restrict__ s_out,
               T* __restrict__ n_out, int64_t rows, int h, float eps) {
  __shared__ float partial[kNormLanes / 32 + 1];
  constexpr int N = Vec16<T>::N;
  const int u = threadIdx.x;
  if constexpr (V > 0) {
    // thread u holds vectors u + 128 k: even k belong to lane u, odd k to
    // lane u + 128, each in the order the lane summed them.  w stays raw
    // in registers: converting it here would hold the first row's loads
    // behind w's.
    uint4 wraw[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int e = (u + k * kNormThreads) * N;
      if (e < h) wraw[k] = load16(w + e);
    }
    for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
      typename Src::Raw raw[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int e = (u + k * kNormThreads) * N;
        if (e < h) src.fetch(row, e, raw[k]);
      }
      float f[V][N];
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int e = (u + k * kNormThreads) * N;
        if (e >= h) continue;
        src.values(row, e, raw[k], f[k]);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          if (k % 2 == 0)
            a += f[k][j] * f[k][j];
          else
            b += f[k][j] * f[k][j];
        }
      }
      const float r =
          rsqrtf(norm_block_sum(a, b, partial) / static_cast<float>(h) + eps);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int e = (u + k * kNormThreads) * N;
        if (e >= h) continue;
        if constexpr (Src::kStore) Vec16<T>::store(s_out + row * h + e, f[k]);
        float g[N];
        Vec16<T>::unpack(wraw[k], g);
#pragma unroll
        for (int j = 0; j < N; ++j) f[k][j] = (f[k][j] * r) * (1.f + g[j]);
        Vec16<T>::store(n_out + row * h + e, f[k]);
      }
    }
  } else {
    // the same lanes over N-element groups, one element at a time
    for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
      float a = 0.f, b = 0.f;
      for (int c = u, k = 0; c * N < h; c += kNormThreads, ++k) {
        const int end = min(c * N + N, h);
        for (int e = c * N; e < end; ++e) {
          const float v = src.at(row, e);
          if (k % 2 == 0)
            a += v * v;
          else
            b += v * v;
          if constexpr (Src::kStore) s_out[row * h + e] = from_f32<T>(v);
        }
      }
      const float r =
          rsqrtf(norm_block_sum(a, b, partial) / static_cast<float>(h) + eps);
      for (int e = u * N; e < h; e += kNormThreads * N) {
        const int end = min(e + N, h);
        for (int i = e; i < end; ++i) {
          n_out[row * h + i] =
              from_f32<T>((src.at(row, i) * r) * (1.f + to_f32(w[i])));
        }
      }
    }
  }
}

template <typename T, typename Src, int V>
cudaError_t launch_rownorm_v(const Src& src, const T* w, T* s_out, T* n_out,
                             int64_t rows, int h, float eps,
                             cudaStream_t stream) {
  // as many CTAs as the card holds at once, found once per kernel
  static const int resident = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rownorm_kernel<T, Src, V>, kNormThreads, 0);
    return std::max(1, sms * per_sm);
  }();
  const int grid = static_cast<int>(std::min<int64_t>(rows, resident));
  rownorm_kernel<T, Src, V><<<grid, kNormThreads, 0, stream>>>(
      src, w, s_out, n_out, rows, h, eps);
  return cudaGetLastError();
}

// ``vector``: the source's own pointers and row strides allow 16-byte
// loads; the width and w, s and n must allow them too
template <typename T, typename Src>
cudaError_t launch_rownorm(const Src& src, bool vector, const T* w, T* s_out,
                           T* n_out, int64_t rows, int h, float eps,
                           cudaStream_t stream) {
  constexpr int N = Vec16<T>::N;
  vector = vector && h % N == 0 && h / N <= kNormMaxVec && aligned16(w) &&
           aligned16(s_out) && aligned16(n_out);
  if (!vector)
    return launch_rownorm_v<T, Src, 0>(src, w, s_out, n_out, rows, h, eps,
                                       stream);
  const int per = (h / N + kNormThreads - 1) / kNormThreads;
#define REPRO_ROWNORM(v)                                                  \
  if (per <= v)                                                           \
    return launch_rownorm_v<T, Src, v>(src, w, s_out, n_out, rows, h, eps, \
                                       stream);
  REPRO_ROWNORM(1)
  REPRO_ROWNORM(2)
  REPRO_ROWNORM(3)
  REPRO_ROWNORM(4)
  REPRO_ROWNORM(6)
#undef REPRO_ROWNORM
  return launch_rownorm_v<T, Src, 8>(src, w, s_out, n_out, rows, h, eps,
                                     stream);
}

}  // namespace
}  // namespace repro
