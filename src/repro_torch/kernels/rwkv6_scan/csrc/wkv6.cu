// B10 — the RWKV-6 WKV recurrence for Hopper, per head with an f32 state:
//
//   y_t[j]  = sum_i r_t[i] * (S[i,j] + u[i] * k_t[i] * v_t[j])
//   S[i,j] <- w_t[i] * S[i,j] + k_t[i] * v_t[j]
//
// Replaces: src/repro/kernels/rwkv6_scan/wkv6_kernel.py · wkv6_pallas.
//
// Bound on the H100: operations.  Per (b, t, h) the function needs
// 5·hs² f32 operations (r·S, an FMA; k·v; w·S + kv, an FMA) and 5·hs more
// for the u term, which is one scalar per step (v_j · sum_i r_i·u_i·k_i),
// on 5·hs values read or written (r, k, v, w, y): at hs = 64 in bf16 that
// is ~32 operations per byte, above the ratio of the card's f32 rate
// (67 TFLOP/s on the CUDA cores) to its memory rate (3.35 TB/s), ~20.
// The recurrence is a serial chain over time, though, so this design is
// bound by the latency of one step times S, not by either rate: a first,
// simple kernel, as the public RWKV-6 CUDA kernel (the one the Pallas
// docstring names) is built:
//   * one block per (b, h) with hs threads; thread j keeps column j of the
//     state (hs f32) in registers for the whole sequence, so the state is
//     read once and written once;
//   * r, k, v and w of kChunk timesteps are staged in shared memory by one
//     load pass between two barriers; the block then steps through them
//     with r_t[i], k_t[i], w_t[i] read as broadcasts and no barrier per
//     step;
//   * no time blocking of the input, so any S >= 1 (the Pallas kernel needs
//     S % 128 == 0 once S > 128 — ROADMAP C7); a decode step is S = 1;
//   * the final state may be written over the initial one: each block reads
//     its own (b, h) slice before it writes it, so a decode step updates its
//     cache in place.
// Numerics: f32 throughout, y cast to the input type at the store.  nvcc
// contracts the state update to an FMA, one rounding fewer per step than
// the plain version.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kChunk = 32;  // timesteps staged per pair of barriers

struct Args {
  const void *r, *k, *v, *w, *u, *s0;
  void *y, *s_out;
  int B, S, H;
  cudaStream_t stream;
};

template <typename T, int HS>
__global__ void __launch_bounds__(HS)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ w,
            const float* __restrict__ u, const float* s0, T* __restrict__ y,
            float* s_out, int S, int H) {
  __shared__ float rs[kChunk][HS], ks[kChunk][HS], vs[kChunk][HS],
      ws[kChunk][HS], us[HS];
  const int bh = blockIdx.x, b = bh / H, h = bh % H, j = threadIdx.x;
  const int64_t slice = static_cast<int64_t>(bh) * HS * HS;
  float st[HS];  // st[i] = S[i, j]
#pragma unroll
  for (int i = 0; i < HS; ++i) st[i] = s0[slice + i * HS + j];
  us[j] = u[h * HS + j];
  const int64_t step = static_cast<int64_t>(H) * HS;  // one timestep
  const int64_t base = static_cast<int64_t>(b) * S * step + h * HS + j;
  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int n = min(kChunk, S - t0);
    __syncthreads();  // the previous chunk is consumed (and us is written)
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      const int64_t o = base + (t0 + t) * step;
      rs[t][j] = to_f32(r[o]);
      ks[t][j] = to_f32(k[o]);
      vs[t][j] = to_f32(v[o]);
      ws[t][j] = to_f32(w[o]);
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float vj = vs[t][j];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < HS; ++i) {
        const float kv = ks[t][i] * vj;
        acc += rs[t][i] * (st[i] + us[i] * kv);
        st[i] = ws[t][i] * st[i] + kv;
      }
      y[base + (t0 + t) * step] = from_f32<T>(acc);
    }
  }
#pragma unroll
  for (int i = 0; i < HS; ++i) s_out[slice + i * HS + j] = st[i];
}

template <typename T, int HS>
cudaError_t launch(const Args& a) {
  wkv6_kernel<T, HS><<<a.B * a.H, HS, 0, a.stream>>>(
      static_cast<const T*>(a.r), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.w),
      static_cast<const float*>(a.u), static_cast<const float*>(a.s0),
      static_cast<T*>(a.y), static_cast<float*>(a.s_out), a.S, a.H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_head_size(const Args& a, int hs) {
  switch (hs) {
    case 16: return launch<T, 16>(a);
    case 32: return launch<T, 32>(a);
    case 64: return launch<T, 64>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

REPRO_EXPORT int repro_wkv6(const void* r, const void* k, const void* v,
                            const void* w, const void* u, const void* s0,
                            void* y, void* s_out, int B, int S, int H, int hs,
                            int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const repro::Args a{r, k, v, w, u, s0, y, s_out, B, S, H,
                      static_cast<cudaStream_t>(stream)};
  if (dtype == repro::kFloat32)
    return repro::by_head_size<float>(a, hs);
  if (dtype == repro::kBFloat16)
    return repro::by_head_size<__nv_bfloat16>(a, hs);
  return static_cast<int>(cudaErrorInvalidValue);
}
