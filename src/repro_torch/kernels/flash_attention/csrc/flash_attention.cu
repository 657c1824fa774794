// B2 — causal (+ sliding window) GQA flash attention for prefill, Hopper.
//
// Replaces: src/repro/kernels/flash_attention/flash_kernel.py ·
// flash_attention_pallas, generalised in two ways:
//   * per-sequence query offset q_offset[b] and KV length kv_len[b], so one
//     kernel serves whole-prompt prefill (offset 0, kv_len = S) and a paged
//     prefill chunk over the gathered KV view (offset pos[b], kv_len
//     pos[b] + S): query s of sequence b sits at absolute position
//     q_offset[b] + s and attends to KV positions <= it (and > it - window);
//   * a ragged last tile is masked, in place of the TPU kernel's
//     S % block == 0 assertion: serving prompts have any length.
//
// Bound on the H100: at serving prompt lengths (S <= a few thousand,
// D = 128) causal prefill attention does ~S/2 * 4 * D FLOPs per query head
// per query for ~(S * Hkv * D * 2 * 2) bytes of K/V, i.e. it is
// operation-bound once S reaches a few hundred.  This first version is a
// plain, correct tiling on the CUDA cores (f32 FMAs, no tensor cores):
//   * one CTA of 256 threads per (64-query tile, query head, batch row);
//     the KV head is q_head / G, so the G query heads of a KV head reread
//     the same K/V tiles through L2;
//   * K/V tiles of 32 rows are staged in shared memory as f32 (row stride
//     D + 1 floats so that the score loop reads distinct banks);
//   * four threads own one query row: each holds 8 of the tile's 32 scores
//     and 1/4 of the row's D output columns, with the online-softmax max
//     and denominator in f32 registers (reduced over the four lanes by
//     shuffles);
//   * KV tiles wholly outside the causal frontier or before the window are
//     never loaded, as flash_kernel.py skips them with pl.when.
// The tensor-core (wgmma + TMA) version is a later step.
// Numerics: f32 accumulation, masked scores at finfo(f32).min, p kept in
// f32 for the PV product, denominator clamped at 1e-30, output cast to the
// input type.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kBQ = 64;        // queries per CTA
constexpr int kBK = 32;        // keys per staged tile
constexpr int kThreads = 256;  // 4 threads per query row

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     const int* __restrict__ q_offset,
                     const int* __restrict__ kv_len, int S, int T_kv, int Hq,
                     int Hkv, int window, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kBK + 1;
  constexpr int KC = kBK / 4;  // scores per thread per tile
  constexpr int DC = D / 4;    // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // [kBQ][DP]
  float* Ks = Qs + kBQ * DP;     // [kBK][DP]
  float* Vs = Ks + kBK * DP;     // [kBK][D]
  float* Ps = Vs + kBK * D;      // [kBQ][PP]

  const int tid = threadIdx.x;
  const int r = tid >> 2, c = tid & 3;
  const int q0 = blockIdx.x * kBQ;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int qoff = q_offset[b];
  const int kvl = min(kv_len[b], T_kv);
  const int64_t q_rs = static_cast<int64_t>(Hq) * D;
  const int64_t kv_rs = static_cast<int64_t>(Hkv) * D;
  const T* qb = q + static_cast<int64_t>(b) * S * q_rs + static_cast<int64_t>(hq) * D;
  const T* kb = k + static_cast<int64_t>(b) * T_kv * kv_rs + static_cast<int64_t>(hk) * D;
  const T* vb = v + static_cast<int64_t>(b) * T_kv * kv_rs + static_cast<int64_t>(hk) * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int rr = i / D, cc = i % D;
    const int qi = q0 + rr;
    Qs[rr * DP + cc] = qi < S ? to_f32(qb[qi * q_rs + cc]) : 0.f;
  }

  const int qi = q0 + r;
  const bool row_ok = qi < S;
  const int qpos = qoff + qi;
  // KV tiles any query of this tile can see
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_hi = min(kvl, qoff + q_last + 1);
  int k_lo = window > 0 ? max(0, qoff + q0 - window + 1) : 0;
  k_lo = (k_lo / kBK) * kBK;

  float m = kNegInf, l = 0.f;
  float acc[DC];
#pragma unroll
  for (int i = 0; i < DC; ++i) acc[i] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // Q staged / previous tile consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int rr = i / D, cc = i % D;
      const int kj = k0 + rr;
      float kv = 0.f, vv = 0.f;
      if (kj < kvl) {
        kv = to_f32(kb[kj * kv_rs + cc]);
        vv = to_f32(vb[kj * kv_rs + cc]);
      }
      Ks[rr * DP + cc] = kv;
      Vs[rr * D + cc] = vv;
    }
    __syncthreads();

    float s[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) s[j] = 0.f;
    const float* qrow = Qs + r * DP;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qv = qrow[d];
#pragma unroll
      for (int j = 0; j < KC; ++j) s[j] += qv * Ks[(j * 4 + c) * DP + d];
    }
    float bmax = kNegInf;
    bool ok[KC];
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      const int kj = k0 + j * 4 + c;
      ok[j] = row_ok && kj < kvl && kj <= qpos &&
              (window <= 0 || kj > qpos - window);
      s[j] = ok[j] ? s[j] * scale : kNegInf;
      bmax = fmaxf(bmax, s[j]);
    }
    bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, 1));
    bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, 2));
    const float m_new = fmaxf(m, bmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      const float p = ok[j] ? expf(s[j] - m_new) : 0.f;
      Ps[r * PP + j * 4 + c] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // a row's P is written and read by the same warp

#pragma unroll
    for (int i = 0; i < DC; ++i) acc[i] *= alpha;
    const float* prow = Ps + r * PP;
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float p = prow[kk];
      const float* vrow = Vs + kk * D + c;
#pragma unroll
      for (int i = 0; i < DC; ++i) acc[i] += p * vrow[4 * i];
    }
  }

  if (row_ok) {
    const float inv = 1.f / fmaxf(l, kMinDenom);
    T* orow = out + (static_cast<int64_t>(b) * S + qi) * q_rs +
              static_cast<int64_t>(hq) * D;
#pragma unroll
    for (int i = 0; i < DC; ++i) orow[c + 4 * i] = from_f32<T>(acc[i] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const int* q_offset, const int* kv_len, int B, int S,
                   int T_kv, int Hq, int Hkv, int window, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_prefill_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), q_offset, kv_len, S,
      T_kv, Hq, Hkv, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     void* out, const int* qo, const int* kl, int B, int S,
                     int T_kv, int Hq, int Hkv, int window, float scale,
                     cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, out, qo, kl, B, S, T_kv, Hq, Hkv, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, qo, kl, B, S, T_kv, Hq, Hkv, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, qo, kl, B, S, T_kv, Hq, Hkv, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// q [B,S,Hq,D], k/v [B,T,Hkv,D], out [B,S,Hq,D], all contiguous;
// q_offset/kv_len [B] int32 on the device; window <= 0 means none.
REPRO_EXPORT int repro_flash_prefill(const void* q, const void* k,
                                     const void* v, void* out,
                                     const void* q_offset, const void* kv_len,
                                     int B, int S, int T_kv, int Hq, int Hkv,
                                     int D, int window, float scale,
                                     int dtype, void* stream) {
  if (B <= 0 || S <= 0 || T_kv <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      Hq > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qo = static_cast<const int*>(q_offset);
  const int* kl = static_cast<const int*>(kv_len);
  if (dtype == repro::kFloat32)
    return repro::dispatch<float>(D, q, k, v, out, qo, kl, B, S, T_kv, Hq, Hkv, window, scale, s);
  if (dtype == repro::kBFloat16)
    return repro::dispatch<__nv_bfloat16>(D, q, k, v, out, qo, kl, B, S, T_kv, Hq, Hkv, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
