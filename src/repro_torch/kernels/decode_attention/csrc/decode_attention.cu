// B3 / B4 — flash-decode for Hopper: one query token per sequence against a
// contiguous KV cache (B3) or against KV pages named by a block table (B4).
//
// Replaces: src/repro/kernels/decode_attention/decode_kernel.py ·
// decode_attention_pallas (B3) and paged_kernel.py ·
// paged_decode_attention_pallas (B4).  One kernel, templated on the
// addressing, serves both:
//   * B3 takes per-sequence lengths[b] in place of the TPU kernel's one
//     valid[W] mask for the whole batch.  Continuous batching decodes at
//     pos[b]; decode_cache_mask(W, pos + 1, window) is idx < min(pos + 1, W)
//     for the ring cache, wrap included, so a length is all it needs.
//   * B4 reads physical page block_tables[b, j] of the [P, ps, Hkv, D] pools
//     in place, through the pools' strides.  The TPU wrapper transposes the
//     whole pool on every call; nothing here copies.  The page loop stops at
//     min(ceil(lengths[b] / ps), n), and a table entry outside [0, P) is
//     treated as masked, so no read leaves the pool (inactive slots carry
//     rows of scratch page 0 and garbage positions).
//
// Bound on the H100: device-memory bytes.  Every cached K/V row of a live
// sequence is read once per step for 4 * G * D FLOPs per 4 * D bytes (bf16),
// about G operations per byte, two orders below the card's ratio.  Design:
//   * one CTA of 8 warps per (KV head, sequence); the G query heads of that
//     KV head share every K/V row the CTA reads;
//   * a lane owns D/32 columns; a warp takes 4 consecutive keys at a time
//     (independent loads and shuffle reductions for latency hiding), and
//     the 8 warps split the keys, each with its own online-softmax state in
//     f32 registers;
//   * a final pass through shared memory merges the warps' (max, sum, acc).
// Known limit: at B = 4 slots x Hkv = 8 this is 32 CTAs on 132 SMs, so one
// step cannot draw the card's full bandwidth.  Split-KV is a later step.
// Numerics: f32 accumulation, masked scores at finfo(f32).min, p in f32,
// denominator clamped at 1e-30, output cast to the input type.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kKeys = 4;   // keys per warp iteration
constexpr int kMaxG = 8;   // query heads per KV head

// Contiguous cache [B, W, Hkv, D] (any strides, last dim unit stride).
struct ContigAddr {
  int64_t sb, sw, sh;
  int W;
  __device__ int64_t offset(int b, int idx, int h) const {
    return b * sb + idx * sw + h * sh;
  }
  __device__ int span() const { return W; }
};

// Page pools [P, ps, Hkv, D] + block tables [B, n] int32.
struct PagedAddr {
  const int* bt;
  int64_t sp, sr, sh;
  int P, ps, n;
  __device__ int64_t offset(int b, int idx, int h) const {
    const int j = idx / ps;
    const int page = bt[static_cast<int64_t>(b) * n + j];
    if (page < 0 || page >= P) return -1;
    return page * sp + (idx - j * ps) * sr + h * sh;
  }
  __device__ int span() const { return n * ps; }
};

template <int D>
size_t smem_bytes(int G) {
  return sizeof(float) * (2 * kWarps * kMaxG + kWarps * G * D);
}

template <typename T, int D, class Addr>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out,
              const int* __restrict__ lengths, Addr addr, int Hkv, int G,
              float scale) {
  constexpr int DPL = D / 32;
  extern __shared__ float smem[];
  float* sm_m = smem;                          // [kWarps][kMaxG]
  float* sm_l = sm_m + kWarps * kMaxG;         // [kWarps][kMaxG]
  float* sm_acc = sm_l + kWarps * kMaxG;       // [kWarps][G][D]

  const int h = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int len = max(0, min(lengths[b], addr.span()));
  const int Hq = Hkv * G;

  float qv[kMaxG][DPL], acc[kMaxG][DPL], m[kMaxG], l[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      acc[g][i] = 0.f;
      qv[g][i] = g < G ? to_f32(q[(static_cast<int64_t>(b) * Hq + h * G + g) * D +
                                  lane * DPL + i])
                       : 0.f;
    }
  }

  for (int k0 = warp * kKeys; k0 < len; k0 += kWarps * kKeys) {
    float kf[kKeys][DPL], vf[kKeys][DPL], s[kKeys][kMaxG];
    bool ok[kKeys];
#pragma unroll
    for (int kk = 0; kk < kKeys; ++kk) {
      const int idx = k0 + kk;
      const int64_t off = idx < len ? addr.offset(b, idx, h) : -1;
      ok[kk] = off >= 0;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        kf[kk][i] = ok[kk] ? to_f32(k[off + lane * DPL + i]) : 0.f;
        vf[kk][i] = ok[kk] ? to_f32(v[off + lane * DPL + i]) : 0.f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kKeys; ++kk) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        float part = 0.f;
        if (g < G) {
#pragma unroll
          for (int i = 0; i < DPL; ++i) part += qv[g][i] * kf[kk][i];
          part = warp_sum(part);
        }
        s[kk][g] = ok[kk] ? part * scale : kNegInf;
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) continue;
      float bmax = kNegInf;
#pragma unroll
      for (int kk = 0; kk < kKeys; ++kk) bmax = fmaxf(bmax, s[kk][g]);
      const float m_new = fmaxf(m[g], bmax);
      const float alpha = expf(m[g] - m_new);
      l[g] *= alpha;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[g][i] *= alpha;
#pragma unroll
      for (int kk = 0; kk < kKeys; ++kk) {
        const float p = ok[kk] ? expf(s[kk][g] - m_new) : 0.f;
        l[g] += p;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] += p * vf[kk][i];
      }
      m[g] = m_new;
    }
  }

#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) continue;
    if (lane == 0) {
      sm_m[warp * kMaxG + g] = m[g];
      sm_l[warp * kMaxG + g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      sm_acc[(warp * G + g) * D + lane * DPL + i] = acc[g][i];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < G * D; t += kThreads) {
    const int g = t / D, d = t % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w * kMaxG + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w * kMaxG + g] - M);
      L += sm_l[w * kMaxG + g] * f;
      A += sm_acc[(w * G + g) * D + d] * f;
    }
    out[(static_cast<int64_t>(b) * Hq + h * G + g) * D + d] =
        from_f32<T>(A / fmaxf(L, kMinDenom));
  }
}

template <typename T, class Addr>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     void* out, const int* lengths, const Addr& addr, int B,
                     int Hkv, int G, float scale, cudaStream_t s) {
  if (G < 1 || G > kMaxG || B <= 0 || Hkv <= 0 || B > 65535)
    return cudaErrorInvalidValue;
  dim3 grid(Hkv, B);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  switch (D) {
    case 32:
      decode_kernel<T, 32, Addr><<<grid, kThreads, smem_bytes<32>(G), s>>>(qp, kp, vp, op, lengths, addr, Hkv, G, scale);
      break;
    case 64:
      decode_kernel<T, 64, Addr><<<grid, kThreads, smem_bytes<64>(G), s>>>(qp, kp, vp, op, lengths, addr, Hkv, G, scale);
      break;
    case 128:
      decode_kernel<T, 128, Addr><<<grid, kThreads, smem_bytes<128>(G), s>>>(qp, kp, vp, op, lengths, addr, Hkv, G, scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// B3.  q/out [B, Hq, D] contiguous; k/v [B, W, Hkv, D] with element strides
// (sb, sw, sh) and unit last-dim stride; lengths [B] int32 on the device.
REPRO_EXPORT int repro_decode_attention(
    const void* q, const void* k, const void* v, void* out,
    const void* lengths, int B, int W, int Hkv, int G, int D, long long sb,
    long long sw, long long sh, float scale, int dtype, void* stream) {
  repro::ContigAddr addr{sb, sw, sh, W};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  if (dtype == repro::kFloat32)
    return repro::dispatch<float>(D, q, k, v, out, len, addr, B, Hkv, G, scale, s);
  if (dtype == repro::kBFloat16)
    return repro::dispatch<__nv_bfloat16>(D, q, k, v, out, len, addr, B, Hkv, G, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// B4.  q/out [B, Hq, D] contiguous; k/v pools [P, ps, Hkv, D] with element
// strides (sp, sr, sh) and unit last-dim stride (K and V pools share them);
// block_tables [B, n] and lengths [B] int32 on the device.
REPRO_EXPORT int repro_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages, void* out,
    const void* block_tables, const void* lengths, int B, int P, int ps,
    int n, int Hkv, int G, int D, long long sp, long long sr, long long sh,
    float scale, int dtype, void* stream) {
  if (ps <= 0 || n <= 0 || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  repro::PagedAddr addr{static_cast<const int*>(block_tables), sp, sr, sh, P, ps, n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  if (dtype == repro::kFloat32)
    return repro::dispatch<float>(D, q, k_pages, v_pages, out, len, addr, B, Hkv, G, scale, s);
  if (dtype == repro::kBFloat16)
    return repro::dispatch<__nv_bfloat16>(D, q, k_pages, v_pages, out, len, addr, B, Hkv, G, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
