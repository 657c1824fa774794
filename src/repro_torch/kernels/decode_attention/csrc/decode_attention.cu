// B3 / B4 — flash-decode for Hopper: one query token per sequence against a
// contiguous KV cache (B3) or against KV pages named by a block table (B4).
//
// Replaces: src/repro/kernels/decode_attention/decode_kernel.py:56 ·
// decode_attention_pallas (B3) and paged_kernel.py:70 ·
// paged_decode_attention_pallas (B4).  Head dims 32, 64, 128 and 256
// (paligemma-3b decodes 8 query heads over one KV head at D 256), 1 to 8
// query heads a KV head.
//
// Bound on the H100: device-memory bytes.  Every cached K/V row of a live
// sequence is read once per step for 4 * G * D FLOPs per 4 * D bytes (bf16),
// about G operations per byte, two orders below the card's ratio.  What
// sets the time is how many bytes are in flight at once across the SMs.
//
// One design for both, a split-KV pair of kernels templated on the
// addressing (PagedAddr for B4, ContigAddr for B3):
//   * Split pass, grid (Hkv, B, n_splits).  Split s covers about 128 keys
//     (SPLIT_KEYS in ops.py): for B4 whole pages [s * pps, (s + 1) * pps)
//     of the block table, pps = max(1, 128 / ps) (ops.split_geometry), and
//     n_splits = ceil(n / pps) comes from the table width; for B3 rows
//     [128 s, 128 (s + 1)) of the cache, n_splits = ceil(W / 128).  No
//     length is read on the host.  A split past the sequence's length exits
//     at once; at B 4, lengths 1/17/300/1024 (W 1024, or ps 16 and n 64)
//     that leaves 104 live CTAs of 256 (32 CTAs without the split), spread
//     over the 132 SMs.  Inside a CTA of 8 warps:
//       - B4: the CTA's slice of block_tables goes into shared memory once,
//         loaded beside the sequence's length (B3 has no table);
//       - K and V rows come in by cp.async, 16 bytes a copy (8 bf16 or 4
//         f32), into a ring of four stages of 32 rows (two pages at ps 16;
//         64 at bf16 D 32, one row per lane group), so a 128-key split is
//         in flight at once; f32 at D 256 (1 KB rows, 64 KB a stage) keeps
//         three stages, 192 KB of the 227 KB a block may have; a row past
//         the length, or (B4) on a table entry outside [0, P), is
//         zero-filled and flagged masked in shared memory, so no read
//         leaves the cache or the pool (inactive slots carry rows of
//         scratch page 0);
//       - a lane owns one 16-byte vector of columns of one row at a time
//         (a 128-wide bf16 row is 16 lanes, a warp reads two rows per
//         instruction), or, where a row is wider than a warp's 32 vectors
//         (f32 at D 256), NV = 2 vectors 32 lanes apart, so each load of
//         the warp still reads 512 consecutive bytes; a score is reduced
//         across that row's lanes only (4 shuffles for bf16 D 128, not 5);
//       - the G query heads of the KV head share every staged row, each
//         with its own f32 online softmax (max, sum, accumulator);
//       - the row streams of a warp merge by shuffles, the 8 warps through
//         shared memory, into one partial per (query head, split): the
//         max m, the sum l and the unnormalised accumulator acc, in f32.
//   * Combine pass, grid (Hq, B), D threads: reads lengths itself, merges
//     the live splits' partials, M = max m, out = sum acc e^(m - M) /
//     max(sum l e^(m - M), 1e-30), cast to the input type.  An empty
//     partial (every row masked) has m = finfo(f32).min and l = 0, so no
//     exp(-inf - (-inf)) arises.  The wrapper allocates the partials.
//   Both take exponentials with __expf (ex2.approx on x * log2(e)), within
//   2 + 1.16 |x| f32 ulp of expf (CUDA's documented bound); the f32 checks
//   hold the pair to 1e-4.
//
// B3 takes per-sequence lengths[b] in place of the TPU kernel's one
// valid[W] mask for the whole batch (continuous batching decodes at pos[b];
// decode_cache_mask(W, pos + 1, window) is idx < min(pos + 1, W) for the
// ring cache, wrap included, so a length is all it needs).  Both wrappers
// check that the cache's base and strides are multiples of 16 bytes.
// Numerics (both): f32 accumulation, masked scores at finfo(f32).min, p in
// f32, denominator clamped at 1e-30, output cast to the input type.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kMaxG = 8;        // query heads per KV head
constexpr int kSplitKeys = 128; // B3's rows per split (SPLIT_KEYS in ops.py)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;      // ring depth: a 128-row split is in flight at once
constexpr int kMaxRing = 200 * 1024;  // the ring's shared memory at most
constexpr int kMaxTable = 128;  // pages one split covers at most (ps >= 1)

// Contiguous caches [B, W, Hkv, D] (element strides sb, sw, sh, unit
// last-dim stride; K and V alike).  Split s covers rows [128 s, 128 (s + 1)).
struct ContigAddr {
  int64_t sb, sw, sh;
  int W;
  __device__ int span() const { return W; }
  __device__ int split_rows() const { return kSplitKeys; }
  __device__ void stage(int, int, int*) const {}
  // element offset of row idx of KV head h (never masked)
  __device__ int64_t offset(int b, int, int idx, int h, const int*) const {
    return b * sb + idx * sw + h * sh;
  }
};

// Page pools [P, ps, Hkv, D] (element strides sp, sr, sh, unit last-dim
// stride; K and V alike) + block tables [B, n] int32.  Split s covers the
// table's pages [s * pps, (s + 1) * pps).
struct PagedAddr {
  const int* bt;
  int64_t sp, sr, sh;
  int P, ps, n, pps;
  __device__ int span() const { return n * ps; }
  __device__ int split_rows() const { return pps * ps; }
  // the split's slice of the table -> tbl (every thread of the CTA calls)
  __device__ void stage(int b, int s, int* tbl) const {
    const int j0 = s * pps, cnt = min(pps, n - j0);
    for (int i = threadIdx.x; i < cnt; i += blockDim.x)
      tbl[i] = bt[static_cast<int64_t>(b) * n + j0 + i];
  }
  // element offset of logical row idx of KV head h, or -1 when masked
  __device__ int64_t offset(int b, int s, int idx, int h,
                            const int* tbl) const {
    const int j = idx / ps;
    const int page = tbl[j - s * pps];
    if (page < 0 || page >= P) return -1;
    return page * sp + (idx - j * ps) * sr + h * sh;
  }
};

template <typename T, int D>
struct Geo {
  static constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // a vector
  static constexpr int CPR = D / VEC;            // 16-byte vectors per row
  static constexpr int NV = CPR > 32 ? CPR / 32 : 1;  // vectors per lane
  static constexpr int EPL = NV * VEC;           // elements per lane
  static constexpr int LPR = D / EPL;            // lanes per row
  static constexpr int RPW = 32 / LPR;           // rows a warp holds at once
  static constexpr int NS = kWarps * RPW;        // row streams per CTA
  static constexpr int ROWS = NS > 32 ? NS : 32; // rows per ring stage
  static constexpr int RPS = ROWS / NS;          // rows per stream per stage
  static constexpr int ROW = D * static_cast<int>(sizeof(T));  // bytes
  static constexpr int STAGE = 2 * ROWS * ROW;   // K and V rows
  static constexpr int STAGES = kStages * STAGE <= kMaxRing ? kStages
                                                            : kStages - 1;
  static constexpr int SMEM = STAGES * STAGE;
  static_assert(LPR * EPL == D && 32 % LPR == 0, "a row is whole lanes");
  static_assert(ROWS * CPR % kThreads == 0 && ROWS % NS == 0, "geometry");
  static_assert(SMEM <= kMaxRing, "the ring fits a block's shared memory");
  static_assert(kWarps * kMaxG * D * 4 <= SMEM, "merge area fits the ring");
  // the column of element e of this lane's share of a row (lane seg of LPR)
  __device__ static int col(int seg, int e) {
    return ((e / VEC) * LPR + seg) * VEC + e % VEC;
  }
};

__device__ __forceinline__ void load16(const float* p, float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// this lane's EPL elements of one row: its NV vectors, LPR vectors apart
template <typename T, int D>
__device__ __forceinline__ void load_lane(const T* row, int seg,
                                          float (&f)[Geo<T, D>::EPL]) {
  using Gm = Geo<T, D>;
#pragma unroll
  for (int n = 0; n < Gm::NV; ++n)
    load16(row + (n * Gm::LPR + seg) * Gm::VEC,
           *reinterpret_cast<float(*)[Gm::VEC]>(f + n * Gm::VEC));
}

template <typename T, int D, class Addr>
__global__ void __launch_bounds__(kThreads)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ lengths,
             Addr addr, float* __restrict__ pm, float* __restrict__ pl,
             float* __restrict__ pacc, int Hkv, int G, int n_splits,
             float scale) {
  using Gm = Geo<T, D>;
  constexpr int EPL = Gm::EPL, LPR = Gm::LPR, ROWS = Gm::ROWS;
  constexpr int CPR = Gm::CPR, STAGES = Gm::STAGES;
  extern __shared__ __align__(16) uint8_t ring[];
  __shared__ int tbl[kMaxTable];
  __shared__ bool live_row[STAGES][ROWS];
  __shared__ float sm_m[kWarps][kMaxG], sm_l[kWarps][kMaxG];

  const int h = blockIdx.x, b = blockIdx.y, sx = blockIdx.z;
  addr.stage(b, sx, tbl);  // loads beside the length's load
  const int len = max(0, min(lengths[b], addr.span()));
  const int row0 = sx * addr.split_rows();
  if (row0 >= len) return;  // an empty split: the combine pass skips it
  const int nrows = min(len, row0 + addr.split_rows()) - row0;
  __syncthreads();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int seg = lane % LPR;                   // this lane's columns
  const int stream = warp * Gm::RPW + lane / LPR;
  const int Hq = Hkv * G;
  const uint32_t ring_s = smem_u32(ring);

  // cp.async the K and V rows of ring chunk c (zero-filled where masked)
  const int n_chunks = (nrows + ROWS - 1) / ROWS;
  auto fetch = [&](int c) {
    const int st = c % STAGES;
    const uint32_t sk = ring_s + st * Gm::STAGE;
    const uint32_t sv = sk + ROWS * Gm::ROW;
#pragma unroll
    for (int j = 0; j < ROWS * CPR / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / CPR, sg = i % CPR;
      const int idx = c * ROWS + r;
      const int64_t off =
          idx < nrows ? addr.offset(b, sx, row0 + idx, h, tbl) : -1;
      const bool ok = off >= 0;
      if (sg == 0) live_row[st][r] = ok;
      const int64_t e = (ok ? off : 0) + sg * Gm::VEC;
      cp_async16(sk + r * Gm::ROW + sg * 16, k + e, ok);
      cp_async16(sv + r * Gm::ROW + sg * 16, v + e, ok);
    }
  };
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < n_chunks) fetch(c);
    cp_async_commit();
  }

  float qv[kMaxG][EPL], acc[kMaxG][EPL], m[kMaxG], l[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      acc[g][e] = 0.f;
      qv[g][e] = g < G ? to_f32(q[(static_cast<int64_t>(b) * Hq + h * G + g) * D +
                                  Gm::col(seg, e)])
                       : 0.f;
    }
  }

  for (int c = 0; c < n_chunks; ++c) {
    if (c + STAGES - 1 < n_chunks) fetch(c + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // chunk c has landed
    __syncthreads();
    const int st = c % STAGES;
    const T* sk = reinterpret_cast<const T*>(ring + st * Gm::STAGE);
    const T* sv = sk + ROWS * D;

    // scores of this stream's rows: the row's LPR lanes reduce together
    float s[Gm::RPS][kMaxG];
    bool ok[Gm::RPS];
#pragma unroll
    for (int rr = 0; rr < Gm::RPS; ++rr) {
      const int r = stream + rr * Gm::NS;
      ok[rr] = live_row[st][r];
      float kf[EPL];
      load_lane<T, D>(sk + r * D, seg, kf);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        float part = 0.f;
        if (g < G) {
#pragma unroll
          for (int e = 0; e < EPL; ++e) part += qv[g][e] * kf[e];
#pragma unroll
          for (int o = LPR / 2; o > 0; o >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, o);
        }
        s[rr][g] = ok[rr] ? part * scale : kNegInf;
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) continue;
      float bmax = kNegInf;
#pragma unroll
      for (int rr = 0; rr < Gm::RPS; ++rr) bmax = fmaxf(bmax, s[rr][g]);
      const float m_new = fmaxf(m[g], bmax);
      const float alpha = __expf(m[g] - m_new);
      m[g] = m_new;
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int rr = 0; rr < Gm::RPS; ++rr) {
      const int r = stream + rr * Gm::NS;
      float vf[EPL];
      load_lane<T, D>(sv + r * D, seg, vf);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) continue;
        const float p = ok[rr] ? __expf(s[rr][g] - m[g]) : 0.f;
        l[g] += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] += p * vf[e];
      }
    }
    __syncthreads();  // chunk c's stage is refilled next
  }
  cp_async_wait<0>();

  // merge the warp's row streams (lanes lane ^ LPR, ^ 2 LPR, ... hold the
  // same columns), then the warps through shared memory
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) continue;
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float M = fmaxf(m[g], mo);
      const float fa = __expf(m[g] - M), fb = __expf(mo - M);
      l[g] = l[g] * fa + lo * fb;
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc[g][e] = acc[g][e] * fa +
                    __shfl_xor_sync(0xffffffffu, acc[g][e], off) * fb;
      m[g] = M;
    }
  }
  float* sm_acc = reinterpret_cast<float*>(ring);  // [kWarps][kMaxG][D]
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) continue;
    if (lane < LPR) {
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        sm_acc[(warp * kMaxG + g) * D + Gm::col(seg, e)] = acc[g][e];
    }
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
  __syncthreads();
  for (int t = tid; t < G * D; t += kThreads) {
    const int g = t / D, d = t % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = __expf(sm_m[w][g] - M);
      L += sm_l[w][g] * f;
      A += sm_acc[(w * kMaxG + g) * D + d] * f;
    }
    const int64_t row =
        (static_cast<int64_t>(b) * Hq + h * G + g) * n_splits + sx;
    pacc[row * D + d] = A;
    if (d == 0) {
      pm[row] = M;
      pl[row] = L;
    }
  }
}

// one block of D threads per (query head, sequence): merge the live splits
template <typename T, int D>
__global__ void __launch_bounds__(D)
combine_kernel(const float* __restrict__ pm, const float* __restrict__ pl,
               const float* __restrict__ pacc, const int* __restrict__ lengths,
               T* __restrict__ out, int span, int split_rows, int n_splits) {
  const int hq = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int len = max(0, min(lengths[b], span));
  const int live = min(n_splits, (len + split_rows - 1) / split_rows);
  const int64_t row = static_cast<int64_t>(b) * gridDim.x + hq;
  const float* m = pm + row * n_splits;
  const float* l = pl + row * n_splits;
  const float* a = pacc + row * n_splits * D + d;
  float M = kNegInf;
  for (int s = 0; s < live; ++s) M = fmaxf(M, m[s]);
  float L = 0.f, A = 0.f;
  for (int s = 0; s < live; ++s) {
    const float f = expf(m[s] - M);
    L += l[s] * f;
    A += a[static_cast<int64_t>(s) * D] * f;
  }
  out[row * D + d] = from_f32<T>(A / fmaxf(L, kMinDenom));
}

template <typename T, int D, class Addr>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   const int* lengths, const Addr& addr, float* pm, float* pl,
                   float* pacc, int B, int Hkv, int G, int n_splits, int span,
                   int split_rows, float scale, cudaStream_t s) {
  using Gm = Geo<T, D>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        split_kernel<T, D, Addr>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Gm::SMEM);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  split_kernel<T, D, Addr><<<dim3(Hkv, B, n_splits), kThreads, Gm::SMEM, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, addr, pm, pl, pacc, Hkv, G, n_splits,
      scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || out == nullptr) return e;  // the split pass alone
  combine_kernel<T, D><<<dim3(Hkv * G, B), D, 0, s>>>(
      pm, pl, pacc, lengths, static_cast<T*>(out), span, split_rows,
      n_splits);
  return cudaGetLastError();
}

template <typename T, class Addr>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     void* out, const int* lengths, const Addr& addr,
                     float* pm, float* pl, float* pacc, int B, int Hkv, int G,
                     int n_splits, int span, int split_rows, float scale,
                     cudaStream_t s) {
  if (G < 1 || G > kMaxG || B <= 0 || Hkv <= 0 || B > 65535 ||
      n_splits <= 0 || n_splits > 65535 || Hkv * G > 65535)
    return cudaErrorInvalidValue;
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, out, lengths, addr, pm, pl, pacc, B, Hkv, G, n_splits, span, split_rows, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, lengths, addr, pm, pl, pacc, B, Hkv, G, n_splits, span, split_rows, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, lengths, addr, pm, pl, pacc, B, Hkv, G, n_splits, span, split_rows, scale, s);
    case 256: return launch<T, 256>(q, k, v, out, lengths, addr, pm, pl, pacc, B, Hkv, G, n_splits, span, split_rows, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// B3.  q/out [B, Hq, D] contiguous; k/v [B, W, Hkv, D] with element strides
// (sb, sw, sh) and unit last-dim stride (base 16-byte aligned, strides
// multiples of 16 bytes); lengths [B] int32 on the device; f32 partials
// part_m/part_l [B, Hq, n_splits] and part_acc [B, Hq, n_splits, D],
// n_splits = ceil(W / 128).  Two kernels: the split pass, then the combine
// pass; with a null out the split pass alone, its partials the result (a
// sequence-parallel cache combines them across the ranks that hold its
// rows).
REPRO_EXPORT int repro_decode_attention(
    const void* q, const void* k, const void* v, void* out,
    const void* lengths, void* part_m, void* part_l, void* part_acc, int B,
    int W, int n_splits, int Hkv, int G, int D, long long sb, long long sw,
    long long sh, float scale, int dtype, void* stream) {
  using repro::kSplitKeys;
  if (W <= 0 || n_splits != (W + kSplitKeys - 1) / kSplitKeys)
    return static_cast<int>(cudaErrorInvalidValue);
  repro::ContigAddr addr{sb, sw, sh, W};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  if (dtype == repro::kFloat32)
    return repro::dispatch<float>(D, q, k, v, out, len, addr, pm, pl, pa, B, Hkv, G, n_splits, W, kSplitKeys, scale, s);
  if (dtype == repro::kBFloat16)
    return repro::dispatch<__nv_bfloat16>(D, q, k, v, out, len, addr, pm, pl, pa, B, Hkv, G, n_splits, W, kSplitKeys, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// B4.  q/out [B, Hq, D] contiguous; k/v pools [P, ps, Hkv, D] with element
// strides (sp, sr, sh) and unit last-dim stride (K and V pools share them;
// base 16-byte aligned, strides multiples of 16 bytes); block_tables [B, n]
// and lengths [B] int32 on the device; f32 partials part_m/part_l
// [B, Hq, n_splits] and part_acc [B, Hq, n_splits, D], n_splits =
// ceil(n / pps).  Two kernels: the split pass, then the combine pass.
REPRO_EXPORT int repro_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages, void* out,
    const void* block_tables, const void* lengths, void* part_m,
    void* part_l, void* part_acc, int B, int P, int ps, int n, int pps,
    int n_splits, int Hkv, int G, int D, long long sp, long long sr,
    long long sh, float scale, int dtype, void* stream) {
  if (ps <= 0 || n <= 0 || P <= 0 || pps <= 0 ||
      pps > repro::kMaxTable || n_splits != (n + pps - 1) / pps)
    return static_cast<int>(cudaErrorInvalidValue);
  repro::PagedAddr addr{static_cast<const int*>(block_tables), sp, sr,
                               sh, P, ps, n, pps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  if (dtype == repro::kFloat32)
    return repro::dispatch<float>(D, q, k_pages, v_pages, out, len, addr, pm, pl, pa, B, Hkv, G, n_splits, n * ps, pps * ps, scale, s);
  if (dtype == repro::kBFloat16)
    return repro::dispatch<__nv_bfloat16>(D, q, k_pages, v_pages, out, len, addr, pm, pl, pa, B, Hkv, G, n_splits, n * ps, pps * ps, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
