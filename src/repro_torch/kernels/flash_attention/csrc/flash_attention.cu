// B2 — GQA flash attention for prefill, Hopper: causal, bidirectional or
// prefix masks, each with an optional sliding window.
//
// Replaces: src/repro/kernels/flash_attention/flash_kernel.py:80 ·
// flash_attention_pallas, generalised in three ways:
//   * per-sequence query offset q_offset[b] and KV length kv_len[b], so one
//     kernel serves whole-prompt prefill (offset 0, kv_len = S) and a paged
//     prefill chunk over the gathered KV view (offset pos[b], kv_len
//     pos[b] + S): query s of sequence b sits at absolute position
//     q_offset[b] + s;
//   * the mask modes of the JAX package's make_mask (models/layers.py:97),
//     where the TPU kernel has the causal one alone.  They differ only in
//     `prefix`, the number of leading keys every query sees: 0 is causal,
//     the image prefix's length is the vlm's prefix mask, and T (all keys)
//     the encoder's bidirectional mask.  Query position qpos sees key kj
//     when kj < kv_len, kj <= max(qpos, prefix - 1) — make_mask's
//     (kj <= qpos) | (kj < prefix_len) — and, with a window, kj > qpos -
//     window, ANDed on top in every mode as make_mask does.  The per-row
//     bound max(qpos, prefix - 1) is computed once before the KV loop, so
//     the causal element test costs what it did; the KV tiles a query tile
//     walks end at min(kv_len, max(its last qpos + 1, prefix)), so a
//     prefix query loads the prefix tiles past its own position;
//   * a ragged last tile is masked, in place of the TPU kernel's
//     S % block == 0 assertion: serving prompts have any length.
//
// Bound on the H100: operations once S reaches a few hundred.  Causal
// prefill attention does ~S/2 * 4 * D FLOPs per query head per query for
// ~(S * Hkv * D * 2 * 2) bytes of K/V; at llama32-3b's shape (Hq 24, Hkv 8,
// D 128) the two bounds cross near S = 800 (0.0016 ms of bytes vs 0.0007
// ms of bf16 tensor-core work at S = 333; 0.0065 ms of work at S = 1024).
// Two kernels, picked by dtype:
//
// bf16 (the main path): tensor cores, one warpgroup per CTA.
//   * one CTA of 128 threads per (64-query tile, query head, batch row):
//     144 CTAs at q[1,333,24,128] on 132 SMs, two resident per SM (81 KB
//     of shared memory each); the KV head is q_head / G, so the G query
//     heads of a KV head reread the same K/V tiles through L2 (1.4 MB at
//     that shape).  The grid's y index runs over query tiles in reverse,
//     so the heaviest causal tiles (the last ones) launch first.  At D 256
//     (paligemma-3b) the five tiles take 161 KB, one CTA per SM, and a
//     thread holds 128 f32 output accumulators beside its 32 scores;
//   * S = Q·Kᵀ and O += P·V are wgmma.m64n64k16 (bf16 operands, f32
//     accumulators in registers): Q and K from shared memory (K-major), P
//     from registers as the A operand of P·V, V from shared memory
//     (MN-major, transposed by the instruction), one m64n64 product per 64
//     output columns;
//   * Q, K and V tiles are [64 rows x 128 B] blocks in the 128-byte swizzle
//     wgmma reads without bank conflicts (16-byte chunk c of row r at chunk
//     c ^ (r % 8)), one block per 64 columns (D 32, 64, 80, 128, 256: 1,
//     1, 2, 2, 4 blocks); where D is not a multiple of 64 the last block's
//     unloaded columns are zeroed once, in Q and in every ring stage, so
//     no stale bits reach an operand (Q·Kᵀ's k-steps stop at D, and P·V's
//     dead output columns are never stored);
//   * K/V tiles of 64 rows come in by cp.async (16 bytes a thread,
//     zero-filled past kv_len) into a ring of two stages: tile j+1 is in
//     flight while tile j is multiplied;
//   * f32 online softmax on the accumulator fragments: a thread holds 16
//     scores of each of two rows, reduced over its quad by two shuffles;
//   * KV tiles wholly past the tile's last visible key (its causal
//     frontier, or the prefix's end) or before the window are never
//     loaded, as flash_kernel.py skips them with pl.when.
// Numerics: f32 scores, max and denominator; masked scores at
// finfo(f32).min; the softmax is taken in base 2 on scores pre-scaled by
// log2(e) (the same function, rounded differently in the last f32 bits);
// P is rounded to bf16 for the P·V product, as every tensor-core flash
// kernel does — the TPU kernel and the plain version keep P in f32, a
// 2^-9 relative difference per probability, far inside the bf16 tolerance
// (tests/test_torch_attention_split.py models it on the CPU); the
// denominator is clamped at 1e-30, the output cast to bf16.
//
// f32 (the reduced-config checks): the CUDA-core kernel of the first port,
// unchanged — tensor cores would compute in TF32 (~10 bits) and miss the f32
// tolerance:
//   * one CTA of 256 threads per (64-query tile, query head, batch row),
//     140 KB of shared memory at D 256;
//   * K/V tiles of 32 rows staged in shared memory as f32 (row stride D + 1
//     floats so that the score loop reads distinct banks);
//   * four threads own one query row: each holds 8 of the tile's 32 scores
//     and 1/4 of the row's D output columns, with the online-softmax max
//     and denominator in f32 registers (reduced over the four lanes by
//     shuffles).
// Numerics: f32 accumulation, masked scores at finfo(f32).min, p kept in
// f32 for the PV product, denominator clamped at 1e-30.
#include "common.cuh"

namespace repro {
namespace {

// ---------------------------------------------------------------------------
// f32: CUDA-core kernel
// ---------------------------------------------------------------------------

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
                     int Hkv, int window, int prefix, float scale) {
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
  // this row's keys: up to k_last (its own position, or the prefix's last
  // key), from k_first (the window's first) on; none past S
  const int k_last = row_ok ? max(qpos, prefix - 1) : -1;
  const int k_first = window > 0 ? qpos - window + 1 : 0;
  // KV tiles any query of this tile can see
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_hi = min(kvl, max(qoff + q_last + 1, prefix));
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
      ok[j] = kj < kvl && kj <= k_last && kj >= k_first;
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

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel (wgmma + cp.async)
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kBQ = 64;                  // queries per CTA (one wgmma M)
constexpr int kBK = 64;                  // keys per K/V tile (one wgmma N)
constexpr int kThreads = 128;            // one warpgroup
constexpr int kBlockBytes = 64 * 128;    // 64 rows x 128 B: 64 columns

template <int D>
__host__ __device__ constexpr int col_blocks() { return (D + 63) / 64; }
template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return col_blocks<D>() * kBlockBytes;
}
// Q, two stages of K and V, and slack to align the base to 1024 B
template <int D>
constexpr size_t smem_bytes() { return 5 * tile_bytes<D>() + 1024; }

// byte offset of 16-byte chunk c (8 bf16 columns) of row r in a swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 3) * kBlockBytes + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// wgmma shared-memory descriptor: start, leading and stride byte offsets,
// 128-byte swizzle.  K-major tiles (Q, K): 8-row groups 1024 B apart, the
// leading offset unused.  MN-major tile (V): 8-key groups 1024 B apart;
// with N = 64 one swizzle atom spans the N extent, so the leading offset
// (the next 64 columns) is never used either — both are set to 1024.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads/writes across the
// asynchronous wgmma boundary
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// generic-proxy writes to shared memory become visible to wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

#define REPRO_ACC32(d)                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define REPRO_D32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (+)= A·B, A [64 x 16] and B [16 x 64] both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : REPRO_ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A·B, A [64 x 16] in registers (bf16 pairs), B [16 x 64] MN-major in
// shared memory (transposed by the instruction)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " REPRO_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : REPRO_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// cp.async one [64 x D] tile: rows row0.. of g (row stride rs elements);
// rows at or past `valid` are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* g,
                                          int64_t rs, int row0, int valid,
                                          int tid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  static_assert(64 * CPR % kThreads == 0, "a tile is whole 16-byte chunks");
#pragma unroll
  for (int j = 0; j < 64 * CPR / kThreads; ++j) {
    const int i = tid + j * kThreads;
    const int r = i / CPR, c = i % CPR;
    const bool ok = row0 + r < valid;
    const bf16* src = g + (ok ? (row0 + r) * rs + c * 8 : 0);
    cp_async16(dst + swz(r, c), src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_prefill_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 const int* __restrict__ q_offset,
                 const int* __restrict__ kv_len, int S, int T_kv, int Hq,
                 int Hkv, int window, int prefix, float scale_log2) {
  static_assert(D % 16 == 0, "Q·Kᵀ runs D / 16 k-steps");
  constexpr int NB = col_blocks<D>();  // 64-column blocks of O
  constexpr int TB = tile_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;
  const uint32_t sK = sQ + TB;        // stage s at sK + s * TB
  const uint32_t sV = sQ + 3 * TB;    // stage s at sV + s * TB

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / Hq, hq = blockIdx.x % Hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int hk = hq / (Hq / Hkv);
  const int qoff = q_offset[b];
  const int kvl = min(kv_len[b], T_kv);
  const int64_t q_rs = static_cast<int64_t>(Hq) * D;
  const int64_t kv_rs = static_cast<int64_t>(Hkv) * D;
  const bf16* qb = q + static_cast<int64_t>(b) * S * q_rs + static_cast<int64_t>(hq) * D;
  const bf16* kb = k + static_cast<int64_t>(b) * T_kv * kv_rs + static_cast<int64_t>(hk) * D;
  const bf16* vb = v + static_cast<int64_t>(b) * T_kv * kv_rs + static_cast<int64_t>(hk) * D;

  if constexpr (D % 64 != 0) {
    // the unloaded columns of every tile's last block read as zeros
    uint4* s4 = reinterpret_cast<uint4*>(smem_raw + (sQ - raw));
    for (int i = tid; i < 5 * TB / 16; i += kThreads) s4[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }

  // KV tiles any query of this tile can see
  const int q_last = min(q0 + kBQ, S) - 1;
  const int k_hi = min(kvl, max(qoff + q_last + 1, prefix));
  int k_lo = window > 0 ? max(0, qoff + q0 - window + 1) : 0;
  k_lo = (k_lo / kBK) * kBK;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;

  load_tile<D>(sQ, qb, q_rs, q0, S, tid);
  if (n_tiles > 0) {
    load_tile<D>(sK, kb, kv_rs, k_lo, kvl, tid);
    load_tile<D>(sV, vb, kv_rs, k_lo, kvl, tid);
  }
  cp_async_commit();

  // this thread's rows of the tile: r0 and r0 + 8; its columns in each
  // 8-column block of a fragment: t2 and t2 + 1
  const int r0 = 16 * warp + (lane >> 2);
  const int t2 = 2 * (lane & 3);
  float o[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[nb][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // each of the thread's two rows sees keys k_first[h] .. k_last[h]: up
  // to its own position or the prefix's last key, from the window's first
  // key on (none for a row past S)
  int k_first[2], k_last[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + r0 + 8 * h;
    const int qpos = qoff + qi;
    k_last[h] = qi < S ? max(qpos, prefix - 1) : -1;
    k_first[h] = window > 0 ? qpos - window + 1 : 0;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    const int k0 = k_lo + it * kBK;
    if (it + 1 < n_tiles) {
      load_tile<D>(sK + (st ^ 1) * TB, kb, kv_rs, k0 + kBK, kvl, tid);
      load_tile<D>(sV + (st ^ 1) * TB, vb, kv_rs, k0 + kBK, kvl, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile `it` (and Q) have landed
    fence_proxy_async();
    __syncthreads();

    // S = Q·Kᵀ over D / 16 k-steps; a k-step is 32 B further along a row
    // inside a 128 B block, then the next block
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    const uint32_t kst = sK + st * TB;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kBlockBytes + (kk & 3) * 32;
      wgmma_ss(s, desc(sQ + off, 16), desc(kst + off, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // mask, then the online softmax in base 2.  Fragment element i: row
    // r0 + 8 * ((i >> 1) & 1), column 8 * (i >> 2) + t2 + (i & 1)
    uint32_t okm = 0;
    float bmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const int kj = k0 + 8 * (i >> 2) + t2 + (i & 1);
      const bool ok = kj < kvl && kj <= k_last[h] && kj >= k_first[h];
      okm |= static_cast<uint32_t>(ok) << i;
      s[i] = ok ? s[i] * scale_log2 : kNegInf;
      bmax[h] = fmaxf(bmax[h], s[i]);
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bmax[h] = fmaxf(bmax[h], __shfl_xor_sync(0xffffffffu, bmax[h], 1));
      bmax[h] = fmaxf(bmax[h], __shfl_xor_sync(0xffffffffu, bmax[h], 2));
      const float m_new = fmaxf(m[h], bmax[h]);
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const float p = (okm >> i) & 1u ? exp2f(s[i] - m[h]) : 0.f;
      s[i] = p;
      l[h] += p;
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[nb][i] *= alpha[(i >> 1) & 1];

    // P as bf16 A fragments: k-step kk covers keys 16kk .. 16kk + 15, the
    // accumulator's 8-key blocks 2kk and 2kk + 1
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        a[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);

    // O += P·V: k-step kk starts 16 rows (2048 B) further into the V tile
    const uint32_t vst = sV + st * TB;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(o[nb]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        wgmma_rs(o[nb], a[kk], desc(vst + nb * kBlockBytes + kk * 2048, 1024));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(o[nb]);
    __syncthreads();  // stage `st` is refilled next iteration
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.f / fmaxf(l[h], kMinDenom);
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i >> 1) & 1;
      const int qi = q0 + r0 + 8 * h;
      const int col = nb * 64 + 8 * (i >> 2) + t2;
      if (qi < S && col < D) {
        bf16* dst = out + (static_cast<int64_t>(b) * S + qi) * q_rs +
                    static_cast<int64_t>(hq) * D + col;
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(o[nb][i] * inv[h], o[nb][i + 1] * inv[h]);
      }
    }
}

#undef REPRO_ACC32
#undef REPRO_D32

}  // namespace tc

// f32: the CUDA-core kernel
template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       const int* q_offset, const int* kv_len, int B, int S,
                       int T_kv, int Hq, int Hkv, int window, int prefix,
                       float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_kernel<float, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_prefill_kernel<float, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), q_offset,
      kv_len, S, T_kv, Hq, Hkv, window, prefix, scale);
  return cudaGetLastError();
}

// bf16: the tensor-core kernel; grid (B * Hq, query tiles)
template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, const int* q_offset, const int* kv_len,
                        int B, int S, int T_kv, int Hq, int Hkv, int window,
                        int prefix, float scale, cudaStream_t stream) {
  constexpr size_t smem = tc::smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        tc::flash_prefill_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int n_qt = (S + tc::kBQ - 1) / tc::kBQ;
  if (n_qt > 65535) return cudaErrorInvalidValue;
  dim3 grid(B * Hq, n_qt);
  tc::flash_prefill_tc<D><<<grid, tc::kThreads, smem, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<tc::bf16*>(out), q_offset,
      kv_len, S, T_kv, Hq, Hkv, window, prefix, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     void* out, const int* qo, const int* kl, int B, int S,
                     int T_kv, int Hq, int Hkv, int window, int prefix,
                     float scale, cudaStream_t s) {
#define REPRO_LAUNCH(DD)                                                      \
  if constexpr (BF16)                                                         \
    return launch_bf16<DD>(q, k, v, out, qo, kl, B, S, T_kv, Hq, Hkv, window, \
                           prefix, scale, s);                                 \
  else                                                                        \
    return launch_f32<DD>(q, k, v, out, qo, kl, B, S, T_kv, Hq, Hkv, window,  \
                          prefix, scale, s)
  switch (D) {
    case 32: REPRO_LAUNCH(32);
    case 64: REPRO_LAUNCH(64);
    case 80: REPRO_LAUNCH(80);
    case 128: REPRO_LAUNCH(128);
    case 256: REPRO_LAUNCH(256);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_LAUNCH
}

}  // namespace
}  // namespace repro

// q [B,S,Hq,D], k/v [B,T,Hkv,D], out [B,S,Hq,D], all contiguous (bf16:
// 16-byte aligned); q_offset/kv_len [B] int32 on the device; window <= 0
// means none; keys [0, prefix) are visible to every query (0: causal, the
// prefix's length: the prefix mask, T: bidirectional).
REPRO_EXPORT int repro_flash_prefill(const void* q, const void* k,
                                     const void* v, void* out,
                                     const void* q_offset, const void* kv_len,
                                     int B, int S, int T_kv, int Hq, int Hkv,
                                     int D, int window, int prefix,
                                     float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || T_kv <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      Hq > 65535 || B > 65535 || prefix < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qo = static_cast<const int*>(q_offset);
  const int* kl = static_cast<const int*>(kv_len);
  if (dtype == repro::kFloat32)
    return repro::dispatch<false>(D, q, k, v, out, qo, kl, B, S, T_kv, Hq, Hkv, window, prefix, scale, s);
  if (dtype == repro::kBFloat16)
    return repro::dispatch<true>(D, q, k, v, out, qo, kl, B, S, T_kv, Hq, Hkv, window, prefix, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
