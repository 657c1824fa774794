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
// Taken step by step, though, the recurrence is a serial chain over time.
// Two kernels, picked by the wrapper (ops.wkv6_cuda) by S and B·H:
//
// Prefill: wkv6_chunk_kernel, the chunked form (ref.wkv6_chunk_ref is its
// plain model).  Time is cut into chunks of C = 16 tokens (the last one
// ragged, any S >= 1; C = 32 measured slower at every shape it was timed
// at: twice the pairwise work a chunk, and one CTA an SM).  Within a chunk of n tokens, with every decay a
// product of w (never a quotient, so nothing overflows, and a w of exactly
// 0 — the model's bf16 exp(-exp(dw)) can round to it — gives exact zeros):
//   y_t  = (r_t ⊙ Π_{s<t} w_s) · S                     inter-chunk
//        + Σ_{τ<=t} A[t,τ] v_τ                           intra-chunk, bonus
//   A[t,τ] = Σ_i r_{t,i} k_{τ,i} Π_{τ<s<t} w_{s,i} (τ < t),
//   A[t,t] = Σ_i r_{t,i} u_i k_{t,i}
//   S <- diag(Π_{s<n} w_s) S + Σ_τ (k_τ ⊙ Π_{s>τ} w_s) v_τᵀ
//   * Column tiles for occupancy: S[:, j] and y[:, j] need only v[:, j],
//     so the grid is (B·H, hs/16) and a CTA owns a [hs x 16] f32 slice of
//     the state in registers for the whole sequence: 256 CTAs at B = 1,
//     H = 64 on the 132 SMs, two an SM (one block of 64 threads per head,
//     64 CTAs, in the per-step design).  A does not depend on j, so each
//     column tile computes it again (C²·hs/2 a chunk).
//   * Warp-specialised, 256 threads: the state group (threads 0-127, hs/8
//     state values each) takes chunk c — y's inter-chunk partial over its
//     rows, the state update (C FMAs a value, no reduction), then y = the
//     8 row blocks' partials + A·V — while the chunk group (128-255)
//     prepares chunk c+1, which does not depend on the state: the prefix
//     products (r_t ⊙ Π_{s<t} w_s, Π_{s<n} w_s) and suffix products
//     (k_τ ⊙ Π_{s>τ} w_s) of one channel a thread, and A, each thread
//     summing hs/16 channels of rows t and C-1-t (t + C-1-t = C-1 terms:
//     balanced) with the pairwise decay a running product from τ = t-1
//     down, the partials then summed through shared memory.  One
//     __syncthreads a chunk hands the buffers (two, by chunk parity) over;
//     the serial chain is ceil(S/C) state hand-offs, not S dependent steps.
//   * r, k, w (whole rows) and v (the tile's 16 columns) come in by
//     cp.async, 16 bytes a lane, issued by the chunk group three chunks
//     ahead into a four-stage shared-memory ring; rows past S are
//     zero-filled and the products stop at n.
//   * What bounds it: latency, not a rate.  Each chunk is a chain of
//     shared-memory loads, short FMA chains and barriers run by 8 warps an
//     SM; the chunk group is the longer path (timed with either group's
//     work cut out).
//   * f32 throughout on the CUDA cores; the state never leaves f32.
//
// Decode: wkv6_step_kernel, S = 1 (and any S the wrapper gives it): one
// block per (b, h) with hs threads; thread j keeps column j of the state
// (hs f32) in registers; r, k, v and w of kStepChunk timesteps are staged
// in shared memory between two barriers and stepped through with r_t[i],
// k_t[i], w_t[i] read as broadcasts.
//
// Both: the final state may be written over the initial one — each CTA
// reads its own columns of its (b, h) slice before it writes them, and
// the slices are disjoint — so a decode step updates its cache in place.
// y is cast to the input type at the store.  nvcc contracts the updates to
// FMAs, and the sums run in another order than the plain version's.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kStepChunk = 32;  // timesteps staged per pair of barriers

struct Args {
  const void *r, *k, *v, *w, *u, *s0;
  void *y, *s_out;
  int B, S, H;
  cudaStream_t stream;
};

// ---------------------------------------------------------------------------
// decode: one step after another
// ---------------------------------------------------------------------------
template <typename T, int HS>
__global__ void __launch_bounds__(HS)
wkv6_step_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ w,
                 const float* __restrict__ u, const float* s0,
                 T* __restrict__ y, float* s_out, int S, int H) {
  __shared__ float rs[kStepChunk][HS], ks[kStepChunk][HS], vs[kStepChunk][HS],
      ws[kStepChunk][HS], us[HS];
  const int bh = blockIdx.x, b = bh / H, h = bh % H, j = threadIdx.x;
  const int64_t slice = static_cast<int64_t>(bh) * HS * HS;
  float st[HS];  // st[i] = S[i, j]
#pragma unroll
  for (int i = 0; i < HS; ++i) st[i] = s0[slice + i * HS + j];
  us[j] = u[h * HS + j];
  const int64_t step = static_cast<int64_t>(H) * HS;  // one timestep
  const int64_t base = static_cast<int64_t>(b) * S * step + h * HS + j;
  for (int t0 = 0; t0 < S; t0 += kStepChunk) {
    const int n = min(kStepChunk, S - t0);
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
cudaError_t launch_step(const Args& a) {
  wkv6_step_kernel<T, HS><<<a.B * a.H, HS, 0, a.stream>>>(
      static_cast<const T*>(a.r), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.w),
      static_cast<const float*>(a.u), static_cast<const float*>(a.s0),
      static_cast<T*>(a.y), static_cast<float*>(a.s_out), a.S, a.H);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// prefill: the chunked form, one [hs x 16] column tile of the state a CTA
// ---------------------------------------------------------------------------
constexpr int kCols = 16;                  // state columns a CTA owns

// n floats (n a multiple of 4, 2 or 1) from shared memory, aligned to n
template <int N>
__device__ __forceinline__ void lds(const float* p, float (&o)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(p)[q];
      o[4 * q] = x.x; o[4 * q + 1] = x.y; o[4 * q + 2] = x.z;
      o[4 * q + 3] = x.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const float2 x = reinterpret_cast<const float2*>(p)[q];
      o[2 * q] = x.x; o[2 * q + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) o[q] = p[q];
  }
}
template <int N>
__device__ __forceinline__ void lds(const __nv_bfloat16* p, float (&o)[N]) {
  if constexpr (N % 4 == 0) {  // 8 bytes a load
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const uint2 x = reinterpret_cast<const uint2*>(p)[q];
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&x.x));
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&x.y));
      o[4 * q] = a.x; o[4 * q + 1] = a.y; o[4 * q + 2] = b.x;
      o[4 * q + 3] = b.y;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const float2 x =
          __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(p)[q]);
      o[2 * q] = x.x; o[2 * q + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) o[q] = __bfloat162float(p[q]);
  }
}

constexpr int kGroup = 128;                // threads of each warp group
constexpr int kThreads = 2 * kGroup;

// a named barrier among the kGroup threads of one warp group (id 1 or 2;
// __syncthreads is barrier 0)
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kGroup) : "memory");
}

template <typename T, int HS, int C>
struct ChunkGeo {
  static constexpr int NP = C / 2;               // row pairs (t, C-1-t)
  static constexpr int NG = kGroup / NP;         // channel groups of A
  static constexpr int APS = NG + 4;             // A partials' row (padded)
  static constexpr int CPG = HS / NG;            // channels a group sums
  static constexpr int NIB = kGroup / kCols;     // row blocks of the state
  static constexpr int IPB = HS / NIB;           // state rows a thread holds
  static constexpr int SEG_ROW = HS * static_cast<int>(sizeof(T)) / 16;
  static constexpr int SEG_V = kCols * static_cast<int>(sizeof(T)) / 16;
  static constexpr int SEGS = 3 * C * SEG_ROW + C * SEG_V;  // per chunk
  static constexpr int NSTAGE = 4;               // the ring's stages
  // shared memory, in bytes: NSTAGE ring stages of r, k, w [C][HS] and v
  // [C][kCols] in T; then in f32, two buffers (chunk parity) each of rd,
  // kd [C][HS], dec [HS] and A [C][C]; the A partials [C][C][APS]; the y
  // partials [NIB][C][kCols]
  static constexpr int STAGE = (3 * C * HS + C * kCols) * sizeof(T);
  static constexpr int BUF = (2 * C * HS + HS + C * C) * 4;
  static constexpr int BUFS = NSTAGE * STAGE;
  static constexpr int AP = BUFS + 2 * BUF;
  static constexpr int YP = AP + C * C * APS * 4;
  static constexpr int SMEM = YP + NIB * C * kCols * 4;
  static_assert(NG * NP == kGroup && CPG * NG == HS && NG % 4 == 0, "A");
  static_assert(C % NIB == 0 && C % 4 == 0, "y");
  static_assert(2 * HS <= kGroup && IPB * NIB == HS, "tiles");
  static_assert(STAGE % 16 == 0 && BUF % 16 == 0 && SEG_V >= 1, "16 bytes");
};

// Warp-specialised: threads [0, 128) (the state group) carry the state
// through chunk c — y's inter-chunk part and the state update, then y —
// while threads [128, 256) (the chunk group) fetch chunk c+3 and form
// chunk c+1's decays and A, which do not depend on the state.  One
// __syncthreads per chunk hands chunk c+1's buffers over.
template <typename T, int HS, int C>
__global__ void __launch_bounds__(kThreads, 2)  // two CTAs an SM
wkv6_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ w,
                  const float* __restrict__ u, const float* s0,
                  T* __restrict__ y, float* s_out, int S, int H) {
  using G = ChunkGeo<T, HS, C>;
  constexpr int CPG = G::CPG, IPB = G::IPB, NG = G::NG, APS = G::APS;
  extern __shared__ __align__(16) uint8_t smem[];
  float* ap = reinterpret_cast<float*>(smem + G::AP);
  float* yp = reinterpret_cast<float*>(smem + G::YP);
  // chunk c's buffers (parity c % 2): r ⊙ Π_{s<t} w, k ⊙ Π_{s>t} w,
  // Π_{s<n} w and A
  auto rd_of = [&](int c) {
    return reinterpret_cast<float*>(smem + G::BUFS + (c % 2) * G::BUF);
  };
  auto stage_of = [&](int c) {
    return reinterpret_cast<const T*>(smem + (c % G::NSTAGE) * G::STAGE);
  };

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int j0 = blockIdx.y * kCols, tid = threadIdx.x;
  const int64_t row = static_cast<int64_t>(H) * HS;      // one timestep
  const int64_t base = static_cast<int64_t>(b) * S * row + h * HS;
  const int64_t slice = static_cast<int64_t>(bh) * HS * HS;
  const int n_chunks = (S + C - 1) / C;

  if (tid >= kGroup) {
    // ---------------------------------------------------------------- chunk
    const int ta = tid - kGroup;
    const uint32_t ring = smem_u32(smem);
    auto fetch = [&](int c) {  // chunk c's rows -> stage c % NSTAGE
      if (c < n_chunks) {
        const uint32_t dst = ring + (c % G::NSTAGE) * G::STAGE;
        const int t0 = c * C;
        for (int i = ta; i < G::SEGS; i += kGroup) {
          const int m = i / (C * G::SEG_ROW);  // 0 r, 1 k, 2 w, 3 v
          int t, e;
          const T* src;
          if (m < 3) {
            const int q = i - m * C * G::SEG_ROW;
            t = q / G::SEG_ROW;
            e = (q % G::SEG_ROW) * (16 / sizeof(T));
            src = m == 0 ? r : m == 1 ? k : w;
          } else {
            const int q = i - 3 * C * G::SEG_ROW;
            t = q / G::SEG_V;
            e = j0 + (q % G::SEG_V) * (16 / sizeof(T));
            src = v;
          }
          const bool ok = t0 + t < S;
          cp_async16(dst + i * 16,
                     src + (ok ? base + (t0 + t) * row + e : 0), ok);
        }
      }
      cp_async_commit();
    };
    // A's rows t1 and t2 = C-1-t1 (t1 + t2 = C-1 pairwise terms: balanced)
    // over channels [g * CPG, (g + 1) * CPG)
    const int g = ta % NG, i0 = g * CPG, t1 = ta / NG, t2 = C - 1 - t1;
    float uu[CPG];
#pragma unroll
    for (int q = 0; q < CPG; ++q) uu[q] = u[h * HS + i0 + q];

    // chunk c's decays and A into its buffers (its rows have landed)
    auto prepare = [&](int c) {
      const T* rs = stage_of(c);
      const T* ks = rs + C * HS;
      const T* ws = ks + C * HS;
      float* rd = rd_of(c);
      float* kd = rd + C * HS;
      float* dec = kd + C * HS;
      float* A = dec + HS;
      const int n = min(C, S - c * C);
      // (a) prefix and suffix products of one channel (every load first:
      // a store to shared memory would hold back the loads after it)
      if (ta < 2 * HS) {
        const int i = ta % HS;
        const T* xs = ta < HS ? rs : ks;
        float x[C], ww[C];
#pragma unroll
        for (int t = 0; t < C; ++t) {
          x[t] = to_f32(xs[t * HS + i]);
          ww[t] = t < n ? to_f32(ws[t * HS + i]) : 1.f;
        }
        float p = 1.f;
        if (ta < HS) {
#pragma unroll
          for (int t = 0; t < C; ++t) {
            rd[t * HS + i] = x[t] * p;
            p *= ww[t];
          }
          dec[i] = p;
        } else {
#pragma unroll
          for (int t = C - 1; t >= 0; --t) {
            kd[t * HS + i] = t < n ? x[t] * p : 0.f;
            p *= ww[t];
          }
        }
      }
      // (b) partial sums of A: the diagonals (the bonus), then C-1
      // pairwise terms, row t1's (τ = t1-1 .. 0) and then row t2's (τ =
      // t2-1 .. 0), the decay Π_{τ<s<t} w_s a running product; kept in
      // registers and stored after the loop, so its loads run ahead
      float rr[CPG], kk[CPG], D[CPG], bonus[2], part[C - 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = half ? t2 : t1;
        lds<CPG>(rs + t * HS + i0, rr);
        lds<CPG>(ks + t * HS + i0, kk);
        bonus[half] = 0.f;
#pragma unroll
        for (int q = 0; q < CPG; ++q) bonus[half] += rr[q] * uu[q] * kk[q];
      }
      lds<CPG>(rs + t1 * HS + i0, rr);
#pragma unroll
      for (int q = 0; q < CPG; ++q) D[q] = 1.f;
#pragma unroll
      for (int it = 0; it < C - 1; ++it) {
        if (it == t1) {  // row t1 is done: row t2 from τ = t2-1 down
          lds<CPG>(rs + t2 * HS + i0, rr);
#pragma unroll
          for (int q = 0; q < CPG; ++q) D[q] = 1.f;
        }
        const bool first = it < t1;
        const int t = first ? t1 : t2, tau = first ? t1 - 1 - it : C - 2 - it;
        (void)t;
        float ww[CPG];
        lds<CPG>(ks + tau * HS + i0, kk);
        lds<CPG>(ws + tau * HS + i0, ww);
        float a = 0.f;
#pragma unroll
        for (int q = 0; q < CPG; ++q) {
          a += rr[q] * kk[q] * D[q];
          D[q] *= ww[q];
        }
        part[it] = a;
      }
      ap[(t1 * C + t1) * APS + g] = bonus[0];
      ap[(t2 * C + t2) * APS + g] = bonus[1];
#pragma unroll
      for (int it = 0; it < C - 1; ++it) {
        const bool first = it < t1;
        const int t = first ? t1 : t2, tau = first ? t1 - 1 - it : C - 2 - it;
        ap[(t * C + tau) * APS + g] = part[it];
      }
      group_sync(1);
      // (c) A from its partials (zero above the diagonal)
      for (int e = ta; e < C * C; e += kGroup) {
        const int t = e / C, tau = e % C;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        if (tau <= t) {
#pragma unroll
          for (int q = 0; q < NG; q += 4) {
            float x[4];
            lds<4>(ap + e * APS + q, x);
#pragma unroll
            for (int z = 0; z < 4; ++z) a[z] += x[z];
          }
        }
        A[e] = (a[0] + a[1]) + (a[2] + a[3]);
      }
    };

    fetch(0);
    fetch(1);
    fetch(2);
    cp_async_wait<2>();  // chunk 0 has landed
    group_sync(1);
    prepare(0);
    cp_async_wait<1>();  // chunk 1 has landed
    __syncthreads();
    for (int c = 0; c < n_chunks; ++c) {
      fetch(c + 3);      // into chunk c-1's stage, consumed
      if (c + 1 < n_chunks) prepare(c + 1);
      cp_async_wait<1>();  // chunk c+2 has landed
      __syncthreads();
    }
    cp_async_wait<0>();
    return;
  }

  // ------------------------------------------------------------------ state
  // this thread's state values: rows [ib * IPB, (ib + 1) * IPB) of column j
  const int sj = tid % kCols, ib = tid / kCols, si0 = ib * IPB;
  float st[IPB];
#pragma unroll
  for (int c = 0; c < IPB; ++c) st[c] = s0[slice + (si0 + c) * HS + j0 + sj];
  __syncthreads();  // chunk 0's buffers are ready
  for (int c = 0; c < n_chunks; ++c) {
    const T* vs = stage_of(c) + 3 * C * HS;   // [C][kCols]
    const float* rd = rd_of(c);
    const float* kd = rd + C * HS;
    const float* dec = kd + C * HS;
    const float* A = dec + HS;
    const int n = min(C, S - c * C);
    // y's inter-chunk partial over this thread's state rows, then the
    // state update of those rows
#pragma unroll
    for (int t = 0; t < C; ++t) {
      float x[IPB];
      lds<IPB>(rd + t * HS + si0, x);
      float a = 0.f;
#pragma unroll
      for (int q = 0; q < IPB; ++q) a += x[q] * st[q];
      yp[(ib * C + t) * kCols + sj] = a;
    }
    {
      float d[IPB];
      lds<IPB>(dec + si0, d);
#pragma unroll
      for (int q = 0; q < IPB; ++q) st[q] *= d[q];
    }
#pragma unroll
    for (int tau = 0; tau < C; ++tau) {
      float x[IPB];
      lds<IPB>(kd + tau * HS + si0, x);
      const float vj = to_f32(vs[tau * kCols + sj]);
#pragma unroll
      for (int q = 0; q < IPB; ++q) st[q] += x[q] * vj;
    }
    group_sync(2);
    // y = the row blocks' partials + A·V: this thread's column sj, rows
    // ib + NIB q (one v load serves every row)
    constexpr int NQ = C / G::NIB;
    float a0[NQ], a1[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int t = ib + G::NIB * q;
      a0[q] = a1[q] = 0.f;
#pragma unroll
      for (int z = 0; z < G::NIB; ++z) a0[q] += yp[(z * C + t) * kCols + sj];
    }
#pragma unroll
    for (int tau = 0; tau < C; tau += 4) {
      float vj[4];
#pragma unroll
      for (int z = 0; z < 4; ++z) vj[z] = to_f32(vs[(tau + z) * kCols + sj]);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        float x[4];
        lds<4>(A + (ib + G::NIB * q) * C + tau, x);
#pragma unroll
        for (int z = 0; z < 4; ++z) a1[q] += x[z] * vj[z];
      }
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int t = ib + G::NIB * q;
      if (t < n) y[base + (c * C + t) * row + j0 + sj] = from_f32<T>(a0[q] + a1[q]);
    }
    __syncthreads();  // chunk c+1's buffers are ready; yp is free
  }
#pragma unroll
  for (int c = 0; c < IPB; ++c) s_out[slice + (si0 + c) * HS + j0 + sj] = st[c];
}

template <typename T, int HS, int C>
cudaError_t launch_chunk(const Args& a) {
  using G = ChunkGeo<T, HS, C>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        wkv6_chunk_kernel<T, HS, C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  wkv6_chunk_kernel<T, HS, C>
      <<<dim3(a.B * a.H, HS / kCols), kThreads, G::SMEM, a.stream>>>(
          static_cast<const T*>(a.r), static_cast<const T*>(a.k),
          static_cast<const T*>(a.v), static_cast<const T*>(a.w),
          static_cast<const float*>(a.u), static_cast<const float*>(a.s0),
          static_cast<T*>(a.y), static_cast<float*>(a.s_out), a.S, a.H);
  return cudaGetLastError();
}

// chunk 0: the per-step kernel; 16: the chunked one
template <typename T, int HS>
cudaError_t by_chunk(const Args& a, int chunk) {
  switch (chunk) {
    case 0: return launch_step<T, HS>(a);
    case 16: return launch_chunk<T, HS, 16>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_head_size(const Args& a, int hs, int chunk) {
  switch (hs) {
    case 16: return by_chunk<T, 16>(a, chunk);
    case 32: return by_chunk<T, 32>(a, chunk);
    case 64: return by_chunk<T, 64>(a, chunk);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// r, k, v, w, y [B, S, H, hs] contiguous (base on a 16-byte boundary for
// the chunked kernel); u [H, hs] f32; s0, s_out [B, H, hs, hs] f32 (may be
// one buffer); chunk 0 picks the per-step kernel, 16 the chunked one.
REPRO_EXPORT int repro_wkv6(const void* r, const void* k, const void* v,
                            const void* w, const void* u, const void* s0,
                            void* y, void* s_out, int B, int S, int H, int hs,
                            int chunk, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const repro::Args a{r, k, v, w, u, s0, y, s_out, B, S, H,
                      static_cast<cudaStream_t>(stream)};
  if (dtype == repro::kFloat32)
    return repro::by_head_size<float>(a, hs, chunk);
  if (dtype == repro::kBFloat16)
    return repro::by_head_size<__nv_bfloat16>(a, hs, chunk);
  return static_cast<int>(cudaErrorInvalidValue);
}
