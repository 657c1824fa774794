// B5–B9 — per-chunk collective quantization for Hopper: the dense passes
// of the quantized two-step all-reduce (core/parallel_exec.py ·
// quantized_psum).
//
// Replaces, in src/repro/kernels/quant_collective/quant_kernel.py:
//   B5 chunk_amax_kernel        <- chunk_amax_pallas
//   B6 chunk_quantize_kernel    <- chunk_quantize_pallas (int8, fp8), and on
//           the int4 wire B6 + B7 <- chunk_quantize_pallas, nibble_pack_pallas
//   B9 chunk_dequantize_kernel  <- chunk_dequantize_pallas (int8, fp8)
// and, on the int8/fp8 wire of a TP decode step, B9 fused with the residual
// add and the RMSNorm after it (B1, rownorm.cuh):
//   B9 + add + B1 dequantize_add_rmsnorm <- chunk_dequantize_pallas, the
//           add x + ... (src/repro/core/parallel_exec.py), rms_norm_pallas
// and, on the int4 wire, fused with the work beside them:
//   B8 + B7 nibble_reduce_requant_kernel     <- nibble_unpack_pallas, the
//           jnp sum / round / clip (src/repro/core/parallel_exec.py:176–180),
//           nibble_pack_pallas
//   B8 + B9 nibble_unpack_dequantize_kernel  <- nibble_unpack_pallas,
//                                               chunk_dequantize_pallas
//
// Bound on the H100: device-memory bytes.  Each pass reads its input once
// and writes its output once with a few operations per element, far below
// the card's ~295 operations per byte.  On the decode path a call sees one
// rank's rows, [4, 3072] bf16 (24 KB): the bound is nanoseconds and the
// launch sets the time.  So the design keeps every thread's work short and
// the launches few: no int8 intermediate and no int32 sum goes through
// device memory on the int4 wire, and nothing runs between the abs-max's
// all-reduce and the quantize, which computes the shared scale itself.
//   * B5: a group of lanes per chunk, each lane one 16-byte vector of x at a
//     time (16 lanes a 128-wide bf16 chunk, two chunks a warp; 32 lanes
//     for f32), log2(group) shuffle levels of a NaN-keeping max, no
//     barrier; a 2-D grid (chunk groups x rows) with int32 indices in the
//     row.  A scalar path (32 lanes a chunk, one element a lane) takes
//     views off 16 bytes and widths that are no multiple of the vector; a
//     ragged last chunk (h % chunk != 0) reads nothing past h.
//   * B6: one template, chunk_quantize_kernel, over the wire (int8, fp8,
//     and int4 = the int8 value's low nibble, two a byte) and over the
//     source of the scale: the scales themselves (a zero scale taken as 1,
//     as the JAX package's Pallas wrapper does, quant_kernel.py:83), or
//     the all-reduced abs-max with the host's f32 1/qmax, the scale then
//     amax > 0 ? amax * inv_qmax : 1 (ops.scales_from_amax bit for bit: a
//     NaN abs-max gives 1, the comparison being false).  From the abs-max,
//     the step holding the first element of each chunk may also write its
//     scale times ``mult`` (1 for int8/fp8, t for int4, whose dequantize
//     undoes the requantize by t) for the dequantizing pass: the torch ops
//     that made the scales between the all-reduce and B6 are gone.  A 2-D
//     grid (row steps x rows), a step two values of x per thread loaded as
//     one word (4 bytes of bf16, 8 of f32 -> 2 bytes, int4 1) when x is
//     aligned to it and h even, one element (int4: one pair) otherwise; a
//     step's scale is looked up once where the step lies in one chunk,
//     else every element takes its own chunk's.  Why two values and not
//     16 bytes: at the decode shape the work is a few thousand threads on
//     one warp per scheduler, so nothing hides a thread's chain of IEEE
//     divisions (each a branch to a slow path the compiler will not
//     interleave); 16-byte steps (8 divisions) were 0.3 us slower on an
//     H100 (PERF.md);
//   * B5 and B6 launch by programmatic dependent launch: each grid starts
//     as its predecessor's blocks exit and waits for its memory before the
//     first load, which the t back-to-back launches of each on the step
//     turn into overlapped launch latency;
//   * B9: a grid-stride loop, one element per thread per step; the scale of
//     element j of a row is scales[row, j / chunk];
//   * the int4 reduce and post-pass: the 2-D grid, one packed byte per
//     thread per step.
// Numerics are those of the plain versions (ref.py), bit for bit:
//   * B5 propagates NaN (torch.amax and jnp.max do; fmaxf would drop it);
//   * the shared scale is the f32 product __fmul_rn(amax, inv_qmax), never
//     contracted into an FMA, as torch computes amax * f32(1 / qmax);
//   * B6 divides x / scale as written (IEEE division: the library is built
//     without --use_fast_math), rounds half to even with rintf, then clips
//     to [-127, 127] for int8 (and for int4, whose nibble is then the low 4
//     bits, so an out-of-grid value packs as the unfused chain packs it);
//     for fp8 it clips to +-448 first and rounds once to e4m3 with
//     __nv_cvt_float_to_fp8(..., __NV_SATFINITE, E4M3);
//   * the requantize sums the t source nibbles exactly in int32, divides by
//     t in f32 (IEEE), rounds half to even with rintf (torch.round and
//     jnp.round do) and clips to [-7, 7]: at t = 2, r = 1 -> 0, 3 -> 2;
//   * a nibble n sign-extends as (n ^ 8) - 8;
//   * B9 multiplies in f32 and rounds once to the output type;
//     dequantize_add_rmsnorm rounds that product to x's type as B9 does
//     (__fmul_rn, so the add after it is not contracted into an FMA), adds
//     x and rounds again, as the chain's x + d does: s is bit for bit the
//     chain's, and n is B1's of s.  One launch in place of three, and
//     neither the dequantized tensor nor s is read back from memory.
#include <cuda_fp8.h>

#include <algorithm>

#include "common.cuh"
#include "rownorm.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;   // grid-stride cap: 16 blocks per SM
// the passes on a 2-D grid (B5, B6 and the int4 wire's): threads a block
constexpr int kRowThreads = 128;
// B6's wire mode for int4: the int8 value's low nibble, two a byte (the
// int8 and fp8 modes are their dtype codes, common.cuh)
constexpr int kNibble = 5;

// max that keeps a NaN from either side (a != a only for NaN: the library
// is built without fast math)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a >= b) ? a : b;
}

int grid_for(int64_t n) {
  return static_cast<int>(std::min<int64_t>((n + kThreads - 1) / kThreads,
                                            kMaxBlocks));
}

// A launch's shape, computed once on the host for the kernel and for the
// empty kernel that times its grid (repro_quant_grid).
struct Plan {
  dim3 grid;
  bool vector;     // B5: 16 bytes a lane; B6: kStep values a step
  int group;       // B5: lanes a chunk
  bool one_scale;  // B6: every step lies in one chunk
};

unsigned rows_y(int64_t rows) {
  return static_cast<unsigned>(std::min<int64_t>(rows, 65535));
}

// B5 and B6 launch by Hopper's programmatic dependent launch: a launch
// asks the stream to start the grid as soon as its predecessor's blocks
// have exited, and the kernel waits for the predecessor's memory
// (griddepcontrol.wait) before its first load, so the grid's launch
// overlaps the predecessor's tail.  On the step the t launches of B5 and
// those of B6 run back to back, after a matmul and the max all-reduce:
// that chain of one all-reduce at t = 4 took 0.0417-0.0426 ms without it
// and 0.0341-0.0355 ms with it on an H100 (PERF.md).  Kernels
// after B5 and B6 launch as usual and wait for them whole.
__device__ __forceinline__ void wait_for_predecessor() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// launch ``kernel`` at ``grid`` x kRowThreads on ``stream`` with the
// programmatic-serialization attribute
template <typename... Params, typename... Args>
void launch_row_pass(void (*kernel)(Params...), dim3 grid,
                     cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kRowThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

// the 2-D grid of the row passes: x over a row's steps, y over rows (a
// block loops over rows past 65535)
dim3 row_grid(int64_t rows, int steps) {
  return dim3(std::min((steps + kRowThreads - 1) / kRowThreads, kMaxBlocks),
              rows_y(rows));
}

// ---------------------------------------------------------------- B5
// kGroup lanes (a power of two) take a chunk: lane l reads the chunk's
// vectors l, l + kGroup, ... (elements, on the scalar path), then the
// group's max runs over log2(kGroup) xor-shuffles, which stay inside the
// group.  Every lane of the warp reaches the shuffles: a group past the
// row's last chunk loads nothing and stores nothing.
template <typename T, bool kVector, int kGroup>
__global__ void __launch_bounds__(kRowThreads)
chunk_amax_kernel(const T* __restrict__ x, float* __restrict__ out,
                  int64_t rows, int h, int chunk, int K) {
  constexpr int N = kVector ? Vec16<T>::N : 1;
  const int lane = threadIdx.x % kGroup;
  const int c = blockIdx.x * (kRowThreads / kGroup) + threadIdx.x / kGroup;
  const bool live = c < K;
  const int start = c * chunk;
  const int end = live ? min(start + chunk, h) : start;
  wait_for_predecessor();
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const T* xr = x + row * h;
    float m = 0.f;             // |x| >= 0: the zero padding of the plain version
    for (int i = start + lane * N; i < end; i += kGroup * N) {
      if constexpr (kVector) {
        float f[N];
        Vec16<T>::load(xr + i, f);
#pragma unroll
        for (int j = 0; j < N; ++j) m = nan_max(m, fabsf(f[j]));
      } else {
        m = nan_max(m, fabsf(to_f32(xr[i])));
      }
    }
#pragma unroll
    for (int o = kGroup / 2; o > 0; o >>= 1)
      m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (live && lane == 0) out[row * K + c] = m;
  }
}

// the vector path when x is 16-byte aligned and h and chunk are multiples
// of the vector width; the group is the chunk's vectors rounded up to a
// power of two, at most 32 (a lane then reads several)
template <typename T>
Plan amax_plan(const void* x, int64_t rows, int h, int chunk) {
  constexpr int N = Vec16<T>::N;
  Plan p{};
  p.vector = aligned16(x) && h % N == 0 && chunk % N == 0;
  p.group = 32;
  if (p.vector) {
    const int vecs = chunk / N;
    p.group = 1;
    while (p.group < vecs && p.group < 32) p.group *= 2;
  }
  const int K = (h + chunk - 1) / chunk;
  const int per_block = kRowThreads / p.group;
  p.grid = dim3((K + per_block - 1) / per_block, rows_y(rows));
  return p;
}

template <typename T, bool kVector, int kGroup>
void launch_amax_g(const Plan& p, const T* x, float* out, int64_t rows,
                   int h, int chunk, cudaStream_t stream) {
  const int K = (h + chunk - 1) / chunk;
  launch_row_pass(chunk_amax_kernel<T, kVector, kGroup>, p.grid, stream, x,
                  out, rows, h, chunk, K);
}

template <typename T>
cudaError_t launch_amax(const void* x, float* out, int64_t rows, int h,
                        int chunk, cudaStream_t stream) {
  const Plan p = amax_plan<T>(x, rows, h, chunk);
  const T* xp = static_cast<const T*>(x);
  if (!p.vector)
    launch_amax_g<T, false, 32>(p, xp, out, rows, h, chunk, stream);
  else if (p.group == 1)
    launch_amax_g<T, true, 1>(p, xp, out, rows, h, chunk, stream);
  else if (p.group == 2)
    launch_amax_g<T, true, 2>(p, xp, out, rows, h, chunk, stream);
  else if (p.group == 4)
    launch_amax_g<T, true, 4>(p, xp, out, rows, h, chunk, stream);
  else if (p.group == 8)
    launch_amax_g<T, true, 8>(p, xp, out, rows, h, chunk, stream);
  else if (p.group == 16)
    launch_amax_g<T, true, 16>(p, xp, out, rows, h, chunk, stream);
  else
    launch_amax_g<T, true, 32>(p, xp, out, rows, h, chunk, stream);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- B6
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);   // keeps a NaN, as jnp.clip does
}

// a chunk's scale from its source: the scale itself, or the shared scale
// from the all-reduced abs-max (scales_from_amax)
template <bool kFromAmax>
__device__ __forceinline__ float chunk_scale(float v, float inv_qmax) {
  if constexpr (kFromAmax)
    return v > 0.f ? __fmul_rn(v, inv_qmax) : 1.f;
  else
    return v;
}

// the wire bits of x / s (s != 0): an int8 byte, an e4m3 byte, or the low
// nibble of the int8 value
template <int kMode>
__device__ __forceinline__ uint32_t quantize_one(float x, float s) {
  const float v = x / s;
  if constexpr (kMode == kFloat8E4M3) {
    return __nv_cvt_float_to_fp8(clip(v, -448.f, 448.f), __NV_SATFINITE,
                                 __NV_E4M3);
  } else {
    const int q = static_cast<int>(clip(rintf(v), -127.f, 127.f));
    return static_cast<uint32_t>(q) & (kMode == kNibble ? 0xFu : 0xFFu);
  }
}

// B6's vector step: two values of x a thread, loaded as one word (4 bytes
// of bf16, 8 of f32); an int4 step is a pair on either path
constexpr int kStep = 2;

template <typename T>
__device__ __forceinline__ void load_pair(const T* p, float (&f)[kStep]) {
  alignas(kStep * sizeof(T)) T buf[kStep];
  if constexpr (sizeof(T) == 4)
    *reinterpret_cast<uint2*>(buf) = *reinterpret_cast<const uint2*>(p);
  else
    *reinterpret_cast<uint32_t*>(buf) = *reinterpret_cast<const uint32_t*>(p);
  f[0] = to_f32(buf[0]);
  f[1] = to_f32(buf[1]);
}

// a step: kPer elements of x (kStep as one word, or one element, or one
// int4 pair) -> kPer wire values of kBits each, element k at bit kBits * k
// of the step's output (int4: element 2i in the low nibble of byte i).
// From the abs-max, the step holding element c * chunk writes chunk c's
// scale times ``mult`` to ``scales_out`` when that is given.
template <typename T, int kMode, bool kFromAmax, bool kVector, bool kOneScale>
__global__ void __launch_bounds__(kRowThreads)
chunk_quantize_kernel(const T* __restrict__ x, const float* __restrict__ src,
                      float inv_qmax, float mult,
                      float* __restrict__ scales_out,
                      uint8_t* __restrict__ out, int64_t rows, int h,
                      int chunk, int K) {
  constexpr int kPer = kVector || kMode == kNibble ? kStep : 1;
  constexpr int kBits = kMode == kNibble ? 4 : 8;
  const int steps = h / kPer;
  const int out_w = kMode == kNibble ? h / 2 : h;
  wait_for_predecessor();
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const T* xr = x + row * h;
    const float* sr = src + row * K;
    float* so = scales_out ? scales_out + row * K : nullptr;
    uint8_t* orow = out + row * out_w;
    for (int c = blockIdx.x * kRowThreads + threadIdx.x; c < steps;
         c += gridDim.x * kRowThreads) {
      const int j = c * kPer;
      float f[kPer];
      if constexpr (kVector) {
        load_pair(xr + j, f);
      } else {
#pragma unroll
        for (int k = 0; k < kPer; ++k) f[k] = to_f32(xr[j + k]);
      }
      uint32_t bits = 0;
      if constexpr (kOneScale) {
        const int ci = j / chunk;
        float s = chunk_scale<kFromAmax>(sr[ci], inv_qmax);
        if (kFromAmax && so && j == ci * chunk) so[ci] = __fmul_rn(s, mult);
        if (s == 0.f) s = 1.f;
#pragma unroll
        for (int k = 0; k < kPer; ++k)
          bits |= quantize_one<kMode>(f[k], s) << (kBits * k);
      } else {
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const int ci = (j + k) / chunk;
          float s = chunk_scale<kFromAmax>(sr[ci], inv_qmax);
          if (kFromAmax && so && j + k == ci * chunk) so[ci] = __fmul_rn(s, mult);
          if (s == 0.f) s = 1.f;
          bits |= quantize_one<kMode>(f[k], s) << (kBits * k);
        }
      }
      uint8_t* o = orow + j * kBits / 8;
      if constexpr (kPer * kBits == 16)
        *reinterpret_cast<uint16_t*>(o) = static_cast<uint16_t>(bits);
      else
        *o = static_cast<uint8_t>(bits);
    }
  }
}

// the vector path when x is aligned to the step's bytes and h a multiple
// of its values; int4 needs an even h (the entry point checks it)
template <typename T>
Plan quantize_plan(const void* x, int64_t rows, int h, int chunk, int mode) {
  Plan p{};
  p.vector = reinterpret_cast<uintptr_t>(x) % (kStep * sizeof(T)) == 0 &&
             h % kStep == 0;
  const int per = p.vector || mode == kNibble ? kStep : 1;
  p.one_scale = chunk % per == 0;
  p.grid = row_grid(rows, h / per);
  return p;
}

struct QuantizeArgs {
  const void* x;
  const float* src;
  float inv_qmax, mult;
  float* scales_out;
  uint8_t* out;
  int64_t rows;
  int h, chunk;
};

template <typename T, int kMode, bool kFromAmax, bool kVector>
void launch_quantize_v(const Plan& p, const QuantizeArgs& a,
                       cudaStream_t stream) {
  const int K = (a.h + a.chunk - 1) / a.chunk;
  const T* xp = static_cast<const T*>(a.x);
  constexpr int kPer = kVector || kMode == kNibble ? kStep : 1;
  auto* one = &chunk_quantize_kernel<T, kMode, kFromAmax, kVector, true>;
  if constexpr (kPer == 1) {   // one element a step: in one chunk
    launch_row_pass(one, p.grid, stream, xp, a.src, a.inv_qmax, a.mult,
                    a.scales_out, a.out, a.rows, a.h, a.chunk, K);
  } else {
    launch_row_pass(p.one_scale ? one
                                : &chunk_quantize_kernel<T, kMode, kFromAmax,
                                                         kVector, false>,
                    p.grid, stream, xp, a.src, a.inv_qmax, a.mult,
                    a.scales_out, a.out, a.rows, a.h, a.chunk, K);
  }
}

template <typename T, int kMode, bool kFromAmax>
void launch_quantize_m(const Plan& p, const QuantizeArgs& a,
                       cudaStream_t stream) {
  if (p.vector)
    launch_quantize_v<T, kMode, kFromAmax, true>(p, a, stream);
  else
    launch_quantize_v<T, kMode, kFromAmax, false>(p, a, stream);
}

template <typename T, int kMode>
void launch_quantize_s(const Plan& p, const QuantizeArgs& a, bool from_amax,
                       cudaStream_t stream) {
  if (from_amax)
    launch_quantize_m<T, kMode, true>(p, a, stream);
  else
    launch_quantize_m<T, kMode, false>(p, a, stream);
}

template <typename T>
cudaError_t launch_quantize(const QuantizeArgs& a, bool from_amax, int mode,
                            cudaStream_t stream) {
  const Plan p = quantize_plan<T>(a.x, a.rows, a.h, a.chunk, mode);
  if (mode == kInt8)
    launch_quantize_s<T, kInt8>(p, a, from_amax, stream);
  else if (mode == kFloat8E4M3)
    launch_quantize_s<T, kFloat8E4M3>(p, a, from_amax, stream);
  else if (mode == kNibble)
    launch_quantize_s<T, kNibble>(p, a, from_amax, stream);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// the grid floor: a kernel that does nothing but wait for its
// predecessor, launched at another's grid as B5 and B6 are launched
__global__ void empty_kernel() { wait_for_predecessor(); }

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

// ------------------------------------------------- B9 + add + B1
// the rows of x + dequantize(q) (x, q and the outputs contiguous), each
// value as the chain rounds it: d = round(q * scale), s = round(x + d)
template <typename T, int kMode>
struct DequantAddSrc {
  static constexpr bool kStore = true;
  static constexpr int N = Vec16<T>::N;
  struct Raw {
    uint4 x;
    uint2 q;    // N bytes: all 8 (bf16) or the first 4 (f32)
    float s;    // the scale of element e
  };
  const uint8_t* q;
  const float* scales;
  const T* x;
  int h, chunk, K;

  __device__ float value(float x_e, uint8_t q_e, float scale) const {
    return round_to<T>(
        x_e + round_to<T>(__fmul_rn(wire_to_f32<kMode>(q_e), scale)));
  }
  // q: N bytes at an N-byte boundary (the launch checks it)
  __device__ void fetch(int64_t row, int e, Raw& r) const {
    r.x = load16(x + row * h + e);
    if constexpr (N == 8)
      r.q = *reinterpret_cast<const uint2*>(q + row * h + e);
    else
      r.q.x = *reinterpret_cast<const uint32_t*>(q + row * h + e);
    r.s = scales[row * K + e / chunk];
  }
  __device__ void values(int64_t row, int e, const Raw& r,
                         float (&f)[N]) const {
    Vec16<T>::unpack(r.x, f);
    uint8_t b[N];
#pragma unroll
    for (int j = 0; j < N; ++j)
      b[j] = static_cast<uint8_t>((j < 4 ? r.q.x : r.q.y) >> (8 * (j % 4)));
    if (chunk % N == 0) {   // the N values share e's chunk
#pragma unroll
      for (int j = 0; j < N; ++j) f[j] = value(f[j], b[j], r.s);
    } else {
      const float* sr = scales + row * K;
#pragma unroll
      for (int j = 0; j < N; ++j) f[j] = value(f[j], b[j], sr[(e + j) / chunk]);
    }
  }
  __device__ float at(int64_t row, int e) const {
    return value(to_f32(x[row * h + e]), q[row * h + e],
                 scales[row * K + e / chunk]);
  }
};

template <typename T>
cudaError_t launch_dequantize_add_rmsnorm(const void* q, const float* scales,
                                          const void* x, const void* w,
                                          void* s, void* n, int64_t rows,
                                          int h, int chunk, float eps,
                                          int qdtype, cudaStream_t stream) {
  const int K = (h + chunk - 1) / chunk;
  const uint8_t* qp = static_cast<const uint8_t*>(q);
  const T* xp = static_cast<const T*>(x);
  const bool vector =
      aligned16(x) && reinterpret_cast<uintptr_t>(q) % Vec16<T>::N == 0;
  const T* wp = static_cast<const T*>(w);
  T* sp = static_cast<T*>(s);
  T* np = static_cast<T*>(n);
  if (qdtype == kInt8)
    return launch_rownorm<T>(DequantAddSrc<T, kInt8>{qp, scales, xp, h, chunk,
                                                     K},
                             vector, wp, sp, np, rows, h, eps, stream);
  if (qdtype == kFloat8E4M3)
    return launch_rownorm<T>(
        DequantAddSrc<T, kFloat8E4M3>{qp, scales, xp, h, chunk, K}, vector,
        wp, sp, np, rows, h, eps, stream);
  return cudaErrorInvalidValue;
}

// ------------------------------------------------- int4: B8+B7, B8+B9
// Both passes walk the 2-D grid of the row passes, so no thread divides a
// 64-bit flat index by the row width: at the decode shape a step is a few
// hundred cycles and such a division would be a large share of it.

// the nibble at bit ``shift`` of b, sign-extended
__device__ __forceinline__ int nibble_value(uint32_t b, int shift) {
  return static_cast<int>(((b >> shift) & 0xFu) ^ 8u) - 8;
}

// requantize an exact sum r of t int4 values: rint(r / t) clipped to +-7
__device__ __forceinline__ uint32_t requant_nibble(int r, int t) {
  const float v = clip(rintf(static_cast<float>(r) / static_cast<float>(t)),
                       -7.f, 7.f);
  return static_cast<uint32_t>(static_cast<int>(v)) & 0xFu;
}

// a row of ``in`` is the t source ranks' copies of this rank's block, mb
// bytes each, in rank order; output byte c of the row sums byte c of each.
// kT > 0 fixes t at compile time, so the t loads of a step are unrolled and
// in flight together (kT = 0: t at run time)
template <int kT>
__global__ void __launch_bounds__(kRowThreads)
nibble_reduce_requant_kernel(const uint8_t* __restrict__ in,
                             uint8_t* __restrict__ out, int64_t rows, int mb,
                             int t_run) {
  const int t = kT > 0 ? kT : t_run;
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const uint8_t* src = in + row * mb * t;
    for (int c = blockIdx.x * kRowThreads + threadIdx.x; c < mb;
         c += gridDim.x * kRowThreads) {
      int lo = 0, hi = 0;                  // exact: |r| <= 8t
#pragma unroll
      for (int s = 0; s < t; ++s) {
        const uint32_t b = src[s * mb + c];
        lo += nibble_value(b, 0);
        hi += nibble_value(b, 4);
      }
      out[row * mb + c] = static_cast<uint8_t>(
          requant_nibble(lo, t) | (requant_nibble(hi, t) << 4));
    }
  }
}

cudaError_t launch_reduce_requant(const uint8_t* in, uint8_t* out,
                                  int64_t rows, int mb, int t,
                                  cudaStream_t stream) {
  const dim3 grid = row_grid(rows, mb);
  if (t == 2)
    nibble_reduce_requant_kernel<2><<<grid, kRowThreads, 0, stream>>>(
        in, out, rows, mb, t);
  else if (t == 4)
    nibble_reduce_requant_kernel<4><<<grid, kRowThreads, 0, stream>>>(
        in, out, rows, mb, t);
  else if (t == 8)
    nibble_reduce_requant_kernel<8><<<grid, kRowThreads, 0, stream>>>(
        in, out, rows, mb, t);
  else
    nibble_reduce_requant_kernel<0><<<grid, kRowThreads, 0, stream>>>(
        in, out, rows, mb, t);
  return cudaGetLastError();
}

// packed byte c of a row holds elements 2c and 2c + 1, each scaled by its
// own chunk's scale (one lookup when chunk is even)
template <typename T, bool kOneScale>
__global__ void __launch_bounds__(kRowThreads)
nibble_unpack_dequantize_kernel(const uint8_t* __restrict__ b,
                                const float* __restrict__ scales,
                                T* __restrict__ out, int64_t rows, int m,
                                int chunk, int K) {
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const uint8_t* br = b + row * m;
    const float* sr = scales + row * K;
    T* orow = out + row * 2 * m;
    for (int c = blockIdx.x * kRowThreads + threadIdx.x; c < m;
         c += gridDim.x * kRowThreads) {
      const int j = 2 * c;
      const uint32_t v = br[c];
      const float s0 = sr[j / chunk];
      const float s1 = kOneScale ? s0 : sr[(j + 1) / chunk];
      orow[j] = from_f32<T>(static_cast<float>(nibble_value(v, 0)) * s0);
      orow[j + 1] = from_f32<T>(static_cast<float>(nibble_value(v, 4)) * s1);
    }
  }
}

template <typename T>
cudaError_t launch_unpack_dequantize(const uint8_t* b, const float* scales,
                                     void* out, int64_t rows, int m,
                                     int chunk, cudaStream_t stream) {
  const int K = (2 * m + chunk - 1) / chunk;
  const dim3 grid = row_grid(rows, m);
  T* op = static_cast<T*>(out);
  if (chunk % 2 == 0)
    nibble_unpack_dequantize_kernel<T, true>
        <<<grid, kRowThreads, 0, stream>>>(b, scales, op, rows, m, chunk, K);
  else
    nibble_unpack_dequantize_kernel<T, false>
        <<<grid, kRowThreads, 0, stream>>>(b, scales, op, rows, m, chunk, K);
  return cudaGetLastError();
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

// B6 on every wire: mode int8 (2), fp8-e4m3 (4) or int4 (5, packed two a
// byte, h even).  ``src`` holds the scales (from_amax = 0) or the
// all-reduced abs-max (from_amax = 1: scale = amax > 0 ? amax * inv_qmax :
// 1); from the abs-max, a non-null ``scales_out`` [rows, K] receives every
// chunk's scale times ``mult``.
REPRO_EXPORT int repro_chunk_quantize(const void* x, const void* src,
                                      void* scales_out, void* out,
                                      long long rows, int h, int chunk,
                                      int from_amax, float inv_qmax,
                                      float mult, int dtype, int mode,
                                      void* stream) {
  if (rows <= 0 || h <= 0 || chunk <= 0 || (mode == repro::kNibble && h % 2) ||
      (scales_out && !from_amax))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const repro::QuantizeArgs a{x, static_cast<const float*>(src), inv_qmax,
                              mult, static_cast<float*>(scales_out),
                              static_cast<uint8_t*>(out), rows, h, chunk};
  if (dtype == repro::kFloat32)
    return repro::launch_quantize<float>(a, from_amax != 0, mode, s);
  if (dtype == repro::kBFloat16)
    return repro::launch_quantize<__nv_bfloat16>(a, from_amax != 0, mode, s);
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

REPRO_EXPORT int repro_nibble_reduce_requant(const void* in, void* out,
                                             long long rows, int mb, int t,
                                             void* stream) {
  if (rows <= 0 || mb <= 0 || t <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return repro::launch_reduce_requant(
      static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out), rows, mb,
      t, static_cast<cudaStream_t>(stream));
}

REPRO_EXPORT int repro_nibble_unpack_dequantize(const void* b,
                                                const void* scales, void* out,
                                                long long rows, int m,
                                                int chunk, int dtype,
                                                void* stream) {
  if (rows <= 0 || m <= 0 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* bp = static_cast<const uint8_t*>(b);
  const float* sc = static_cast<const float*>(scales);
  if (dtype == repro::kFloat32)
    return repro::launch_unpack_dequantize<float>(bp, sc, out, rows, m, chunk,
                                                  s);
  if (dtype == repro::kBFloat16)
    return repro::launch_unpack_dequantize<__nv_bfloat16>(bp, sc, out, rows,
                                                          m, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

REPRO_EXPORT int repro_dequantize_add_rmsnorm(const void* q,
                                              const void* scales,
                                              const void* x, const void* w,
                                              void* s, void* n, long long rows,
                                              int h, int chunk, float eps,
                                              int qdtype, int dtype,
                                              void* stream) {
  if (rows <= 0 || h <= 0 || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scales);
  if (dtype == repro::kFloat32)
    return repro::launch_dequantize_add_rmsnorm<float>(
        q, sc, x, w, s, n, rows, h, chunk, eps, qdtype, st);
  if (dtype == repro::kBFloat16)
    return repro::launch_dequantize_add_rmsnorm<__nv_bfloat16>(
        q, sc, x, w, s, n, rows, h, chunk, eps, qdtype, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The grid of B5 (kernel 0) or B6 (kernel 1, wire ``mode``) on x [rows, h]
// of ``dtype`` into grid[0..2] (blocks in x and y, threads a block); with
// ``launch`` set, an empty kernel runs at that grid: what B5's and B6's
// launches cost before their first instruction.
REPRO_EXPORT int repro_quant_grid(const void* x, int kernel, long long rows,
                                  int h, int chunk, int dtype, int mode,
                                  int launch, int* grid, void* stream) {
  if (rows <= 0 || h <= 0 || chunk <= 0 ||
      (dtype != repro::kFloat32 && dtype != repro::kBFloat16))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool f32 = dtype == repro::kFloat32;
  repro::Plan p;
  if (kernel == 0)
    p = f32 ? repro::amax_plan<float>(x, rows, h, chunk)
            : repro::amax_plan<__nv_bfloat16>(x, rows, h, chunk);
  else if (kernel == 1)
    p = f32 ? repro::quantize_plan<float>(x, rows, h, chunk, mode)
            : repro::quantize_plan<__nv_bfloat16>(x, rows, h, chunk, mode);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  grid[0] = static_cast<int>(p.grid.x);
  grid[1] = static_cast<int>(p.grid.y);
  grid[2] = repro::kRowThreads;
  if (launch)
    repro::launch_row_pass(repro::empty_kernel, p.grid,
                           static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
