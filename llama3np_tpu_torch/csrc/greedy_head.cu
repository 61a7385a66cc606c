// Fused lm_head + argmax (a greedy head) for Hopper (sm_90a): float32,
// bf16 or float16 weights.
//
// Replaces: llama3np_tpu/ops/kernels/greedy_head.py, `argmax_head` (:70;
// kernel `_make_kernel` :42, pallas_call at :83).  One row's greedy token:
// argmax(x.astype(w.dtype) @ w) with f32 sums, x [1, D], w [D, VS], the
// lowest index winning a tie (np.argmax / torch.argmax order); the [1, VS]
// logits never reach device memory.
//
// What bounds it on the H100: bytes.  The lm_head is read once, D*VS
// weights (1.05 GB at llama3-8b in bf16, 0.314 ms at 3.35 TB/s; 262 MB at
// tinyllama-1.1b in f32, 0.078 ms), at 2 FLOPs a weight: far below the
// card's ratio of compute to bandwidth.
//
// Design: one launch.  The TPU kernel walks vocab blocks in order on one
// core and carries a running (max, argmax) pair in SMEM from one grid step
// to the next.  Blocks on the GPU run in parallel and in no order, so:
//  * The grid is (column strips x D splits).  A strip is 32*V neighbouring
//    vocab columns (V = 4 f32 or 8 bf16 / float16 weights a 16-byte load):
//    lane c of every warp reads columns [c*V, c*V+V) of a row as one
//    vector, so a warp reads 512 contiguous bytes of a row.  A block takes
//    the rows [split * rows, ...) of its strip; the wrapper's planner
//    (`ops/kernels/greedy_head.head_plan`) sizes the splits from (D, VS,
//    element size, SM count) so that the grid fills whole waves of four
//    blocks an SM (__launch_bounds__(256, 4)), each block the same bytes.
//  * Each step, the 8 warps read 64 rows: every lane issues its 8 16-byte
//    loads before it multiplies any of them, so 32 KB of a block (128 KB
//    of an SM) are in flight, enough to cover HBM latency.  The loads are
//    streaming ones (ld.global.cs: the head is read once a token; 1-2.5 %
//    faster than __ldg, PERF.md).
//  * x's rows of the split are staged in shared memory once (widened to
//    f32; the wrapper hands it over in the weight dtype, the TPU kernel's
//    x.astype(w.dtype)).  The 8 warps' partial sums meet in shared memory
//    in warp order.
//  * Split-K finish: each block writes its split's column sums to scratch,
//    and after a __threadfence counts its arrival on the strip's ticket;
//    the last block of the strip to arrive sums the splits in split order
//    (bit-equal from run to run, whatever order the blocks ran in), masks
//    the columns past VS, and reduces the strip to one (max, lowest index)
//    pair.  The last strip to finish (a second ticket) folds every strip's
//    pair, writes the token and resets the tickets for the next call (each
//    strip's last block resets its own), so no call pays for clearing them.
// The reductions use the total order "greater value, then lower index", so
// a tie across a split or strip boundary goes to the lower column, and a
// masked tail column (-inf) never beats a real one.  No float atomics.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;                  // rows in flight a lane
constexpr int kRowStep = kWarps * kUnroll;  // rows of a block step

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

// acc[j] += a * (the V weights in the 16 bytes `u`), widened exactly.
__device__ __forceinline__ void fma_row(float (&acc)[4], float a, uint4 u, float) {
  acc[0] = fmaf(a, __uint_as_float(u.x), acc[0]);
  acc[1] = fmaf(a, __uint_as_float(u.y), acc[1]);
  acc[2] = fmaf(a, __uint_as_float(u.z), acc[2]);
  acc[3] = fmaf(a, __uint_as_float(u.w), acc[3]);
}

// Eight bf16 weights: a bf16 is the high half of its float.
__device__ __forceinline__ void fma_row(float (&acc)[8], float a, uint4 u, __nv_bfloat16) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[2 * i] = fmaf(a, __uint_as_float(w[i] << 16), acc[2 * i]);
    acc[2 * i + 1] = fmaf(a, __uint_as_float(w[i] & 0xffff0000u), acc[2 * i + 1]);
  }
}

// Eight float16 weights (exact in f32).
__device__ __forceinline__ void fma_row(float (&acc)[8], float a, uint4 u, __half) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
    acc[2 * i] = fmaf(a, f.x, acc[2 * i]);
    acc[2 * i + 1] = fmaf(a, f.y, acc[2 * i + 1]);
  }
}

// (m, i) <- the better of (m, i) and (m2, i2): the greater value, and on
// equal values the lower index.
__device__ __forceinline__ void take_better(float& m, int& i, float m2, int i2) {
  if (m2 > m || (m2 == m && i2 < i)) {
    m = m2;
    i = i2;
  }
}

// Reduce one pair per thread to the block's best pair (in red_m/red_i[0]).
__device__ void block_best(float m, int i, float* red_m, int* red_i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, off);
    take_better(m, i, m2, i2);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red_m[warp] = m;
    red_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? red_m[lane] : -INFINITY;
    i = lane < kWarps ? red_i[lane] : INT32_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
      const int i2 = __shfl_xor_sync(0xffffffffu, i, off);
      take_better(m, i, m2, i2);
    }
    if (lane == 0) {
      red_m[0] = m;
      red_i[0] = i;
    }
  }
  __syncthreads();
}

// Scratch (f32 words): [ks][VS] split column sums (ks > 1 only), then each
// strip's max [strips], then its index [strips] (int32).  count: [strips]
// strip tickets, then the fold's ticket; zero before and after every call.
template <typename W>
__global__ void __launch_bounds__(kThreads, 4)
argmax_head_kernel(const W* __restrict__ x, const W* __restrict__ w, int D, int VS,
                   int rows, float* __restrict__ scratch, unsigned* __restrict__ count,
                   int64_t* __restrict__ out) {
  constexpr int V = 16 / (int)sizeof(W);
  constexpr int kCols = 32 * V;  // vocab columns of a strip
  __shared__ __align__(16) float red[kWarps * kCols];  // the warps' partial sums
  extern __shared__ float xs[];                          // [rows] x, widened
  __shared__ float red_m[32];
  __shared__ int red_i[32];
  __shared__ int is_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int strip = blockIdx.x, split = blockIdx.y, ks = gridDim.y, strips = gridDim.x;
  const int r0 = split * rows, n = min(D, r0 + rows) - r0;
  float* part = scratch;
  float* strip_m = scratch + (ks > 1 ? (size_t)ks * VS : 0);
  int* strip_i = reinterpret_cast<int*>(strip_m + strips);
  for (int i = tid; i < n; i += kThreads) xs[i] = to_f(x[r0 + i]);
  __syncthreads();

  const int col = strip * kCols + lane * V;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  if (col < VS) {  // VS % V == 0: the whole vector is in range
    const W* wp = w + (size_t)r0 * VS + col;
    for (int g = warp; g < n; g += kRowStep) {
      uint4 u[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {  // every load issued before any use
        const int r = g + k * kWarps;
        u[k] = r < n ? __ldcs(reinterpret_cast<const uint4*>(wp + (size_t)r * VS))
                     : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int r = g + k * kWarps;
        fma_row(acc, r < n ? xs[r] : 0.f, u[k], W());
      }
    }
  }
  float4* rr = reinterpret_cast<float4*>(red + warp * kCols + lane * V);
#pragma unroll
  for (int j = 0; j < V / 4; ++j)
    rr[j] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
  __syncthreads();

  // The split's column sums, warps in order (kCols <= kThreads: one a thread).
  const int c = strip * kCols + tid;
  float s = 0.f;
  if (tid < kCols) {
#pragma unroll
    for (int r = 0; r < kWarps; ++r) s += red[r * kCols + tid];
  }
  if (ks > 1) {  // split-K: the strip's last block to arrive finishes it
    if (tid < kCols && c < VS) part[(size_t)split * VS + c] = s;
    __threadfence();
    __syncthreads();
    if (tid == 0) is_last = atomicAdd(count + strip, 1u) == (unsigned)(ks - 1);
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    if (tid < kCols && c < VS) {
      s = 0.f;
      for (int sp = 0; sp < ks; ++sp) s += __ldcg(part + (size_t)sp * VS + c);
    }
    if (tid == 0) count[strip] = 0u;
  }
  float m = -INFINITY;
  int idx = INT32_MAX;
  if (tid < kCols && c < VS) {
    m = s;
    idx = c;
  }
  block_best(m, idx, red_m, red_i);

  // The last strip to finish folds every strip's pair.
  if (tid == 0) {
    strip_m[strip] = red_m[0];
    strip_i[strip] = red_i[0];
    __threadfence();
    is_last = atomicAdd(count + strips, 1u) == (unsigned)(strips - 1);
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  m = -INFINITY;
  idx = INT32_MAX;
  for (int b = tid; b < strips; b += kThreads)
    take_better(m, idx, __ldcg(strip_m + b), __ldcg(strip_i + b));
  block_best(m, idx, red_m, red_i);
  if (tid == 0) {
    out[0] = red_i[0];
    count[strips] = 0u;
  }
}

template <typename W>
int run(const W* x, const W* w, int64_t* out, float* scratch, unsigned* count, int D,
        int VS, int rows, int device, void* stream) {
  constexpr int V = 16 / (int)sizeof(W);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaGetLastError();  // clear any stale error of this runtime
  if (D < 1 || VS < 1 || VS % V != 0 || rows < 1 || rows % kRowStep != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((VS + 32 * V - 1) / (32 * V), (D + rows - 1) / rows);
  const size_t smem = (size_t)rows * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(argmax_head_kernel<W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  argmax_head_kernel<W><<<grid, kThreads, smem, st>>>(x, w, D, VS, rows, scratch, count, out);
  return (int)cudaGetLastError();
}

}  // namespace

// x [D] and w [D, VS] row-major, both float32; out: one int64.  rows: the
// rows of a D split (a multiple of 64; splits = ceil(D / rows)).  scratch:
// (splits > 1 ? splits * VS : 0) + 2 * strips words, strips = VS / 128 (f32)
// or VS / 256 (16-bit) rounded up; count: strips + 1 zeroed words, left zero.
extern "C" int l3t_argmax_head_f32(const float* x, const float* w, int64_t* out,
                                   float* scratch, unsigned* count, int D, int VS,
                                   int rows, int device, void* stream) {
  return run<float>(x, w, out, scratch, count, D, VS, rows, device, stream);
}

// As l3t_argmax_head_f32, with bf16 x and w.
extern "C" int l3t_argmax_head_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                    int64_t* out, float* scratch, unsigned* count, int D,
                                    int VS, int rows, int device, void* stream) {
  return run<__nv_bfloat16>(x, w, out, scratch, count, D, VS, rows, device, stream);
}

// As l3t_argmax_head_f32, with float16 x and w.
extern "C" int l3t_argmax_head_f16(const __half* x, const __half* w, int64_t* out,
                                   float* scratch, unsigned* count, int D, int VS,
                                   int rows, int device, void* stream) {
  return run<__half>(x, w, out, scratch, count, D, VS, rows, device, stream);
}
