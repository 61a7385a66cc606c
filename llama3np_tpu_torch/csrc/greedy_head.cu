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
// Design.  The TPU kernel walks vocab blocks in order on one core and
// carries a running (max, argmax) pair in SMEM from one grid step to the
// next.  Blocks on the GPU run in parallel and in no order, so the carry
// becomes two launches:
//  1. argmax_head_partial: block b owns 32*V neighbouring vocab columns
//     (V = 4 f32 or 8 bf16 / float16 weights a 16-byte load).  Lane c of every warp
//     reads columns [c*V, c*V+V) of a row as one vector, so a warp reads 512
//     contiguous bytes; the 8 warps take interleaved rows.  x is staged in
//     shared memory once (widened to f32; the wrapper hands it over in the
//     weight dtype, the TPU kernel's x.astype(w.dtype)).  The row groups'
//     partial sums meet in shared memory in a fixed order, the columns past
//     VS are masked to -inf, and the block reduces its columns to one
//     (max, lowest index) pair.
//  2. argmax_head_final: one block folds the pairs.
// Both reductions use the total order "greater value, then lower index", so
// the result does not depend on the order in which blocks run or pairs meet
// (no float atomics), a tie across a block boundary goes to the lower
// column, and a masked tail column (-inf) never beats a real one.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowGroups = kThreads / 32;
constexpr int kFinalThreads = 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

__device__ __forceinline__ void load_w(const float* p, float (&w)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

// Eight bf16 weights -> floats: a bf16 is the high half of its float.
__device__ __forceinline__ void load_w(const __nv_bfloat16* p, float (&w)[8]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[2 * i] = __uint_as_float(u[i] << 16);
    w[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// Eight float16 weights -> floats (exact).
__device__ __forceinline__ void load_w(const __half* p, float (&w)[8]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&u[i]));
    w[2 * i] = f.x;
    w[2 * i + 1] = f.y;
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
    const int nw = blockDim.x >> 5;
    m = lane < nw ? red_m[lane] : -INFINITY;
    i = lane < nw ? red_i[lane] : INT32_MAX;
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

template <typename W>
__global__ void __launch_bounds__(kThreads)
argmax_head_partial(const W* __restrict__ x, const W* __restrict__ w, int D,
                    int VS, float* __restrict__ part_m, int* __restrict__ part_i) {
  constexpr int V = 16 / (int)sizeof(W);
  constexpr int kCols = 32 * V;  // vocab columns of a block
  extern __shared__ __align__(16) float smem[];
  float* red = smem;                   // [kRowGroups][kCols] partial sums
  float* xs = red + kRowGroups * kCols;  // [D] x, widened
  __shared__ float red_m[32];
  __shared__ int red_i[32];
  for (int i = threadIdx.x; i < D; i += kThreads) xs[i] = to_f(x[i]);
  __syncthreads();

  const int cx = threadIdx.x & 31, ry = threadIdx.x >> 5;
  const int col = blockIdx.x * kCols + cx * V;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  if (col < VS) {  // VS % V == 0: the whole vector is in range
    const W* wp = w + col;
#pragma unroll 4
    for (int r = ry; r < D; r += kRowGroups) {
      float wv[V];
      load_w(wp + (size_t)r * VS, wv);
      const float a = xs[r];
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = fmaf(a, wv[j], acc[j]);
    }
  }
  float4* rr = reinterpret_cast<float4*>(red + ry * kCols + cx * V);
#pragma unroll
  for (int j = 0; j < V / 4; ++j)
    rr[j] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
  __syncthreads();

  float m = -INFINITY;
  int idx = INT32_MAX;
  for (int c0 = threadIdx.x; c0 < kCols; c0 += kThreads) {
    const int c = blockIdx.x * kCols + c0;
    if (c < VS) {
      float s = 0.f;
      for (int r = 0; r < kRowGroups; ++r) s += red[r * kCols + c0];
      take_better(m, idx, s, c);
    }
  }
  block_best(m, idx, red_m, red_i);
  if (threadIdx.x == 0) {
    part_m[blockIdx.x] = red_m[0];
    part_i[blockIdx.x] = red_i[0];
  }
}

__global__ void __launch_bounds__(kFinalThreads)
argmax_head_final(const float* __restrict__ part_m, const int* __restrict__ part_i,
                  int n, int64_t* __restrict__ out) {
  __shared__ float red_m[32];
  __shared__ int red_i[32];
  float m = -INFINITY;
  int idx = INT32_MAX;
  for (int b = threadIdx.x; b < n; b += kFinalThreads) take_better(m, idx, part_m[b], part_i[b]);
  block_best(m, idx, red_m, red_i);
  if (threadIdx.x == 0) out[0] = red_i[0];
}

template <typename W>
int run(const W* x, const W* w, int64_t* out, float* part_m, int* part_i, int D,
        int VS, int device, void* stream) {
  constexpr int V = 16 / (int)sizeof(W);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaGetLastError();  // clear any stale error of this runtime
  if (D < 1 || VS < 1 || VS % V != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = (VS + 32 * V - 1) / (32 * V);
  const size_t smem = ((size_t)kRowGroups * 32 * V + D) * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(argmax_head_partial<W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  argmax_head_partial<W><<<nb, kThreads, smem, st>>>(x, w, D, VS, part_m, part_i);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  argmax_head_final<<<1, kFinalThreads, 0, st>>>(part_m, part_i, nb, out);
  return (int)cudaGetLastError();
}

}  // namespace

// part_m/part_i: one (float, int) pair per block of 32 * (16 / element
// size) vocab columns.  x [D] and w [D, VS] row-major, both float32; out:
// one int64.
extern "C" int l3t_argmax_head_f32(const float* x, const float* w, int64_t* out,
                                   float* part_m, int* part_i, int D, int VS,
                                   int device, void* stream) {
  return run<float>(x, w, out, part_m, part_i, D, VS, device, stream);
}

// x [D] and w [D, VS] row-major, both bf16; out: one int64.
extern "C" int l3t_argmax_head_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                    int64_t* out, float* part_m, int* part_i, int D,
                                    int VS, int device, void* stream) {
  return run<__nv_bfloat16>(x, w, out, part_m, part_i, D, VS, device, stream);
}

// x [D] and w [D, VS] row-major, both float16; out: one int64.
extern "C" int l3t_argmax_head_f16(const __half* x, const __half* w, int64_t* out,
                                   float* part_m, int* part_i, int D, int VS,
                                   int device, void* stream) {
  return run<__half>(x, w, out, part_m, part_i, D, VS, device, stream);
}
