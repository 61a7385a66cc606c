// Fused batch-1 decode step for Hopper (sm_90a): all layers of one token,
// in six modes: float32 weights and activations; int8 weights with
// per-output-column f32 scales under float32 activations; bf16 weights,
// activations and caches; int8 weights with f32 scales under bf16
// activations and caches; and the float16 counterparts of the last two
// (float16 weights, activations and caches; int8 weights under float16
// activations and caches).  Each mode also runs over caches of either other
// float type (the JAX engine's `kv_dtype` override, e.g. float32
// activations over a bf16 cache): the cache is a template parameter of its
// own, and attention over a 16-bit cache of another type than the
// activations takes `_attend_head`'s rounding points (see Attn below).
//
// Replaces: llama3np_tpu/ops/kernels/decode_step.py, `decode_layers` (:917)
// in its whole-layer form (`make_decode_kernel` :266, pallas_call at :992),
// and so the math its FFN-blocked / KV-head-grouped / streamed TPU layouts
// (:417, :563, :793) share.  The int8 and bf16 modes are the streamed
// layout's (`_streamed_decode_layers` :793, pallas_call :899, body
// `make_streamed_kernel` :629-788): per layer RMSNorm -> fused QKV ->
// split-halves RoPE -> attention over the cache masked to kv_idx < pos with
// the current token appended as an explicit column -> o-proj + residual ->
// RMSNorm -> SwiGLU + residual, writing the new K/V rows at `pos`.
//
// What bounds it on the H100: bytes.  Each token reads every layer weight
// once (fp32: 23.9 MB for stories15M, 3.88 GB for tinyllama-1.1b; int8 a
// quarter of that plus 4 bytes of scale per output column; bf16: 13.96 GB
// for llama3-8b, int8 6.98 GB), plus 2*KVH*HD cache elements per layer and
// position, at 1-2 FLOP a byte: far below the card's ratio of compute to
// bandwidth.  The floor is bytes / 3.35 TB/s (~1.16 ms a token at
// tinyllama widths in fp32, ~0.29 ms in int8; ~4.17 ms at llama3-8b in
// bf16, ~2.10 ms in int8).
//
// Design (this replaces the first design's seven or eight launches a layer,
// at commit cf46350 of this file: its `residual_rmsnorm_kernel` (:190,
// launched at :535/:538/:556) summed every split-K partial row of the
// previous GEMV on one SM, twice a layer, and its `attn_combine_kernel`
// (:411, launched at :550) merged attention's splits in a launch of its
// own).  Five launches a layer, none of them a single-block step, and
// nothing at the end:
//   1. GEMV rmsnorm(x) @ wqkv;       2. attention (KV head x position split);
//   3. GEMV attn @ wo, + residual;   4. GEMV rmsnorm(h) @ wgu;
//   5. GEMV silu(gate)*up @ w_down, + residual (the last layer writes x_out).
// GEMV: weights are [in, out] row-major.  A block owns a column tile of 512
// bytes of each row (128 fp32, 256 bf16 or 512 int8 columns) and a range of
// rows (a split of K).  Its rows stream through a 6-stage ring of 32-row
// stages (16 KB each, 96 KB) in shared memory, filled by cp.async, so 80 KB
// of weights are in flight per block whatever the registers, ~160 KB an SM
// at two blocks an SM.  The splits are chosen so that the blocks fill whole
// waves of the blocks the SMs hold (at most 12 for a small GEMV, below).
// The split-K reduction is inside the GEMV: each split writes its partial
// columns, then (after __threadfence) counts its arrival on the tile's
// counter; the last block to arrive sums the tile's partials in split
// order (deterministic), applies the per-column scale and the epilogue:
// store the finished columns, or add the residual (rounded to bf16 at a
// bf16 layer's end) and write the tile's sum of squares, which the next
// GEMV's prologue turns into rsqrt(mean + eps) from a few per-tile sums;
// that block resets the counter.  Attention's splits merge the same way:
// the last split of a KV head to arrive merges its heads.  Attention splits
// each KV head's cache rows into position chunks (~2 blocks an SM, at least
// 16 rows a chunk, at most 64 KB of staged rows); a block copies its
// chunk's K and V rows into shared memory with cp.async before it waits on
// the QKV GEMV (rows < pos are not written by this call), so the cache's
// latency is off the critical path.
// Every launch is programmatic (cudaLaunchKernelEx with programmatic stream
// serialization): a kernel issues its first weight stages (or cache rows),
// then waits on `griddepcontrol.wait` for its predecessor's results.  A
// GEMV lets its successor launch right after that wait, attention once its
// rows are read, so no launch latency sits between the steps and the next
// kernel's first stages stream while this one drains.
// Products.  fp32 and bf16 weights: CUDA cores, one 16-byte vector of a
// staged row a lane (a bf16 widens by a shift).  int8 under f32
// activations: the lane widens its 16 weights to f32 with byte permutes
// (the float with bits 0x4B0000uu is 2^23 + uu, exact) and multiplies them
// by the f32 activations, which are never narrowed (the TPU kernel's bf16
// cast in `_wdot` :241 was an MXU dtype rule; the XLA int8 path, the
// numerics oracle, keeps f32), so that mode keeps its 1e-4 card tolerance.
// int8 under bf16 activations (`_wdot` exactly): tensor cores.  Each warp
// takes 64 columns of every staged row; an int8 pair widens to a bf16 pair
// exactly in four integer/bf16x2 operations (128 + (b & 127) by bit
// pattern, minus 128 or 256 by the sign bit), the weights are the A
// operand of mma.sync m16n8k16 (16 output columns x 16 rows), the
// bf16-rounded activation the single live column of B, f32 accumulators:
// exact products, f32 sums.  The per-column scale multiplies the finished
// sum: (sum of partials) * s, and the gate/up scale is in place before
// SiLU.  Rounding points: bf16 activations enter each GEMV rounded to bf16
// (the normed x, the attention output, silu(gate)*up); RMSNorm, the QKV
// sums, RoPE and attention are f32 (cache rows widened, the current token
// appended as its f32 k_rot/v_new column); the new K/V rows are stored in
// the cache dtype; the residual stays f32 through the layer and is rounded
// to bf16 once, at its end.  fp32 modes round nowhere.
// float16 modes: the bf16 modes' rounding points in float16 (the activation
// before a float16 weight, the stored K/V rows, the residual at a layer's
// end), float16 weights on CUDA cores.  int8 weights under float16
// activations take `_wdot`'s rule as it is: the activation is rounded to
// bf16, not float16, before the int8 product (the JAX kernel casts x to bf16
// for any int8 weight), so that mode is the int8/bf16 tensor-core GEMV, with
// float16 norms, caches, residual and output around it.
// The cache is updated in place: split 0 of each KV head writes k_rot and
// v_new into row `pos`, and attention never reads row `pos` (it masks
// kv_idx < pos), so the write cannot race a read; pos = 0 attends only the
// appended column; pos = M-1 writes the last row.  Numerics follow the TPU
// kernel: the RMS scale multiplied in before the weight (_rms_scale :235),
// SiLU as g/(1+exp(-g)) (:261), residuals summed in f32.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

typedef __nv_bfloat16 bf16;
typedef __half f16;

namespace {

constexpr int kThreads = 256;  // GEMV and attention blocks
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplit = 32;                      // row splits of one GEMV
// A GEMV of fewer weight bytes than this takes at most kSmallSplit splits:
// there a split's arrival and reload cost more than its rows (on an H100,
// stories15M's decode step ran 6-9 % faster with at most 12 splits for
// every GEMV, llama3-8b's int8 one 23 % slower).
constexpr long kSmallGemvBytes = 2L << 20;
constexpr int kSmallSplit = 12;
constexpr int kTileBytes = 512;                    // bytes of a row a column tile spans
constexpr int kStageRows = 32;                     // rows of one ring stage
constexpr int kStageBytes = kStageRows * kTileBytes;  // 16 KB
constexpr int kStages = 6;
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kMinColsF = kTileBytes / 4;          // columns of an fp32 tile
constexpr int kAttnMaxSplit = 128;                 // max position splits of attention
constexpr int kAttnStageBytes = 64 * 1024;         // staged K and V rows a split takes at most
constexpr int kAttnMinRows = 16;                   // cache rows a split takes at least
constexpr int kMaxDynSmem = 200 * 1024;            // dynamic shared memory a kernel may take

// Weights a lane reads as one 16-byte vector: 4 floats, 8 bf16 / f16 or 16
// int8.
template <typename W>
constexpr int kVec = 16 / (int)sizeof(W);
template <typename W>
constexpr int kCols = kTileBytes / (int)sizeof(W);  // columns of a tile
// 16-bit activations (bf16 or f16).
template <typename T>
constexpr bool kAct16 = std::is_same<T, bf16>::value || std::is_same<T, f16>::value;
// int8 weights under 16-bit activations run on the tensor cores (bf16).
template <typename W, typename T>
constexpr bool kMma = std::is_same<W, int8_t>::value && kAct16<T>;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(f16 v) { return __half2float(v); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(bf16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store_f(f16* p, float v) { *p = __float2half_rn(v); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float round_f16(float v) { return __half2float(__float2half_rn(v)); }
// v rounded to T (unchanged for float).
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same<T, bf16>::value) return round_bf16(v);
  else if constexpr (std::is_same<T, f16>::value) return round_f16(v);
  else return v;
}

// A GEMV's activation as its product sees it (the TPU kernel's `_wdot`):
// rounded to the weight's type before a 16-bit weight, to bf16 before an
// int8 weight under 16-bit activations, f32 otherwise.
template <typename W, typename T>
__device__ __forceinline__ float act_in(float v) {
  if constexpr (std::is_same<W, f16>::value || std::is_same<W, bf16>::value)
    return round_to<W>(v);
  else if constexpr (std::is_same<W, int8_t>::value && kAct16<T>)
    return round_bf16(v);
  else
    return v;
}

// ---- programmatic dependent launch and async copies --------------------

// Wait until the grids this one depends on have completed and their
// writes are visible (a no-op for a launch that is not programmatic).
__device__ __forceinline__ void grid_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
// Let the next programmatic launch in the stream start its blocks.
__device__ __forceinline__ void grid_release() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; zero-filled when !valid (src is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// 8 bytes global -> shared (both 8-byte aligned).
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Physical 16-byte chunk of logical chunk c of staged row r: rows whose
// bit 1 is set swap the halves of each 8-chunk group, so the tensor-core
// path's four row reads of one instruction fall on two bank groups.
__device__ __forceinline__ int swz(int r, int c) { return c ^ (((r >> 1) & 1) << 2); }

// ---- widening ------------------------------------------------------------

__device__ __forceinline__ void load_w(const float* p, float (&w)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

// Four signed bytes of v -> floats, exactly: b ^ 0x80 = b + 128 as an
// unsigned byte u; the float with bits 0x4B0000uu is 2^23 + u.
__device__ __forceinline__ void i8x4_to_f32(int v, float* f) {
  const unsigned u = static_cast<unsigned>(v) ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

__device__ __forceinline__ void load_w(const int8_t* p, float (&w)[16]) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  i8x4_to_f32(v.x, w);
  i8x4_to_f32(v.y, w + 4);
  i8x4_to_f32(v.z, w + 8);
  i8x4_to_f32(v.w, w + 12);
}

// Eight bf16 weights -> floats: a bf16 is the high half of its float.
__device__ __forceinline__ void load_w(const bf16* p, float (&w)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[2 * i] = __uint_as_float(u[i] << 16);
    w[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// Eight float16 weights -> floats (exact).
__device__ __forceinline__ void load_w(const f16* p, float (&w)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&u[i]));
    w[2 * i] = f.x;
    w[2 * i + 1] = f.y;
  }
}

// Bytes 0 and 2 of v (two int8 b) -> a bf16 pair, exactly: the bf16 with
// bits 0x4300 | (b & 127) is 128 + (b & 127); minus 128 (b >= 0) or 256
// (b < 0, bits 0x4380) gives b.  fma(m, 1, -s) in bf16x2: the result is an
// integer in [-128, 127], exact.
__device__ __forceinline__ uint32_t i8pair_to_bf16x2(uint32_t v) {
  const uint32_t m = (v & 0x007F007Fu) | 0x43004300u;
  const uint32_t ns = (v & 0x00800080u) | 0xC300C300u;
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(m), "r"(0x3F803F80u), "r"(ns));
  return r;
}

// Four consecutive elements of a cache row, widened (8-byte aligned in 16
// bits).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float4 load4(const f16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// d += a . b: one m16n8k16 product, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red may still be read from a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// ---- GEMV ----------------------------------------------------------------

enum { kInVec = 0, kInNorm = 1, kInSwiglu = 2 };  // what the input row is
enum { kOutStore = 0, kOutResid = 1 };            // what the epilogue does

template <typename T>
struct Gemv {
  const void* w;         // [K][N] weights of this layer
  const float* wscale;   // [N] per-column scales (int8), or null
  int K, N, rps, ks;     // rows per split, splits
  // Input. kInVec: vec [K]. kInNorm: rmsnorm of vec [K] (null: of x_t)
  // with norm_w; ss holds n_ss per-tile sums of squares of vec (null:
  // computed here from x_t). kInSwiglu: vec [2K] = gate | up.
  const float* vec;
  const T* x_t;
  const float* ss;
  int n_ss;
  const T* norm_w;
  float eps;
  // Output.
  float* part;           // [ks][N] partial columns (ks > 1)
  unsigned* count;       // [tiles] arrival counters, zero between uses
  float* out;            // [N] finished columns
  const float* resid;    // kOutResid: residual base [N] (null: resid_t)
  const T* resid_t;
  int round_out;         // kOutResid: round to T (the end of a 16-bit layer)
  float* out_ss;         // kOutResid: [tiles] sums of squares of out
  T* out_t;              // kOutResid, last layer: x_out (then no out/out_ss)
};

// A block's partial columns of rows [k0, k0+nk) of its tile, on CUDA cores:
// warp ry takes rows ry, ry+8, ... of each stage, lane cx the 16-byte
// vector cx of each row; the warps' sums meet in shared memory.
template <typename W>
__device__ __forceinline__ void gemv_stage_cores(const unsigned char* stage,
                                                 const float* xs, float* acc) {
  constexpr int V = kVec<W>;
  const int cx = threadIdx.x & 31, ry = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kStageRows / kWarps; ++j) {
    const int r = ry + j * kWarps;
    float w[V];
    load_w(reinterpret_cast<const W*>(stage + r * kTileBytes + swz(r, cx) * 16), w);
    const float a = xs[r];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = fmaf(a, w[i], acc[i]);
  }
}

// int8 under bf16 activations on tensor cores: warp w owns columns
// [64w, 64w+64) of the tile, lane (g = lane/4, t = lane%4) reads 8 bytes
// (columns 64w+8g ... +7) of rows 2t, 2t+1, 2t+8, 2t+9 of each 16-row
// step.  m-tile i (of 4) puts column 64w+8g+2i on A's row g and column
// +2i+1 on row g+8, so lane 4g's accumulators c[i][0] and c[i][2] end as
// those two columns' sums.  B's column 0 is the activation (lanes 0-3 hold
// it; the other columns are zero).
__device__ __forceinline__ void gemv_stage_mma(const unsigned char* stage,
                                               const float* xs, float (*c)[4]) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int cb = 64 * w + 8 * g;  // byte (= column) offset of the lane's 8 columns
  const int ch = cb >> 4, half = (cb >> 3) & 1;
#pragma unroll
  for (int k16 = 0; k16 < kStageRows; k16 += 16) {
    uint2 rw[4];  // rows 2t, 2t+1, 2t+8, 2t+9
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = k16 + 2 * t + (q & 1) + (q >> 1) * 8;
      rw[q] = *reinterpret_cast<const uint2*>(stage + r * kTileBytes + swz(r, ch) * 16 +
                                              half * 8);
    }
    uint32_t b0 = 0, b1 = 0;
    if (g == 0) {
      b0 = pack_bf16(xs[k16 + 2 * t], xs[k16 + 2 * t + 1]);
      b1 = pack_bf16(xs[k16 + 2 * t + 8], xs[k16 + 2 * t + 9]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // columns 2i, 2i+1 of the lane's 8: word i/2, bytes 2(i%2), +1
      const int wi = i >> 1, by = 2 * (i & 1);
      const uint32_t lo0 = wi ? rw[0].y : rw[0].x, lo1 = wi ? rw[1].y : rw[1].x;
      const uint32_t hi0 = wi ? rw[2].y : rw[2].x, hi1 = wi ? rw[3].y : rw[3].x;
      uint32_t a[4];
      // byte `by` of rows (2t, 2t+1) -> bytes 0 and 2; then byte by+1
      a[0] = i8pair_to_bf16x2(__byte_perm(lo0, lo1, by | ((4 + by) << 8)));
      a[1] = i8pair_to_bf16x2(__byte_perm(lo0, lo1, (by + 1) | ((5 + by) << 8)));
      a[2] = i8pair_to_bf16x2(__byte_perm(hi0, hi1, by | ((4 + by) << 8)));
      a[3] = i8pair_to_bf16x2(__byte_perm(hi0, hi1, (by + 1) | ((5 + by) << 8)));
      mma_bf16(c[i], a, b0, b1);
    }
  }
}

// Column `col` of the ks partial rows, every load in flight at once (S >=
// ks of them, predicated), summed in split order.
template <int S>
__device__ __forceinline__ float sum_splits(const float* part, int N, int ks, int col) {
  float p[S];
#pragma unroll
  for (int s = 0; s < S; ++s) p[s] = s < ks ? __ldcg(part + (size_t)s * N + col) : 0.f;
  float v = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s)
    if (s < ks) v += p[s];
  return v;
}

// out = in @ W over a K split, the split-K reduction by the last block to
// arrive at each column tile, then the epilogue (see Gemv).
template <int IN, int OUT, typename W, typename T>
__global__ void __launch_bounds__(kThreads, 2) decode_gemv_kernel(const Gemv<T> a) {
  constexpr int V = kVec<W>, C = kCols<W>;
  constexpr bool MMA = kMma<W, T>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem + kRingBytes);  // [rps rounded up]
  __shared__ float red32[32];
  __shared__ int is_last;
  const int tid = threadIdx.x;
  const int tile = blockIdx.x, split = blockIdx.y;
  const int c0 = tile * C, k0 = split * a.rps;
  const int nk = min(a.rps, a.K - k0);
  const int nst = (nk + kStageRows - 1) / kStageRows;
  const W* wg = static_cast<const W*>(a.w) + (size_t)k0 * a.N + c0;

  auto issue = [&](int st) {  // stage st into ring slot st % kStages
    unsigned char* dst = smem + (st % kStages) * kStageBytes;
#pragma unroll
    for (int i = 0; i < kStageBytes / 16 / kThreads; ++i) {
      const int chunk = tid + i * kThreads;
      const int r = chunk / (kTileBytes / 16), cv = chunk % (kTileBytes / 16);
      const int row = st * kStageRows + r;
      const bool ok = row < nk && c0 + cv * V < a.N;
      cp_async16(dst + r * kTileBytes + swz(r, cv) * 16,
                 ok ? static_cast<const void*>(wg + (size_t)row * a.N + cv * V) : a.w, ok);
    }
  };
  // The weights do not depend on the previous step: start streaming them.
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst) issue(s);
    cp_async_commit();
  }
  grid_wait();
  grid_release();  // the next kernel's blocks may start their prologue

  // The input rows of this split.
  float rs = 1.f;
  if (IN == kInNorm) {
    float ss = 0.f;
    if (a.ss != nullptr) {  // lane l sums tiles l, l+32, ...; then a fixed tree
      for (int i = tid & 31; i < a.n_ss; i += 32) ss += __ldcg(a.ss + i);
      for (int off = 16; off > 0; off >>= 1) ss += __shfl_down_sync(0xffffffffu, ss, off);
      ss = __shfl_sync(0xffffffffu, ss, 0);
    } else {
      for (int i = tid; i < a.K; i += kThreads) {
        const float x = to_f(a.x_t[i]);
        ss += x * x;
      }
      ss = block_sum(ss, red32);
    }
    rs = rsqrtf(ss / a.K + a.eps);
  }
  for (int i = tid; i < nst * kStageRows; i += kThreads) {
    float v = 0.f;
    if (i < nk) {
      const int k = k0 + i;
      if (IN == kInVec) {
        v = __ldcg(a.vec + k);
      } else if (IN == kInNorm) {
        const float x = a.vec != nullptr ? __ldcg(a.vec + k) : to_f(a.x_t[k]);
        v = x * rs * to_f(a.norm_w[k]);
      } else {
        const float g = __ldcg(a.vec + k), u = __ldcg(a.vec + a.K + k);
        v = g * (1.f / (1.f + expf(-g))) * u;
      }
      v = act_in<W, T>(v);
    }
    xs[i] = v;
  }

  float acc[MMA ? 16 : V];
#pragma unroll
  for (int i = 0; i < (MMA ? 16 : V); ++i) acc[i] = 0.f;
  for (int st = 0; st < nst; ++st) {
    if (st + kStages - 1 < nst) issue(st + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const unsigned char* stage = smem + (st % kStages) * kStageBytes;
    if constexpr (MMA) {
      gemv_stage_mma(stage, xs + st * kStageRows, reinterpret_cast<float(*)[4]>(acc));
    } else {
      gemv_stage_cores<W>(stage, xs + st * kStageRows, acc);
    }
    __syncthreads();  // the slot is refilled by the next iteration
  }
  cp_async_wait<0>();

  // The block's partial columns into colsum[C] (shared memory; the ring
  // has drained).
  float* colsum = reinterpret_cast<float*>(smem);
  if constexpr (MMA) {
    const int lane = tid & 31;
    if ((lane & 3) == 0) {
      const int cb = 64 * (tid >> 5) + 8 * (lane >> 2);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        colsum[cb + 2 * i] = acc[4 * i];
        colsum[cb + 2 * i + 1] = acc[4 * i + 2];
      }
    }
    __syncthreads();
  } else {
    float* red = colsum + C;  // [kWarps][C]
    const int cx = tid & 31, ry = tid >> 5;
#pragma unroll
    for (int j = 0; j < V; j += 4)
      *reinterpret_cast<float4*>(red + ry * C + cx * V + j) =
          make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
    __syncthreads();
    for (int c = tid; c < C; c += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < kWarps; ++r) s += red[r * C + c];
      colsum[c] = s;
    }
    __syncthreads();
  }

  // Split-K: the last block of the tile to arrive finishes it.
  const bool single = a.ks == 1;
  if (!single) {
    for (int c = tid; c < C; c += kThreads)
      if (c0 + c < a.N) a.part[(size_t)split * a.N + c0 + c] = colsum[c];
    __threadfence();
    __syncthreads();
    if (tid == 0) is_last = atomicAdd(a.count + tile, 1u) == (unsigned)(a.ks - 1);
    __syncthreads();
    if (!is_last) return;
    __threadfence();
  }
  float ss = 0.f;
  for (int c = tid; c < C; c += kThreads) {
    const int col = c0 + c;
    if (col >= a.N) continue;
    float v = 0.f;
    if (single) {
      v = colsum[c];
    } else if (a.ks <= 8) {
      v = sum_splits<8>(a.part, a.N, a.ks, col);
    } else if (a.ks <= 16) {
      v = sum_splits<16>(a.part, a.N, a.ks, col);
    } else {
      v = sum_splits<kMaxSplit>(a.part, a.N, a.ks, col);
    }
    if (a.wscale != nullptr) v *= __ldg(a.wscale + col);
    if (OUT == kOutStore) {
      a.out[col] = v;
    } else {
      const float base = a.resid != nullptr ? __ldcg(a.resid + col) : to_f(a.resid_t[col]);
      float x = base + v;
      if (a.round_out) x = round_to<T>(x);
      if (a.out_t != nullptr) {
        store_f(a.out_t + col, x);
      } else {
        a.out[col] = x;
        ss += x * x;
      }
    }
  }
  if (OUT == kOutResid && a.out_t == nullptr) {
    const float t = block_sum(ss, red32);
    if (tid == 0) a.out_ss[tile] = t;
  }
  if (!single && tid == 0) a.count[tile] = 0u;
}

// ---- attention -----------------------------------------------------------

// C: the caches' type.  With kRound (a 16-bit cache under activations of
// another type: the kv_dtype override) attention takes the TPU kernel's
// `_attend_head` rounding points: q rounded to C before the scores
// (`decode_step.py:221`), the probabilities of the cache rows rounded to
// C before P.V (:230), both relative to the max over every visible row and
// the appended column; the appended column's score and value stay f32
// (:224, :230).  A 16-bit cache under activations of its own type takes
// the streamed layout's f32 attention (no rounding), and a float32 cache
// rounds nowhere.
template <typename C>
struct Attn {
  const float* qkv;  // [QD + 2 KVD] finished QKV row
  int NH, KVH, HD, M, pos, chunk;
  float scale;
  const float* cos_row;
  const float* sin_row;
  C* kc;             // this layer's caches [KVH][M][HD]
  C* vc;
  float* out;        // [QD] attention output
  float* part_ml;    // [KVH][S][G][2] split (max, sum)
  float* part_acc;   // [KVH][S][G][HD] split unnormalized P.V
  unsigned* count;   // [KVH] arrival counters, zero between uses
  float* part_max;   // kRound, S > 1: [KVH][S][G] split maxima of the max pass
};

// Attention of the G query heads of one KV head over one chunk of cache
// rows.  grid (KVH, S): block (kh, s) takes rows [s*chunk, min(pos,
// (s+1)*chunk)); split 0 also takes the appended column (this token's own
// k_rot, v_new) and writes them into row pos.  With S == 1 it writes the
// normalized output; otherwise its (max, sum, unnormalized P.V) partials,
// and the last split of the KV head to arrive merges them (P.V in split
// order).  kMaxPass (kRound with S > 1 only): the launch before, which
// scores the same rows and writes each split's per-head max, so that every
// split of the main launch rounds its probabilities against the same max,
// the TPU kernel's; the merge's weights are then all 1.
template <typename C, bool kRound, bool kMaxPass>
__global__ void __launch_bounds__(kThreads) decode_attn_kernel(const Attn<C> a) {
  extern __shared__ __align__(16) unsigned char smem_a[];
  const int kh = blockIdx.x, s = blockIdx.y, S = gridDim.y;
  const int G = a.NH / a.KVH, HD = a.HD;
  const int half = HD / 2;
  const int qd = a.NH * HD, kvd = a.KVH * HD;
  const int qs = HD + 1;               // padded query row: no bank conflicts
  const int cw = a.chunk + 1;          // score row: chunk rows + appended column
  const int rs = HD + 16 / (int)sizeof(C);  // staged row, padded by 16 bytes
  C* ks = reinterpret_cast<C*>(smem_a);                    // [chunk][rs] K rows
  C* vs = ks + (size_t)a.chunk * rs;                       // [chunk][rs] V rows
  float* qv = reinterpret_cast<float*>(vs + (size_t)a.chunk * rs);  // [G][HD+1] rotated queries
  float* kv = qv + G * qs;             // [HD] rotated new key
  float* vv = kv + HD;                 // [HD] new value
  float* red_m = vv + HD;              // [G] softmax max
  float* red_l = red_m + G;            // [G] softmax sum
  float* sc = red_l + G;               // [G][chunk+1] scores, then probabilities
  float* mw = sc + G * cw;             // merge: [G][S] split weights, [G] 1/sum
  float* qr = mw + G * (S + 1);        // kRound: [G][HD+1] queries rounded to C
  __shared__ int is_last;
  const int tid = threadIdx.x;
  C* krow = a.kc + (size_t)kh * a.M * HD;
  C* vrow = a.vc + (size_t)kh * a.M * HD;
  const int j0 = s * a.chunk;
  const int n = max(0, min(a.pos, j0 + a.chunk) - j0);  // cache rows of this split
  const int n_all = n + (s == 0 ? 1 : 0);               // + the appended column

  // Stage this split's cache rows (rows < pos: no kernel of this call
  // writes them) while the QKV GEMV still runs, in 8-byte pieces; the max
  // pass reads K only.
  constexpr int P = 8 / (int)sizeof(C);
  const int pieces = HD / P;
  for (int e = tid; e < n * pieces; e += kThreads) {
    const int r = e / pieces, u = (e - r * pieces) * P;
    cp_async8(ks + (size_t)r * rs + u, krow + (size_t)(j0 + r) * HD + u);
    if (!kMaxPass) cp_async8(vs + (size_t)r * rs + u, vrow + (size_t)(j0 + r) * HD + u);
  }
  cp_async_commit();
  grid_wait();

  for (int e = tid; e < G * half; e += kThreads) {  // split-halves RoPE
    const int g = e / half, j = e - g * half;
    const float c = a.cos_row[j], sn = a.sin_row[j];
    const int col = (kh * G + g) * HD + j;
    const float x1 = __ldcg(a.qkv + col), x2 = __ldcg(a.qkv + col + half);
    const float r1 = x1 * c - x2 * sn, r2 = x1 * sn + x2 * c;
    qv[g * qs + j] = r1;
    qv[g * qs + j + half] = r2;
    if (kRound) {
      qr[g * qs + j] = round_to<C>(r1);
      qr[g * qs + j + half] = round_to<C>(r2);
    }
  }
  for (int j = tid; j < half; j += kThreads) {
    const float c = a.cos_row[j], sn = a.sin_row[j];
    const float x1 = __ldcg(a.qkv + qd + kh * HD + j);
    const float x2 = __ldcg(a.qkv + qd + kh * HD + j + half);
    kv[j] = x1 * c - x2 * sn;
    kv[j + half] = x1 * sn + x2 * c;
  }
  for (int d = tid; d < HD; d += kThreads) vv[d] = __ldcg(a.qkv + qd + kvd + kh * HD + d);
  cp_async_wait<0>();
  __syncthreads();

  if (!kMaxPass && s == 0) {  // one writer per KV head; no block reads row pos
    for (int d = tid; d < HD; d += kThreads) {
      store_f(krow + (size_t)a.pos * HD + d, kv[d]);
      store_f(vrow + (size_t)a.pos * HD + d, vv[d]);
    }
  }

  // Scores: neighbouring threads take the G heads of one staged row.
  const float* qsrc = kRound ? qr : qv;
  for (int e = tid; e < G * n; e += kThreads) {
    const int g = e % G, r = e / G;
    const C* kr = ks + (size_t)r * rs;
    const float* q = qsrc + g * qs;
    float acc = 0.f;
#pragma unroll 4
    for (int i = 0; i < HD / 4; ++i) {
      const float4 kk = load4(kr + 4 * i);
      acc = fmaf(q[4 * i], kk.x, acc);
      acc = fmaf(q[4 * i + 1], kk.y, acc);
      acc = fmaf(q[4 * i + 2], kk.z, acc);
      acc = fmaf(q[4 * i + 3], kk.w, acc);
    }
    sc[g * cw + r] = acc * a.scale;
  }
  if (s == 0) {  // the appended column: the f32 query, never rounded
    for (int g = tid; g < G; g += kThreads) {
      float acc = 0.f;
      for (int d = 0; d < HD; ++d) acc = fmaf(qv[g * qs + d], kv[d], acc);
      sc[g * cw + n] = acc * a.scale;
    }
  }
  __syncthreads();

  // Softmax of each head's row, one warp per head.
  const int warp = tid >> 5, lane = tid & 31;
  if (kMaxPass) {
    for (int g = warp; g < G; g += kWarps) {
      float mx = -INFINITY;
      for (int r = lane; r < n_all; r += 32) mx = fmaxf(mx, sc[g * cw + r]);
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      if (lane == 0) a.part_max[((size_t)kh * S + s) * G + g] = mx;
    }
    grid_release();
    return;
  }
  for (int g = warp; g < G; g += kWarps) {
    float mx = -INFINITY;
    if (kRound && S > 1) {  // the max over every split, from the max pass
      for (int i = lane; i < S; i += 32)
        mx = fmaxf(mx, __ldcg(a.part_max + ((size_t)kh * S + i) * G + g));
    } else {
      for (int r = lane; r < n_all; r += 32) mx = fmaxf(mx, sc[g * cw + r]);
    }
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int r = lane; r < n_all; r += 32) {
      const float e = expf(sc[g * cw + r] - mx);
      sc[g * cw + r] = kRound && r < n ? round_to<C>(e) : e;  // the sum takes e unrounded
      sum += e;
    }
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      red_m[g] = mx;
      red_l[g] = sum;
    }
  }
  __syncthreads();

  // P.V: thread per (head, dim); neighbouring threads read neighbouring
  // dims of one V row.
  for (int o = tid; o < G * HD; o += kThreads) {
    const int g = o / HD, d = o - g * HD;
    const float* p = sc + g * cw;
    float acc = 0.f;
#pragma unroll 4
    for (int r = 0; r < n; ++r) acc = fmaf(p[r], to_f(vs[(size_t)r * rs + d]), acc);
    if (s == 0) acc = fmaf(p[n], vv[d], acc);
    if (S == 1) {
      a.out[(kh * G + g) * HD + d] = acc / red_l[g];
    } else {
      a.part_acc[((size_t)(kh * S + s) * G + g) * HD + d] = acc;
    }
  }
  grid_release();  // the cache rows are read
  if (S == 1) return;
  for (int g = tid; g < G; g += kThreads) {
    a.part_ml[((size_t)(kh * S + s) * G + g) * 2] = red_m[g];
    a.part_ml[((size_t)(kh * S + s) * G + g) * 2 + 1] = red_l[g];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(a.count + kh, 1u) == (unsigned)(S - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // The merge: rescale each split's sum and P.V to the common max (a warp
  // a head: the max, each split's weight, the sum in a fixed tree), then
  // P.V summed in split order.  Split 0 holds the appended column, so the
  // max is finite; an empty split has max -inf and weighs 0.
  const size_t base = (size_t)kh * S * G;  // (kh, s=0, g=0); stride G per split
  for (int g = warp; g < G; g += kWarps) {
    float mx = -INFINITY;
    for (int i = lane; i < S; i += 32)
      mx = fmaxf(mx, __ldcg(a.part_ml + (base + (size_t)i * G + g) * 2));
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float l = 0.f;
    for (int i = lane; i < S; i += 32) {
      const size_t b = (base + (size_t)i * G + g) * 2;
      const float wgt = expf(__ldcg(a.part_ml + b) - mx);
      mw[g * S + i] = wgt;
      l = fmaf(__ldcg(a.part_ml + b + 1), wgt, l);
    }
    for (int off = 16; off > 0; off >>= 1) l += __shfl_down_sync(0xffffffffu, l, off);
    if (lane == 0) mw[G * S + g] = l;
  }
  __syncthreads();
  for (int o = tid; o < G * HD; o += kThreads) {
    const int g = o / HD, d = o - g * HD;
    float acc = 0.f;
#pragma unroll 8
    for (int i = 0; i < S; ++i)
      acc = fmaf(__ldcg(a.part_acc + (base + (size_t)i * G + g) * HD + d), mw[g * S + i], acc);
    a.out[(kh * G + g) * HD + d] = acc / mw[G * S + g];
  }
  if (tid == 0) a.count[kh] = 0u;
}

// ---- host side -------------------------------------------------------------

int g_num_sms = 0;

int num_sms(int device) {
  if (g_num_sms == 0) {
    cudaDeviceGetAttribute(&g_num_sms, cudaDevAttrMultiProcessorCount, device);
    if (g_num_sms <= 0) g_num_sms = 132;
  }
  return g_num_sms;
}

// Launch `kernel` programmatically after the stream's previous kernel.
template <typename Arg>
cudaError_t launch(void (*kernel)(Arg), dim3 grid, size_t smem, cudaStream_t st,
                   const Arg& arg) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, arg);
}

// Let `kernel` take up to kMaxDynSmem of dynamic shared memory (once per
// kernel: the callers keep the result in a static).
template <typename Arg>
cudaError_t allow_smem(void (*kernel)(Arg)) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxDynSmem);
}

// Split K so that the column tiles times the splits give ~2 blocks per SM.
template <typename W>
void plan_gemv(int K, int N, int slots, int* rps, int* ks) {
  const int nb = (N + kCols<W> - 1) / kCols<W>;
  const int cap = (long)K * N * (long)sizeof(W) < kSmallGemvBytes ? kSmallSplit : kMaxSplit;
  const int most = std::max(1, std::min(cap, (K + kStageRows - 1) / kStageRows));
  int best = 1;
  double best_eff = -1.0;
  for (int s = 1; s <= most; ++s) {  // the fewest splits within 2 % of the best fill
    const int blocks = nb * s, waves = (blocks + slots - 1) / slots;
    if (waves > 4) break;
    const double eff = (double)blocks / ((double)waves * slots);
    if (eff > best_eff + 0.02) {
      best = s;
      best_eff = eff;
    }
  }
  *rps = (K + best - 1) / best;
  *ks = (K + *rps - 1) / *rps;
}

template <int IN, int OUT, typename W, typename T>
cudaError_t launch_gemv(Gemv<T> a, int sms, cudaStream_t st) {
  auto* kernel = decode_gemv_kernel<IN, OUT, W, T>;
  static const cudaError_t allowed = allow_smem(kernel);
  if (allowed != cudaSuccess) return allowed;
  // Blocks an SM holds (shared memory and registers), for a typical input
  // slice beside the ring.
  static int fit = 0;
  if (fit == 0) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &fit, kernel, kThreads, kRingBytes + 4096);
    if (err != cudaSuccess) return err;
    fit = std::max(fit, 1);
  }
  plan_gemv<W>(a.K, a.N, sms * fit, &a.rps, &a.ks);
  const int nb = (a.N + kCols<W> - 1) / kCols<W>;
  const int xs_rows = (a.rps + kStageRows - 1) / kStageRows * kStageRows;
  const size_t smem = kRingBytes + (size_t)xs_rows * sizeof(float);
  if (smem > (size_t)kMaxDynSmem) return cudaErrorInvalidValue;
  return launch(kernel, dim3(nb, a.ks), smem, st, a);
}

// Every layer of one token; W = float, int8_t (with the per-column scales
// s_* [NL][N]; null otherwise), bf16 or f16.  T: the type of the norms and
// x_in/x_out (float, bf16 or f16); C: the caches' (T, or another of the
// three: the kv_dtype override).
template <typename W, typename T, typename C>
int decode_layers(const W* wqkv, const W* wo, const W* wgu, const W* wdown,
                  const float* s_qkv, const float* s_o, const float* s_gu,
                  const float* s_dn, const T* attn_norm, const T* ffn_norm,
                  const T* x_in, T* x_out, C* k_cache, C* v_cache,
                  const float* cos_row, const float* sin_row, float* scratch,
                  unsigned* counters, int nl, int d, int nh, int kvh, int hd, int fd,
                  int m, int pos, float eps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaGetLastError();  // clear any stale error of this runtime
  const int qd = nh * hd, kvd = kvh * hd, qkvd = qd + 2 * kvd;
  if (hd % 4 != 0 || hd > 128 || kvh < 1 || nh % kvh != 0 || d % 4 != 0 ||
      fd % 2 != 0 || pos < 0 || pos >= m || nl < 1)
    return (int)cudaErrorInvalidValue;
  constexpr int V = kVec<W>;  // whole, aligned 16-byte vectors
  if (qkvd % V != 0 || d % V != 0 || (2 * fd) % V != 0)
    return (int)cudaErrorInvalidValue;
  constexpr int kRound = kAct16<T>;  // 16-bit: the layer's end rounds
  // A 16-bit cache under activations of another type: `_attend_head`'s
  // rounding points, and a max pass before a split attention.
  constexpr bool kRoundAttn = !std::is_same<T, C>::value && kAct16<C>;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sms = num_sms(device);

  const int wide = std::max(qkvd, std::max(d, 2 * fd));
  const int d_tiles = (d + kMinColsF - 1) / kMinColsF;
  float* x_store = scratch;          // [d] residual entering a layer (after layer 0)
  float* h_buf = x_store + d;        // [d] residual after attention
  float* qkv = h_buf + d;            // [qkvd]
  float* attn = qkv + qkvd;          // [qd]
  float* gu = attn + qd;             // [2fd]
  float* ss_attn = gu + 2 * fd;      // [d_tiles] sums of squares of h_buf
  float* ss_ffn = ss_attn + d_tiles; // [d_tiles] sums of squares of x_store
  float* part = ss_ffn + d_tiles;    // [kMaxSplit][wide]
  float* at_ml = part + (size_t)kMaxSplit * wide;          // [KVH][S][G][2]
  float* at_acc = at_ml + (size_t)kAttnMaxSplit * nh * 2;  // [KVH][S][G][hd]
  float* at_max = at_acc + (size_t)kAttnMaxSplit * nh * hd; // [KVH][S][G]
  unsigned* count = counters;                                  // [GEMV tiles at most]
  unsigned* at_count = count + (wide + kMinColsF - 1) / kMinColsF;  // [kvh]

  // Attention splits: ~2 blocks per SM over (KV head, position chunk), each
  // chunk at least kAttnMinRows rows; short caches take one split.
  // More splits where a chunk's staged K and V rows would pass
  // kAttnStageBytes (long caches).
  const int G = nh / kvh;
  const int row_bytes = hd * (int)sizeof(C) + 16;
  const int stage_rows = kAttnStageBytes / (2 * row_bytes);
  int S = (pos + kAttnMinRows - 1) / kAttnMinRows;
  S = std::min(S, (2 * sms + kvh - 1) / kvh);
  S = std::max(S, (pos + stage_rows - 1) / stage_rows);
  S = std::max(1, std::min(S, kAttnMaxSplit));
  const int chunk = S == 1 ? pos : (pos + S - 1) / S;
  const size_t attn_smem =
      2 * (size_t)chunk * row_bytes +
      (size_t)(G * (hd + 1) + 2 * hd + 2 * G + G * (chunk + 1) + G * (S + 1) +
               (kRoundAttn ? G * (hd + 1) : 0)) * sizeof(float);
  auto* attn_kernel = decode_attn_kernel<C, kRoundAttn, false>;
  static const cudaError_t attn_allowed = allow_smem(attn_kernel);
  if (attn_allowed != cudaSuccess) return (int)attn_allowed;
  if constexpr (kRoundAttn) {
    static const cudaError_t max_allowed = allow_smem(decode_attn_kernel<C, true, true>);
    if (max_allowed != cudaSuccess) return (int)max_allowed;
  }
  if (attn_smem > (size_t)kMaxDynSmem) return (int)cudaErrorInvalidValue;
  auto layer_scale = [](const float* s, int l, int n) {
    return s == nullptr ? nullptr : s + (size_t)l * n;
  };
  const int n_ss = (d + kCols<W> - 1) / kCols<W>;  // tiles of a D-wide GEMV

  for (int l = 0; l < nl; ++l) {
    const bool first = l == 0, last = l == nl - 1;
    Gemv<T> g = {};
    g.part = part;
    g.count = count;
    g.eps = eps;
    // 1. QKV of rmsnorm(x): x_in for layer 0, else the previous layer's
    //    residual (rounded to T in 16-bit modes, as the TPU kernel's x_out).
    g.w = wqkv + (size_t)l * d * qkvd;
    g.wscale = layer_scale(s_qkv, l, qkvd);
    g.K = d;
    g.N = qkvd;
    g.vec = first ? nullptr : x_store;
    g.x_t = x_in;
    g.ss = first ? nullptr : ss_ffn;
    g.n_ss = n_ss;
    g.norm_w = attn_norm + (size_t)l * d;
    g.out = qkv;
    if ((err = launch_gemv<kInNorm, kOutStore, W>(g, sms, st)) != cudaSuccess) return (int)err;
    // 2. Attention, the merge in its last split (after the max pass where
    //    a split attention rounds its probabilities).
    Attn<C> at = {qkv, nh, kvh, hd, m, pos, chunk,
                  (float)(1.0 / sqrt((double)hd)), cos_row, sin_row,
                  k_cache + (size_t)l * kvh * m * hd, v_cache + (size_t)l * kvh * m * hd,
                  attn, at_ml, at_acc, at_count, at_max};
    if constexpr (kRoundAttn) {
      if (S > 1 && (err = launch(decode_attn_kernel<C, true, true>, dim3(kvh, S), attn_smem,
                                 st, at)) != cudaSuccess)
        return (int)err;
    }
    if ((err = launch(attn_kernel, dim3(kvh, S), attn_smem, st, at)) != cudaSuccess)
      return (int)err;
    // 3. h = x + attn @ wo, and h's per-tile sums of squares.
    g = Gemv<T>{};
    g.part = part;
    g.count = count;
    g.w = wo + (size_t)l * qd * d;
    g.wscale = layer_scale(s_o, l, d);
    g.K = qd;
    g.N = d;
    g.vec = attn;
    g.out = h_buf;
    g.resid = first ? nullptr : x_store;
    g.resid_t = x_in;
    g.out_ss = ss_attn;
    if ((err = launch_gemv<kInVec, kOutResid, W>(g, sms, st)) != cudaSuccess) return (int)err;
    // 4. [gate | up] of rmsnorm(h), the gate/up scale in place.
    g = Gemv<T>{};
    g.part = part;
    g.count = count;
    g.eps = eps;
    g.w = wgu + (size_t)l * d * 2 * fd;
    g.wscale = layer_scale(s_gu, l, 2 * fd);
    g.K = d;
    g.N = 2 * fd;
    g.vec = h_buf;
    g.ss = ss_attn;
    g.n_ss = n_ss;
    g.norm_w = ffn_norm + (size_t)l * d;
    g.out = gu;
    if ((err = launch_gemv<kInNorm, kOutStore, W>(g, sms, st)) != cudaSuccess) return (int)err;
    // 5. x = h + (silu(gate) * up) @ w_down, rounded at a 16-bit layer's end;
    //    the last layer writes x_out.
    g = Gemv<T>{};
    g.part = part;
    g.count = count;
    g.w = wdown + (size_t)l * fd * d;
    g.wscale = layer_scale(s_dn, l, d);
    g.K = fd;
    g.N = d;
    g.vec = gu;
    g.out = x_store;
    g.resid = h_buf;
    g.round_out = kRound;
    g.out_ss = ss_ffn;
    g.out_t = last ? x_out : nullptr;
    if ((err = launch_gemv<kInSwiglu, kOutResid, W>(g, sms, st)) != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of scratch the C entries below need for these widths.
extern "C" long l3t_decode_scratch_floats(int d, int nh, int kvh, int hd, int fd) {
  const long qd = (long)nh * hd, qkvd = qd + 2L * kvh * hd;
  const long wide = std::max(qkvd, std::max((long)d, 2L * fd));
  const long d_tiles = (d + kMinColsF - 1) / kMinColsF;
  return 2L * d + qkvd + qd + 2L * fd + 2L * d_tiles + kMaxSplit * wide +
         (long)kAttnMaxSplit * nh * (hd + 3);
}

// Arrival counters the C entries below need for these widths.  They must
// be zero before the first call; every call leaves them zero (each tile's
// and KV head's last block resets its own), so the caller keeps one
// buffer, zeroed once, for the calls of one stream.
extern "C" long l3t_decode_counters(int d, int nh, int kvh, int hd, int fd) {
  const long qkvd = (long)nh * hd + 2L * kvh * hd;
  const long wide = std::max(qkvd, std::max((long)d, 2L * fd));
  return (wide + kMinColsF - 1) / kMinColsF + kvh;
}

extern "C" int l3t_decode_layers_f32(
    const float* wqkv, const float* wo, const float* wgu, const float* wdown,
    const float* attn_norm, const float* ffn_norm, const float* x_in,
    float* x_out, float* k_cache, float* v_cache, const float* cos_row,
    const float* sin_row, float* scratch, unsigned* counters, int nl, int d,
    int nh, int kvh, int hd, int fd, int m, int pos, float eps, int device,
    void* stream) {
  return decode_layers<float, float>(wqkv, wo, wgu, wdown, nullptr, nullptr, nullptr,
                                     nullptr, attn_norm, ffn_norm, x_in, x_out, k_cache,
                                     v_cache, cos_row, sin_row, scratch, counters, nl, d,
                                     nh, kvh, hd, fd, m, pos, eps, device, stream);
}

// int8 weights ([in, out] row-major like the float ones) with their
// per-output-column f32 scales [NL][out]; float32 activations.
extern "C" int l3t_decode_layers_i8(
    const int8_t* wqkv, const int8_t* wo, const int8_t* wgu,
    const int8_t* wdown, const float* s_qkv, const float* s_o,
    const float* s_gu, const float* s_dn, const float* attn_norm,
    const float* ffn_norm, const float* x_in, float* x_out, float* k_cache,
    float* v_cache, const float* cos_row, const float* sin_row,
    float* scratch, unsigned* counters, int nl, int d, int nh, int kvh, int hd,
    int fd, int m, int pos, float eps, int device, void* stream) {
  return decode_layers<int8_t, float>(wqkv, wo, wgu, wdown, s_qkv, s_o, s_gu, s_dn,
                                      attn_norm, ffn_norm, x_in, x_out, k_cache, v_cache,
                                      cos_row, sin_row, scratch, counters, nl, d, nh, kvh,
                                      hd, fd, m, pos, eps, device, stream);
}

// int8 weights with their f32 scales under bf16 activations: bf16 norms,
// x_in/x_out and caches (the streamed TPU layout's 8B int8 mode).
extern "C" int l3t_decode_layers_i8_bf16(
    const int8_t* wqkv, const int8_t* wo, const int8_t* wgu,
    const int8_t* wdown, const float* s_qkv, const float* s_o,
    const float* s_gu, const float* s_dn, const bf16* attn_norm,
    const bf16* ffn_norm, const bf16* x_in, bf16* x_out, bf16* k_cache,
    bf16* v_cache, const float* cos_row, const float* sin_row,
    float* scratch, unsigned* counters, int nl, int d, int nh, int kvh, int hd,
    int fd, int m, int pos, float eps, int device, void* stream) {
  return decode_layers<int8_t, bf16>(wqkv, wo, wgu, wdown, s_qkv, s_o, s_gu, s_dn,
                                     attn_norm, ffn_norm, x_in, x_out, k_cache, v_cache,
                                     cos_row, sin_row, scratch, counters, nl, d, nh, kvh,
                                     hd, fd, m, pos, eps, device, stream);
}

// bf16 weights ([in, out] row-major), norms, x_in/x_out and caches; cos/sin
// rows and scratch f32.  Otherwise as l3t_decode_layers_f32.
extern "C" int l3t_decode_layers_bf16(
    const bf16* wqkv, const bf16* wo, const bf16* wgu, const bf16* wdown,
    const bf16* attn_norm, const bf16* ffn_norm, const bf16* x_in, bf16* x_out,
    bf16* k_cache, bf16* v_cache, const float* cos_row, const float* sin_row,
    float* scratch, unsigned* counters, int nl, int d, int nh, int kvh, int hd,
    int fd, int m, int pos, float eps, int device, void* stream) {
  return decode_layers<bf16, bf16>(wqkv, wo, wgu, wdown, nullptr, nullptr, nullptr,
                                   nullptr, attn_norm, ffn_norm, x_in, x_out, k_cache,
                                   v_cache, cos_row, sin_row, scratch, counters, nl, d, nh,
                                   kvh, hd, fd, m, pos, eps, device, stream);
}

// int8 weights with their f32 scales under float16 activations: float16
// norms, x_in/x_out and caches; the int8 products take the activation
// rounded to bf16, as the int8/bf16 mode's.
extern "C" int l3t_decode_layers_i8_f16(
    const int8_t* wqkv, const int8_t* wo, const int8_t* wgu,
    const int8_t* wdown, const float* s_qkv, const float* s_o,
    const float* s_gu, const float* s_dn, const f16* attn_norm,
    const f16* ffn_norm, const f16* x_in, f16* x_out, f16* k_cache,
    f16* v_cache, const float* cos_row, const float* sin_row,
    float* scratch, unsigned* counters, int nl, int d, int nh, int kvh, int hd,
    int fd, int m, int pos, float eps, int device, void* stream) {
  return decode_layers<int8_t, f16>(wqkv, wo, wgu, wdown, s_qkv, s_o, s_gu, s_dn,
                                    attn_norm, ffn_norm, x_in, x_out, k_cache, v_cache,
                                    cos_row, sin_row, scratch, counters, nl, d, nh, kvh,
                                    hd, fd, m, pos, eps, device, stream);
}

// float16 weights, norms, x_in/x_out and caches.  Otherwise as
// l3t_decode_layers_bf16.
extern "C" int l3t_decode_layers_f16(
    const f16* wqkv, const f16* wo, const f16* wgu, const f16* wdown,
    const f16* attn_norm, const f16* ffn_norm, const f16* x_in, f16* x_out,
    f16* k_cache, f16* v_cache, const float* cos_row, const float* sin_row,
    float* scratch, unsigned* counters, int nl, int d, int nh, int kvh, int hd,
    int fd, int m, int pos, float eps, int device, void* stream) {
  return decode_layers<f16, f16>(wqkv, wo, wgu, wdown, nullptr, nullptr, nullptr,
                                 nullptr, attn_norm, ffn_norm, x_in, x_out, k_cache,
                                 v_cache, cos_row, sin_row, scratch, counters, nl, d, nh,
                                 kvh, hd, fd, m, pos, eps, device, stream);
}

// The kv_dtype override: caches of type C under activations (norms,
// x_in/x_out) of another type T, float weights of type T.  Otherwise as the
// entry of T's mode; attention takes `_attend_head`'s rounding points where
// C is 16-bit (see Attn).
#define L3T_DECODE_FLOAT_KV(NAME, T, C)                                               \
  extern "C" int NAME(const T* wqkv, const T* wo, const T* wgu, const T* wdown,       \
                      const T* attn_norm, const T* ffn_norm, const T* x_in, T* x_out, \
                      C* k_cache, C* v_cache, const float* cos_row,                   \
                      const float* sin_row, float* scratch, unsigned* counters,       \
                      int nl, int d, int nh, int kvh, int hd, int fd, int m, int pos, \
                      float eps, int device, void* stream) {                          \
    return decode_layers<T, T, C>(wqkv, wo, wgu, wdown, nullptr, nullptr, nullptr,    \
                                  nullptr, attn_norm, ffn_norm, x_in, x_out, k_cache, \
                                  v_cache, cos_row, sin_row, scratch, counters, nl,  \
                                  d, nh, kvh, hd, fd, m, pos, eps, device, stream);   \
  }
L3T_DECODE_FLOAT_KV(l3t_decode_layers_f32_kv_bf16, float, bf16)
L3T_DECODE_FLOAT_KV(l3t_decode_layers_f32_kv_f16, float, f16)
L3T_DECODE_FLOAT_KV(l3t_decode_layers_bf16_kv_f32, bf16, float)
L3T_DECODE_FLOAT_KV(l3t_decode_layers_bf16_kv_f16, bf16, f16)
L3T_DECODE_FLOAT_KV(l3t_decode_layers_f16_kv_f32, f16, float)
L3T_DECODE_FLOAT_KV(l3t_decode_layers_f16_kv_bf16, f16, bf16)

// The kv_dtype override under int8 weights with their f32 scales: caches
// of type C under activations of another type T.  Otherwise as the int8
// entry of T's mode.
#define L3T_DECODE_I8_KV(NAME, T, C)                                                  \
  extern "C" int NAME(const int8_t* wqkv, const int8_t* wo, const int8_t* wgu,        \
                      const int8_t* wdown, const float* s_qkv, const float* s_o,      \
                      const float* s_gu, const float* s_dn, const T* attn_norm,       \
                      const T* ffn_norm, const T* x_in, T* x_out, C* k_cache,         \
                      C* v_cache, const float* cos_row, const float* sin_row,         \
                      float* scratch, unsigned* counters, int nl, int d, int nh,      \
                      int kvh, int hd, int fd, int m, int pos, float eps, int device, \
                      void* stream) {                                                 \
    return decode_layers<int8_t, T, C>(wqkv, wo, wgu, wdown, s_qkv, s_o, s_gu, s_dn,  \
                                       attn_norm, ffn_norm, x_in, x_out, k_cache,     \
                                       v_cache, cos_row, sin_row, scratch, counters,  \
                                       nl, d, nh, kvh, hd, fd, m, pos, eps, device,   \
                                       stream);                                       \
  }
L3T_DECODE_I8_KV(l3t_decode_layers_i8_kv_bf16, float, bf16)
L3T_DECODE_I8_KV(l3t_decode_layers_i8_kv_f16, float, f16)
L3T_DECODE_I8_KV(l3t_decode_layers_i8_bf16_kv_f32, bf16, float)
L3T_DECODE_I8_KV(l3t_decode_layers_i8_bf16_kv_f16, bf16, f16)
L3T_DECODE_I8_KV(l3t_decode_layers_i8_f16_kv_f32, f16, float)
L3T_DECODE_I8_KV(l3t_decode_layers_i8_f16_kv_bf16, f16, bf16)
