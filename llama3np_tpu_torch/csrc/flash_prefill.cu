// Flash prefill attention for Hopper (sm_90a), float32, bf16 or float16.
//
// Replaces: llama3np_tpu/ops/kernels/flash_prefill.py, `flash_prefill` (body
// `_kernel`, pallas_call at :102).  Causal GQA self-attention for the
// start_pos == 0 prefill: q [B,L,NH,HD], k/v [B,L,KVH,HD] -> o [B,L,NH,HD],
// online softmax in f32, key tiles above the diagonal never touched.  The
// TPU kernel walks a sequential (q-block, kv-block) grid with VMEM scratch
// carrying (m, l, acc) across kv steps; here a block owns one (batch, query
// head, query tile) and loops over the key tiles up to the tile's last row
// itself, so the carry lives in registers.  The GQA map is h / (NH / KVH),
// as in the TPU kernel's index map (:109); k/v are read as they lie in
// [B,L,KVH,HD] (no transposes in device memory).
//
// What bounds it on the H100.  The work is 4*NH*HD*L(L+1)/2 FLOPs against
// (2*NH + 2*KVH)*L*HD elements of traffic.  float32 (tinyllama widths,
// L=512): ~1.08 GFLOP a layer, ~16 us at the 67 TFLOP/s fp32 CUDA-core
// peak, against ~0.7 MB: operations.  bf16 (llama3-8b widths, L=512):
// 2.15 GFLOP (2.2 us at the 989 TFLOP/s bf16 tensor-core peak) against
// 10.5 MB (3.1 us): bytes, at the published peaks; in practice the longest
// query tile's chain of tensor-core products and softmax steps sets the
// time, since L=512 gives one wave of blocks on 132 SMs.
//
// float32 mode (CUDA cores; TF32 tensor cores would break the fp32 parity
// gate).  One block of 256 threads owns 64 query rows; it is the
// register-tiled form of a CUDA-core GEMM:
//  * Q (once) and each K tile are staged in shared memory transposed
//    ([HD][64], read as float4), V as it lies ([64][HD]);
//  * thread (ty, tx) of a 16 x 16 grid owns query rows 4ty..4ty+3: it
//    computes their scores against keys 4tx..4tx+3 (16 FMAs per two float4
//    loads), and their outputs at head dims tx, tx+16, ... (HD need not be
//    a power of two: HD=48 takes three dims a thread, a tail is masked);
//  * a row's max and sum cross its 16 threads by xor-shuffles inside a
//    half-warp; masked scores (key > row, or key >= L) contribute an
//    explicit 0, never exp(0); the probabilities go through shared memory
//    for P.V;
//  * rows past L (the ragged tail of the last tile) compute on zeros and
//    are never stored; the padded prompt tail (>= true_len) is computed like
//    any row and never read by the caller.
//
// bf16 mode (tensor cores).  The TPU kernel's semantics (:46-73): q, k and
// v widened to f32, QK^T and P.V as f32 products with f32 sums, masked
// entries an explicit 0, the normalizer clamped at 1e-30, the output
// rounded to bf16 once.  On the tensor cores (mma.sync.m16n8k16, bf16
// operands, f32 accumulators):
//  * QK^T needs no new envelope: a product of two bf16 values is exact in
//    f32, so the MMA computes what the widened f32 dot computes, up to
//    summation order;
//  * P stays f32 (the softmax runs on the f32 accumulators) and enters P.V
//    split: P_hi = bf16(P), P_lo = bf16(P - P_hi), acc += P_hi.V + P_lo.V
//    (two MMAs on the same V fragment).  P_hi + P_lo is P within 2^-16
//    relative, far inside one bf16 ulp (2^-8) of the output; P is never
//    rounded to bf16 once, a rounding the TPU kernel does not make.  The
//    normalizer sums the f32 P;
//  * a block of 4 warps owns 64 query rows, one warp per 16 rows
//    (FA2-style: the scores, the running max and sum and the output
//    accumulator of a row stay in its warp's registers); Q stays in shared
//    memory and is re-read with ldmatrix for every key tile;
//  * 64-key K/V tiles flow through a 2-stage shared-memory ring fed by
//    cp.async (16-byte copies when HD % 8 == 0, else 4-byte ones), so the
//    next tile is in flight while one is multiplied; K is read with
//    ldmatrix as the B operand of QK^T, V with ldmatrix.trans as the B
//    operand of P.V; rows are padded to an odd number of 16-byte chunks, so
//    the ldmatrix row reads fall in distinct banks;
//  * tiles stay bf16 in shared memory (no f32 staging: 85 KB at HD=128, so
//    two blocks share an SM: at L=512, 256 blocks of 1-8 key tiles, the
//    long ones beside short ones; 128-row blocks with a 3-stage ring, one
//    an SM, measured 8 % slower: PERF.md);
//    any HD <= 128 (even) is zero-padded in shared memory to a multiple of
//    16 (zero columns add nothing to QK^T and are not stored); rows past L
//    are zero-filled by the copies (src-size 0), so a masked P = 0 never
//    meets a non-finite V;
//  * a warp skips the key tiles that lie wholly above its rows; the grid
//    puts the query tile last and reversed, so the longest (last) tiles of
//    every head launch first.
// float16 mode: the bf16 mode's kernel with float16 operands
// (mma.sync...f16.f16.f32) and a float16 output.  A product of two float16
// values is exact in f32 too.  P's split P_hi = f16(P), P_lo = f16(P -
// P_hi) keeps P within 2^-22 relative while P_lo is normal; for P_lo below
// 2^-14 (subnormal) the error is under 2^-25 absolute a probability, so a
// row's P.V moves by at most L * 2^-25 * max|v| before its normalizer
// (>= 1): under 2^-16 of max|v| at L=512, inside the output's one float16
// rounding (2^-11).
// mma.sync was taken over wgmma: its fragments are documented per thread,
// so the kernel could be written and checked without a compiler at hand;
// wgmma's shared-memory descriptors and the warp-specialised TMA producer
// are queued (ROADMAP D3).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <type_traits>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
typedef __half f16;

// ---- float32 mode: CUDA cores --------------------------------------------

constexpr int kThreads = 256;  // 16 x 16
constexpr int kTile = 64;      // query rows and keys per tile
constexpr int kPad = kTile + 4;  // transposed row stride (keeps float4 alignment)
constexpr float kNegInf = -1e30f;

template <int DT>  // head dims per thread: HD <= 16 * DT
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int L, int NH, int KVH, int HD, float scale) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [HD][kPad] queries, transposed
  float* Kt = Qt + HD * kPad;                   // [HD][kPad] keys, transposed
  float* Vs = Kt + HD * kPad;                   // [kTile][HD] values
  float* Pt = Vs + kTile * HD;                  // [kTile][kPad] probs, key-major

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
  const int kvh = h / (NH / KVH);
  const size_t q_stride = (size_t)NH * HD, kv_stride = (size_t)KVH * HD;
  const float* qb = q + (size_t)b * L * q_stride + (size_t)h * HD;
  const float* kb = k + (size_t)b * L * kv_stride + (size_t)kvh * HD;
  const float* vb = v + (size_t)b * L * kv_stride + (size_t)kvh * HD;

  for (int e = tid; e < kTile * HD; e += kThreads) {
    const int r = e / HD, d = e - r * HD;
    Qt[d * kPad + r] = q0 + r < L ? qb[(size_t)(q0 + r) * q_stride + d] : 0.f;
  }

  float m[4], l[4], acc[4][DT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DT; ++j) acc[i][j] = 0.f;
  }

  const int n_keys = min(q0 + kTile, L);  // keys visible to some row of the tile
  for (int t0 = 0; t0 < n_keys; t0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and Qt is written)
    for (int e = tid; e < kTile * HD; e += kThreads) {
      const int r = e / HD, d = e - r * HD;
      const bool ok = t0 + r < L;
      Kt[d * kPad + r] = ok ? kb[(size_t)(t0 + r) * kv_stride + d] : 0.f;
      Vs[r * HD + d] = ok ? vb[(size_t)(t0 + r) * kv_stride + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < HD; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(Qt + d * kPad + 4 * ty);
      const float4 ka = *reinterpret_cast<const float4*>(Kt + d * kPad + 4 * tx);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = t0 + 4 * tx + j;
        s[i][j] = (key <= row && key < L) ? s[i][j] * scale : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = t0 + 4 * tx + j;
        s[i][j] = (key <= row && key < L) ? expf(s[i][j] - m_new) : 0.f;
        psum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * alpha + psum;
#pragma unroll
      for (int j = 0; j < DT; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Pt + (4 * tx + j) * kPad + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    const int nk = min(kTile, n_keys - t0);
    for (int c = 0; c < nk; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(Pt + c * kPad + 4 * ty);
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        const int d = tx + 16 * j;
        const float vv = d < HD ? Vs[c * HD + d] : 0.f;
        acc[0][j] = fmaf(p.x, vv, acc[0][j]);
        acc[1][j] = fmaf(p.y, vv, acc[1][j]);
        acc[2][j] = fmaf(p.z, vv, acc[2][j]);
        acc[3][j] = fmaf(p.w, vv, acc[3][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= L) continue;
    float* op = o + ((size_t)b * L + row) * q_stride + (size_t)h * HD;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int d = tx + 16 * j;
      if (d < HD) op[d] = acc[i][j] / den;
    }
  }
}

template <int DT>
cudaError_t launch_f32(const float* q, const float* k, const float* v, float* o,
                       int B, int L, int NH, int KVH, int HD, cudaStream_t st) {
  const size_t smem = ((size_t)2 * HD * kPad + (size_t)kTile * HD +
                       (size_t)kTile * kPad) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_kernel<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const float scale = (float)(1.0 / sqrt((double)HD));
  dim3 grid((L + kTile - 1) / kTile, NH, B);
  flash_prefill_kernel<DT><<<grid, kThreads, smem, st>>>(q, k, v, o, L, NH, KVH, HD, scale);
  return cudaGetLastError();
}

// ---- bf16 and float16 modes: tensor cores ---------------------------------

constexpr int kBr = 64;       // query rows a block, 16 a warp
constexpr int kBc = 64;       // keys a tile
constexpr int kStages = 2;    // K/V tiles in the ring
constexpr int kBThreads = kBr * 2;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous global -> shared copies; `ok` false writes zeros (src-size 0).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// d += a . b: one m16n8k16 product, bf16 or float16 (T) operands, f32
// accumulators (not volatile: the compiler may interleave independent
// products).
template <typename T>
__device__ __forceinline__ void mma16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, f16>::value)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values as one 4-byte pair of T (the lower column first).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float p0, float p1) {
  if constexpr (std::is_same<T, f16>::value) {
    const __half2 h = __floats2half2_rn(p0, p1);
    return *reinterpret_cast<const uint32_t*>(&h);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
}
__device__ __forceinline__ float low_f(uint32_t w, bf16) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float high_f(uint32_t w, bf16) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ float low_f(uint32_t w, f16) {
  return __half2float(__ushort_as_half((unsigned short)(w & 0xffffu)));
}
__device__ __forceinline__ float high_f(uint32_t w, f16) {
  return __half2float(__ushort_as_half((unsigned short)(w >> 16)));
}

// Two f32 probabilities (lower column first) as the hi and lo pairs of T of
// an A fragment register: hi = T(p), lo = T(p - hi).
template <typename T>
__device__ __forceinline__ void split_pair(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  hi = pack2<T>(p0, p1);
  lo = pack2<T>(p0 - low_f(hi, T()), p1 - high_f(hi, T()));
}

// T: bf16 or f16; HDP: head dim padded to a multiple of 16; V16: 16-byte
// copies (HD % 8 == 0), else 4-byte ones (HD even).
template <typename T, int HDP, bool V16>
__global__ void __launch_bounds__(kBThreads, 1)
flash_prefill_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        int L, int NH, int KVH, int HD, float scale_log2) {
  constexpr int kRow = HDP + 8;  // row stride: an odd number of 16-byte chunks
  constexpr int kVec = V16 ? 8 : 2;  // elements a copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [kBr][kRow]
  T* Ks = Qs + kBr * kRow;                     // [kStages][kBc][kRow]
  T* Vs = Ks + kStages * kBc * kRow;           // [kStages][kBc][kRow]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBr;  // the last query tiles first
  const int kvh = h / (NH / KVH);
  const size_t q_stride = (size_t)NH * HD, kv_stride = (size_t)KVH * HD;
  const T* qb = q + (size_t)b * L * q_stride + (size_t)h * HD;
  const T* kb = k + (size_t)b * L * kv_stride + (size_t)kvh * HD;
  const T* vb = v + (size_t)b * L * kv_stride + (size_t)kvh * HD;

  // Zero the pad columns [HD, HDP) of every staged row (Q and the ring are
  // one array of rows); the copies never write them.
  if (HD < HDP) {
    const int pad = HDP - HD;
    for (int e = tid; e < (kBr + 2 * kStages * kBc) * pad; e += kBThreads) {
      const int r = e / pad;
      reinterpret_cast<unsigned short*>(Qs)[r * kRow + HD + (e - r * pad)] = 0;
    }
  }
  // Rows r0.. of [.., HD] at `stride` into `dst`; rows >= L as zeros.
  auto stage = [&](T* dst, const T* src, size_t stride, int r0, int rows) {
    const int per_row = HD / kVec;
    for (int e = tid; e < rows * per_row; e += kBThreads) {
      const int r = e / per_row, c = (e - r * per_row) * kVec;
      const bool ok = r0 + r < L;
      const T* s = src + (size_t)(ok ? r0 + r : 0) * stride + c;
      if constexpr (V16) cp_async16(smem_u32(dst + r * kRow + c), s, ok);
      else cp_async4(smem_u32(dst + r * kRow + c), s, ok);
    }
  };

  const int n_tiles = (min(q0 + kBr, L) + kBc - 1) / kBc;
  stage(Qs, qb, q_stride, q0, kBr);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) {
      stage(Ks + t * kBc * kRow, kb, kv_stride, t * kBc, kBc);
      stage(Vs + t * kBc * kRow, vb, kv_stride, t * kBc, kBc);
    }
    cp_async_commit();  // Q rides in the first group
  }

  const int row0 = q0 + warp * 16;  // this warp's first query row
  const int g = lane >> 2, tig = lane & 3;
  // ldmatrix addressing: lane l gives row l % 8 of 8x8 matrix l / 8.
  const int lr = lane & 7, lm = lane >> 3;
  const uint32_t q_addr =
      smem_u32(Qs + (warp * 16 + (lm & 1) * 8 + lr) * kRow + (lm >> 1) * 8);
  const int k_off = ((lm >> 1) * 8 + lr) * kRow + (lm & 1) * 8;  // two key n-tiles
  const int v_off = ((lm & 1) * 8 + lr) * kRow + (lm >> 1) * 8;  // two dim n-tiles

  float acc[HDP / 8][4];
#pragma unroll
  for (int n = 0; n < HDP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};  // rows g, g + 8

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();  // tile `it` has landed (this thread's copies)
    __syncthreads();               // ... every thread's; stage it-1 is consumed
    {
      const int nt = it + kStages - 1;
      if (nt < n_tiles) {
        const int s = nt % kStages;
        stage(Ks + s * kBc * kRow, kb, kv_stride, nt * kBc, kBc);
        stage(Vs + s * kBc * kRow, vb, kv_stride, nt * kBc, kBc);
      }
      cp_async_commit();
    }
    const int t0 = it * kBc;
    if (t0 > row0 + 15) continue;  // every key of the tile lies above this warp's rows
    const T* Kt = Ks + (it % kStages) * kBc * kRow;
    const T* Vt = Vs + (it % kStages) * kBc * kRow;

    // S = Q K^T: 16 rows x 64 keys a warp.
    float s[kBc / 8][4];
#pragma unroll
    for (int n = 0; n < kBc / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, q_addr + kk * 32);
#pragma unroll
      for (int n = 0; n < kBc / 8; n += 2) {
        uint32_t bb[4];
        ldmatrix_x4(bb, smem_u32(Kt + n * 8 * kRow + k_off + kk * 16));
        mma16<T>(s[n], a, bb[0], bb[1]);
        mma16<T>(s[n + 1], a, bb[2], bb[3]);
      }
    }

    // Online softmax on the accumulators, in the log2 domain: element e of
    // n-tile n is row row0 + g + 8 * (e / 2), key t0 + 8n + 2 tig + e % 2.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kBc / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + g + (e >> 1) * 8, key = t0 + n * 8 + 2 * tig + (e & 1);
        s[n][e] = (key <= row && key < L) ? s[n][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      alpha[i] = m_new == -INFINITY ? 1.f : exp2f(m_run[i] - m_new);
      m_run[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < kBc / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + g + (e >> 1) * 8, key = t0 + n * 8 + 2 * tig + (e & 1);
        s[n][e] = (key <= row && key < L) ? exp2f(s[n][e] - m_run[e >> 1]) : 0.f;
        psum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + psum[i];  // this thread's keys
#pragma unroll
    for (int n = 0; n < HDP / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += P_hi V + P_lo V, 16 keys a step; the score fragments of key
    // n-tiles 2j and 2j+1 are the A fragment of step j.
#pragma unroll
    for (int j = 0; j < kBc / 16; ++j) {
      uint32_t ph[4], pl[4];
      split_pair<T>(s[2 * j][0], s[2 * j][1], ph[0], pl[0]);
      split_pair<T>(s[2 * j][2], s[2 * j][3], ph[1], pl[1]);
      split_pair<T>(s[2 * j + 1][0], s[2 * j + 1][1], ph[2], pl[2]);
      split_pair<T>(s[2 * j + 1][2], s[2 * j + 1][3], ph[3], pl[3]);
      uint32_t vb[HDP / 8][2];  // the V fragments of the step, for hi then lo
#pragma unroll
      for (int n = 0; n < HDP / 8; n += 2)
        ldmatrix_x4_trans(&vb[n][0], smem_u32(Vt + j * 16 * kRow + v_off + n * 8));
#pragma unroll
      for (int n = 0; n < HDP / 8; ++n) mma16<T>(acc[n], ph, vb[n][0], vb[n][1]);
#pragma unroll
      for (int n = 0; n < HDP / 8; ++n) mma16<T>(acc[n], pl, vb[n][0], vb[n][1]);
    }
  }

  // The row sums cross the 4 threads of a row; rows past L are not stored.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= L) continue;
    const float den = fmaxf(l_run[i], 1e-30f);
    T* op = o + ((size_t)b * L + row) * q_stride + (size_t)h * HD;
#pragma unroll
    for (int n = 0; n < HDP / 8; ++n) {
      const int col = n * 8 + 2 * tig;  // HD is even: col < HD covers col + 1
      if (col < HD)
        *reinterpret_cast<uint32_t*>(op + col) =
            pack2<T>(acc[n][2 * i] / den, acc[n][2 * i + 1] / den);
    }
  }
}

template <typename T, int HDP, bool V16>
cudaError_t launch_tc(const T* q, const T* k, const T* v, T* o, int B,
                      int L, int NH, int KVH, int HD, cudaStream_t st) {
  const size_t smem = (size_t)(kBr + 2 * kStages * kBc) * (HDP + 8) * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_tc_kernel<T, HDP, V16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const float scale_log2 = (float)(1.0 / sqrt((double)HD)) * kLog2e;
  dim3 grid(NH, B, (L + kBr - 1) / kBr);
  flash_prefill_tc_kernel<T, HDP, V16><<<grid, kBThreads, smem, st>>>(
      q, k, v, o, L, NH, KVH, HD, scale_log2);
  return cudaGetLastError();
}

template <typename T, bool V16>
cudaError_t dispatch_tc(const T* q, const T* k, const T* v, T* o, int B,
                        int L, int NH, int KVH, int HD, cudaStream_t st) {
  switch ((HD + 15) / 16) {
    case 1: return launch_tc<T, 16, V16>(q, k, v, o, B, L, NH, KVH, HD, st);
    case 2: return launch_tc<T, 32, V16>(q, k, v, o, B, L, NH, KVH, HD, st);
    case 3: return launch_tc<T, 48, V16>(q, k, v, o, B, L, NH, KVH, HD, st);
    case 4: return launch_tc<T, 64, V16>(q, k, v, o, B, L, NH, KVH, HD, st);
    case 5: return launch_tc<T, 80, V16>(q, k, v, o, B, L, NH, KVH, HD, st);
    case 6: return launch_tc<T, 96, V16>(q, k, v, o, B, L, NH, KVH, HD, st);
    case 7: return launch_tc<T, 112, V16>(q, k, v, o, B, L, NH, KVH, HD, st);
    default: return launch_tc<T, 128, V16>(q, k, v, o, B, L, NH, KVH, HD, st);
  }
}

cudaError_t set_device_and_check(int B, int L, int NH, int KVH, int HD, int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaGetLastError();  // clear any stale error of this runtime
  if (B < 1 || L < 1 || KVH < 1 || NH % KVH != 0 || HD < 1 || HD > 128)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

extern "C" int l3t_flash_prefill_f32(const float* q, const float* k,
                                     const float* v, float* o, int B, int L,
                                     int NH, int KVH, int HD, int device,
                                     void* stream) {
  const cudaError_t err = set_device_and_check(B, L, NH, KVH, HD, device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((HD + 15) / 16) {
    case 1: return (int)launch_f32<1>(q, k, v, o, B, L, NH, KVH, HD, st);
    case 2: return (int)launch_f32<2>(q, k, v, o, B, L, NH, KVH, HD, st);
    case 3: return (int)launch_f32<3>(q, k, v, o, B, L, NH, KVH, HD, st);
    case 4: return (int)launch_f32<4>(q, k, v, o, B, L, NH, KVH, HD, st);
    case 5: return (int)launch_f32<5>(q, k, v, o, B, L, NH, KVH, HD, st);
    case 6: return (int)launch_f32<6>(q, k, v, o, B, L, NH, KVH, HD, st);
    case 7: return (int)launch_f32<7>(q, k, v, o, B, L, NH, KVH, HD, st);
    default: return (int)launch_f32<8>(q, k, v, o, B, L, NH, KVH, HD, st);
  }
}

namespace {

// The tensor-core modes' entry: checks, then the kernel for T.
template <typename T>
int run_tc(const T* q, const T* k, const T* v, T* o, int B, int L, int NH, int KVH,
           int HD, int device, void* stream) {
  const cudaError_t err = set_device_and_check(B, L, NH, KVH, HD, device);
  if (err != cudaSuccess) return (int)err;
  if (HD % 2 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(HD % 8 == 0 ? dispatch_tc<T, true>(q, k, v, o, B, L, NH, KVH, HD, st)
                           : dispatch_tc<T, false>(q, k, v, o, B, L, NH, KVH, HD, st));
}

}  // namespace

// As l3t_flash_prefill_f32, with bf16 q, k, v and o (tensor cores, f32
// accumulation); HD must be even.
extern "C" int l3t_flash_prefill_bf16(const bf16* q, const bf16* k, const bf16* v,
                                      bf16* o, int B, int L, int NH, int KVH, int HD,
                                      int device, void* stream) {
  return run_tc<bf16>(q, k, v, o, B, L, NH, KVH, HD, device, stream);
}

// As l3t_flash_prefill_bf16, with float16 q, k, v and o.
extern "C" int l3t_flash_prefill_f16(const f16* q, const f16* k, const f16* v,
                                     f16* o, int B, int L, int NH, int KVH, int HD,
                                     int device, void* stream) {
  return run_tc<f16>(q, k, v, o, B, L, NH, KVH, HD, device, stream);
}
