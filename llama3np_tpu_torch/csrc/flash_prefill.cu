// Flash prefill attention for Hopper (sm_90a), float32, bf16 or float16.
//
// Replaces: llama3np_tpu/ops/kernels/flash_prefill.py, `flash_prefill` (body
// `_kernel`, pallas_call at :102).  Causal GQA self-attention for the
// start_pos == 0 prefill: q [B,L,NH,HD], k/v [B,L,KVH,HD] -> o [B,L,NH,HD],
// online softmax in f32, key tiles above the diagonal never touched.  The
// TPU kernel walks a sequential (q-block, kv-block) grid with VMEM scratch
// carrying (m, l, acc) across kv steps; here a block owns one (batch, query
// head, query tile) and loops over the key tiles up to the tile's last row
// itself (in float32 at L >= 256, over a piece of them), so the carry lives
// in registers.  The GQA map is h / (NH / KVH),
// as in the TPU kernel's index map (:109); k/v are read as they lie in
// [B,L,KVH,HD] (no transposes in device memory).
//
// What bounds it on the H100.  The work is 4*NH*HD*L(L+1)/2 FLOPs against
// (2*NH + 2*KVH)*L*HD elements of traffic.  float32 (tinyllama widths,
// L=512): ~1.08 GFLOP a layer, ~16 us at the 67 TFLOP/s fp32 CUDA-core
// peak, against ~0.7 MB: operations (the 3-piece split on tensor cores: 6
// MMAs a product, ~6.5 us at 989 TFLOP/s).  bf16 (llama3-8b widths, L=512):
// 2.15 GFLOP (2.2 us at the 989 TFLOP/s bf16 tensor-core peak) against
// 10.5 MB (3.1 us): bytes, at the published peaks; in practice the longest
// query tile's chain of tensor-core products and softmax steps sets the
// time, since L=512 gives one wave of blocks on 132 SMs.
//
// float32 mode (TF32 tensor cores would break the fp32 parity gate).  A
// block owns BM query rows of one (batch, head) and a piece of their key
// range.  Tiles sized to L: BM = 16 rows for L <= 128 (a 16-token prompt
// computes 16 rows, not 64), 64 beyond; keys come in tiles of 64
// (`ops/kernels/flash_prefill.f32_plan` picks BM and KS).  For L >= 256 a
// query tile's key tiles are cut into (two) pieces of KS, one block a
// piece, so no one-SM chain of 8 or more tiles sets the time of the wave;
// each piece writes its (m, l, acc) and the last piece of the tile to
// arrive (a ticket after a __threadfence) merges them in piece order
// (flash-decoding's merge: bit-equal run to run).  The grid puts the last
// (longest) query tiles first.  64-row tiles with HD <= 64 (HD % 4 == 0,
// rows 16-byte aligned) run on tensor cores with every operand split into
// three bf16 pieces (`flash_prefill_x3_kernel`, after the bf16 kernel: 2x
// the CUDA-core form at tinyllama L=512, PERF.md); the rest on CUDA cores,
// 256 threads (16 x 16), the register-tiled form of a CUDA-core GEMM:
//  * Q (once) and each K/V tile arrive through a 2-stage cp.async ring
//    (16-byte copies when HD % 4 == 0, else 4-byte ones; rows past L
//    zero-filled with src-size 0), so the next tile is in flight while one
//    is used: two barriers a key tile.  Rows lie as in device memory, HD
//    padded with zeros to HDP (a multiple of 4) at a stride of an odd
//    number of 16-byte chunks, so the float4 reads of a quarter warp fall
//    in distinct banks;
//  * thread (ty, tx) owns query rows ty*RM .. ty*RM+RM-1 (RM = BM / 16): it
//    computes their scores against keys tx, tx+16, tx+32, tx+48 four dims
//    a step, and their outputs at dims 4tx .. 4tx+3 (+64);
//  * a row's max and sum cross its 16 threads by xor-shuffles inside a
//    half-warp; masked scores (key > row, or key >= L) contribute an
//    explicit 0, never exp(0); the probabilities go through shared memory
//    for P.V, key-major;
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

#include <initializer_list>
#include <type_traits>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;
typedef __half f16;

// ---- asynchronous copies (both modes) -----------------------------------

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

// ---- float32 mode: CUDA cores --------------------------------------------

constexpr int kThreads = 256;   // 16 x 16
constexpr int kBN = 64;         // keys a tile
constexpr int kF32Stages = 2;   // K/V tiles in the ring
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// RM consecutive floats (RM = 1 or 4) as one access.
template <int RM>
__device__ __forceinline__ void load_rows(const float* p, float (&r)[RM]) {
  if constexpr (RM == 4) {
    const float4 v = lds4(p);
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  } else {
    r[0] = *p;
  }
}
template <int RM>
__device__ __forceinline__ void store_rows(float* p, const float (&r)[RM]) {
  if constexpr (RM == 4) *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  else *p = r[0];
}

bool aligned16(const void* q, const void* k, const void* v, const void* o) {
  for (const void* p : {q, k, v, o})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// Block z of a head -> (query tile, piece of KS key tiles; the tile's key
// tiles and pieces): the last (longest) query tiles first, each tile's
// pieces in order.  BM: query rows a tile.
struct Unit {
  int qt, piece, n_kt, n_pc;
};
__device__ __forceinline__ Unit unit_of(int z, int BM, int L, int KS) {
  Unit u{(L + BM - 1) / BM - 1, z, 0, 0};
  for (;; --u.qt) {
    u.n_kt = (min((u.qt + 1) * BM, L) + kBN - 1) / kBN;
    u.n_pc = (u.n_kt + KS - 1) / KS;
    if (u.piece < u.n_pc) return u;
    u.piece -= u.n_pc;
  }
}

// The grid's z extent: the pieces over every query tile of a head.
int units_of(int BM, int L, int KS) {
  int units = 0;
  for (int qt = 0; qt * BM < L; ++qt) {
    const int n_keys = (qt + 1) * BM < L ? (qt + 1) * BM : L;
    units += ((n_keys + kBN - 1) / kBN + KS - 1) / KS;
  }
  return units;
}

// RM: query rows a thread (a block owns BM = 16 * RM rows); DV: 64-column
// slices of the output a thread (HDP <= 64 * DV).  Block z is one piece of
// one query tile.  part/count: the merge's partials and
// tickets (used when a tile has more than one piece).
template <int RM, int DV>
__global__ void __launch_bounds__(kThreads, 2)
flash_prefill_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ part, unsigned* __restrict__ count,
                     int L, int NH, int KVH, int HD, int HDP, int stride, int KS,
                     bool vec16, float scale) {
  constexpr int BM = 16 * RM;
  constexpr int BMP = BM + RM;  // P's key-row stride: its vector stores fall in distinct banks
  constexpr int kUnrollD = RM == 4 ? 1 : 2;  // the QK^T dim loop (RM = 4: registers)
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BM][stride] queries
  float* Ks = Qs + BM * stride;                 // [kF32Stages][kBN][stride] keys
  float* Vs = Ks + kF32Stages * kBN * stride;   // [kF32Stages][kBN][stride] values
  float* Ps = Vs + kF32Stages * kBN * stride;   // [kBN][BMP] probabilities, key-major
  __shared__ int is_last;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int n_qt = (L + BM - 1) / BM;
  const Unit un = unit_of(blockIdx.z, BM, L, KS);
  const int qt = un.qt, piece = un.piece, n_kt = un.n_kt, n_pc = un.n_pc;
  const int q0 = qt * BM, kt0 = piece * KS, kt1 = min(n_kt, kt0 + KS);
  const int n_keys = min(q0 + BM, L);  // keys visible to some row of the tile
  const int kvh = h / (NH / KVH);
  const size_t q_stride = (size_t)NH * HD, kv_stride = (size_t)KVH * HD;
  const float* qb = q + (size_t)b * L * q_stride + (size_t)h * HD;
  const float* kb = k + (size_t)b * L * kv_stride + (size_t)kvh * HD;
  const float* vb = v + (size_t)b * L * kv_stride + (size_t)kvh * HD;

  // Zero the pad columns [HD, HDP) of every staged row (Q and the ring are
  // one array of rows); the copies never write them.
  if (HD < HDP) {
    const int pad = HDP - HD;
    for (int e = tid; e < (BM + 2 * kF32Stages * kBN) * pad; e += kThreads) {
      const int r = e / pad;
      Qs[r * stride + HD + (e - r * pad)] = 0.f;
    }
  }
  // Rows r0 .. r0 + rows - 1 of [.., HD] at `rs` into `dst`, rows >= L as
  // zeros: 16-byte copies when HD % 4 == 0 and the rows are aligned, else
  // 4-byte ones.
  auto stage = [&](float* dst, const float* src, size_t rs, int r0, int rows) {
    if (vec16) {
      const int per = HD >> 2;
      for (int e = tid; e < rows * per; e += kThreads) {
        const int r = e / per, c = (e - r * per) * 4;
        const bool ok = r0 + r < L;
        cp_async16(smem_u32(dst + r * stride + c), src + (size_t)(ok ? r0 + r : 0) * rs + c, ok);
      }
    } else {
      for (int e = tid; e < rows * HD; e += kThreads) {
        const int r = e / HD, c = e - r * HD;
        const bool ok = r0 + r < L;
        cp_async4(smem_u32(dst + r * stride + c), src + (size_t)(ok ? r0 + r : 0) * rs + c, ok);
      }
    }
  };
  // A key tile's rows past the tile's visible keys are not copied: their
  // scores are masked by a select and their P.V terms never run.
  auto stage_kv = [&](int it, int slot) {
    const int t0 = it * kBN, rows = min(kBN, n_keys - t0);
    stage(Ks + slot * kBN * stride, kb, kv_stride, t0, rows);
    stage(Vs + slot * kBN * stride, vb, kv_stride, t0, rows);
  };

  stage(Qs, qb, q_stride, q0, BM);
  stage_kv(kt0, 0);
  cp_async_commit();  // Q rides in the first group

  float m[RM], l[RM], acc[RM][4 * DV];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4 * DV; ++j) acc[i][j] = 0.f;
  }

  for (int it = kt0; it < kt1; ++it) {
    const int slot = (it - kt0) & 1;
    cp_async_wait<0>();  // tile `it` has landed (this thread's copies)
    __syncthreads();     // ... every thread's; the other slot and Ps are consumed
    if (it + 1 < kt1) stage_kv(it + 1, slot ^ 1);
    cp_async_commit();
    const int t0 = it * kBN;
    const float* Kt = Ks + slot * kBN * stride;
    const float* Vt = Vs + slot * kBN * stride;

    // S = Q K^T: rows ty*RM + i against keys tx + 16 j, four dims a step
    // (K rows at a stride of an odd number of 16-byte chunks: a quarter
    // warp's eight float4 reads fall in distinct banks).
    float s[RM][4];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll kUnrollD
    for (int d = 0; d < HDP; d += 4) {
      float4 qa[RM], ka[4];
#pragma unroll
      for (int i = 0; i < RM; ++i) qa[i] = lds4(Qs + (ty * RM + i) * stride + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = lds4(Kt + (tx + 16 * j) * stride + d);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
        }
    }

    // Online softmax: a row's 16 threads meet by xor-shuffles in a half warp.
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = q0 + ty * RM + i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = t0 + tx + 16 * j;
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
        const int key = t0 + tx + 16 * j;
        s[i][j] = (key <= row && key < L) ? expf(s[i][j] - m_new) : 0.f;
        psum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * alpha + psum;
#pragma unroll
      for (int j = 0; j < 4 * DV; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float r[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) r[i] = s[i][j];
      store_rows<RM>(Ps + (tx + 16 * j) * BMP + ty * RM, r);
    }
    __syncthreads();

    // acc += P V: dims 4 tx + 64 jv (+0..3) of rows ty*RM + i.
    const int cnt = min(kBN, n_keys - t0);
    for (int c = 0; c < cnt; ++c) {
      float p[RM];
      load_rows<RM>(Ps + c * BMP + ty * RM, p);
#pragma unroll
      for (int jv = 0; jv < DV; ++jv) {
        const int d = 4 * tx + 64 * jv;
        if (d < HDP) {
          const float4 vv = lds4(Vt + c * stride + d);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            acc[i][4 * jv] = fmaf(p[i], vv.x, acc[i][4 * jv]);
            acc[i][4 * jv + 1] = fmaf(p[i], vv.y, acc[i][4 * jv + 1]);
            acc[i][4 * jv + 2] = fmaf(p[i], vv.z, acc[i][4 * jv + 2]);
            acc[i][4 * jv + 3] = fmaf(p[i], vv.w, acc[i][4 * jv + 3]);
          }
        }
      }
    }
  }

  // Row `row` of the output from its accumulator and normalizer.
  auto store = [&](int row, const float (&a)[4 * DV], float den) {
    float* op = o + ((size_t)b * L + row) * q_stride + (size_t)h * HD;
#pragma unroll
    for (int jv = 0; jv < DV; ++jv) {
      const int d = 4 * tx + 64 * jv;
      if (vec16 && d < HD) {
        *reinterpret_cast<float4*>(op + d) = make_float4(
            a[4 * jv] / den, a[4 * jv + 1] / den, a[4 * jv + 2] / den, a[4 * jv + 3] / den);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (d + e < HD) op[d + e] = a[4 * jv + e] / den;
      }
    }
  };

  if (n_pc == 1) {  // the whole key range: normalize and store
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = q0 + ty * RM + i;
      if (row < L) store(row, acc[i], fmaxf(l[i], 1e-30f));
    }
    return;
  }

  // A piece of the key range: write (m, l, acc) to the tile's slot of this
  // piece ([BM][2] then [BM][HDP]); the last piece to arrive merges them.
  const int tile = (b * NH + h) * n_qt + qt;
  const int max_pc = ((L + kBN - 1) / kBN + KS - 1) / KS;
  const size_t slot_words = (size_t)BM * (2 + HDP);
  float* tile_part = part + (size_t)tile * max_pc * slot_words;
  {
    float* mine = tile_part + piece * slot_words;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int rl = ty * RM + i;
      if (tx == 0) *reinterpret_cast<float2*>(mine + 2 * rl) = make_float2(m[i], l[i]);
#pragma unroll
      for (int jv = 0; jv < DV; ++jv) {
        const int d = 4 * tx + 64 * jv;
        if (d < HDP)
          *reinterpret_cast<float4*>(mine + 2 * BM + rl * HDP + d) = make_float4(
              acc[i][4 * jv], acc[i][4 * jv + 1], acc[i][4 * jv + 2], acc[i][4 * jv + 3]);
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(count + tile, 1u) == (unsigned)(n_pc - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // The merge, in piece order: every piece rescaled to the rows' common max.
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int rl = ty * RM + i, row = q0 + rl;
    if (row >= L) continue;
    float mx = kNegInf;
    for (int p = 0; p < n_pc; ++p) mx = fmaxf(mx, __ldcg(tile_part + p * slot_words + 2 * rl));
    float lsum = 0.f, a[4 * DV];
#pragma unroll
    for (int j = 0; j < 4 * DV; ++j) a[j] = 0.f;
    for (int p = 0; p < n_pc; ++p) {
      const float* sp = tile_part + p * slot_words;
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(sp + 2 * rl));
      const float wgt = expf(ml.x - mx);
      lsum = fmaf(wgt, ml.y, lsum);
#pragma unroll
      for (int jv = 0; jv < DV; ++jv) {
        const int d = 4 * tx + 64 * jv;
        if (d < HDP) {
          const float4 x = __ldcg(reinterpret_cast<const float4*>(sp + 2 * BM + rl * HDP + d));
          a[4 * jv] = fmaf(wgt, x.x, a[4 * jv]);
          a[4 * jv + 1] = fmaf(wgt, x.y, a[4 * jv + 1]);
          a[4 * jv + 2] = fmaf(wgt, x.z, a[4 * jv + 2]);
          a[4 * jv + 3] = fmaf(wgt, x.w, a[4 * jv + 3]);
        }
      }
    }
    store(row, a, fmaxf(lsum, 1e-30f));
  }
  if (tid == 0) count[tile] = 0u;
}

template <int RM, int DV>
cudaError_t launch_f32(const float* q, const float* k, const float* v, float* o,
                       float* part, unsigned* count, int B, int L, int NH, int KVH,
                       int HD, int KS, cudaStream_t st) {
  constexpr int BM = 16 * RM;
  const int HDP = (HD + 3) / 4 * 4;
  const int stride = (HDP / 4) % 2 ? HDP : HDP + 4;  // an odd number of 16-byte chunks
  const size_t smem = ((size_t)(BM + 2 * kF32Stages * kBN) * stride +
                       (size_t)kBN * (BM + RM)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_kernel<RM, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const bool vec16 = HD % 4 == 0 && aligned16(q, k, v, o);
  const float scale = (float)(1.0 / sqrt((double)HD));
  dim3 grid(NH, B, units_of(BM, L, KS));
  flash_prefill_kernel<RM, DV><<<grid, kThreads, smem, st>>>(
      q, k, v, o, part, count, L, NH, KVH, HD, HDP, stride, KS, vec16, scale);
  return cudaGetLastError();
}

template <int RM>
cudaError_t dispatch_f32(const float* q, const float* k, const float* v, float* o,
                         float* part, unsigned* count, int B, int L, int NH, int KVH,
                         int HD, int KS, cudaStream_t st) {
  return HD <= 64 ? launch_f32<RM, 1>(q, k, v, o, part, count, B, L, NH, KVH, HD, KS, st)
                  : launch_f32<RM, 2>(q, k, v, o, part, count, B, L, NH, KVH, HD, KS, st);
}

// ---- bf16 and float16 modes: tensor cores ---------------------------------

constexpr int kBr = 64;       // query rows a block, 16 a warp
constexpr int kBc = 64;       // keys a tile
constexpr int kStages = 2;    // K/V tiles in the ring
constexpr int kBThreads = kBr * 2;
constexpr float kLog2e = 1.4426950408889634f;

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

// ---- float32 mode on tensor cores: a 3-piece bf16 split ------------------
//
// For L >= 256 (64-row query tiles) and HD <= 64: every f32 operand is cut
// into three bf16 pieces, x = x0 + x1 + x2 (exact for normal values: each
// piece takes the next 8 bits of x's 24), and a product x.y is the six
// mma.sync products x2y0 + x1y1 + x0y2 + x1y0 + x0y1 + x0y0 (the terms
// left out are below 2^-24 |x||y|), f32 accumulators throughout; no TF32.
// The schedule is the bf16 kernel's (4 warps of 16 rows, 64-key tiles,
// ldmatrix from padded rows) with the f32 mode's pieces and merge: Q's
// planes are made once, each K/V tile's while the previous tile is used
// (its f32 values prefetched into registers), and P enters P.V split.

// Two f32 values (the lower column first) as three bf16 pairs, x = p0 + p1 + p2.
__device__ __forceinline__ void split3_pair(float x0, float x1, uint32_t& p0, uint32_t& p1,
                                            uint32_t& p2) {
  p0 = pack2<bf16>(x0, x1);
  const float r0 = x0 - low_f(p0, bf16()), r1 = x1 - high_f(p0, bf16());
  p1 = pack2<bf16>(r0, r1);
  p2 = pack2<bf16>(r0 - low_f(p1, bf16()), r1 - high_f(p1, bf16()));
}

// d += x.y over the three pieces of each (a: x's A fragments, b0/b1: y's B
// fragment registers of each piece), the smallest terms first.
__device__ __forceinline__ void mma_x3(float* d, const uint32_t (&a)[3][4],
                                       const uint32_t (&b0)[3], const uint32_t (&b1)[3]) {
  mma16<bf16>(d, a[2], b0[0], b1[0]);
  mma16<bf16>(d, a[1], b0[1], b1[1]);
  mma16<bf16>(d, a[0], b0[2], b1[2]);
  mma16<bf16>(d, a[1], b0[0], b1[0]);
  mma16<bf16>(d, a[0], b0[1], b1[1]);
  mma16<bf16>(d, a[0], b0[0], b1[0]);
}

// HDP: HD padded to a multiple of 16 (<= 64); HD % 4 == 0, rows 16-byte aligned.
template <int HDP>
__global__ void __launch_bounds__(kBThreads, 2)
flash_prefill_x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ part, unsigned* __restrict__ count,
                        int L, int NH, int KVH, int HD, int KS, float scale_log2) {
  constexpr int kRow = HDP + 8;               // row stride: an odd number of 16-byte chunks
  constexpr int kPlane = kBc * kRow;          // bf16 values a plane (kBr == kBc)
  constexpr int kPer = kBc * HDP / 4 / kBThreads;  // float4s of a tile a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qp = reinterpret_cast<bf16*>(smem_raw);  // [3][kBr][kRow] query pieces
  bf16* Kp = Qp + 3 * kPlane;                    // [3][kBc][kRow] key pieces
  bf16* Vp = Kp + 3 * kPlane;                    // [3][kBc][kRow] value pieces
  __shared__ int is_last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int n_qt = (L + kBr - 1) / kBr;
  const Unit un = unit_of(blockIdx.z, kBr, L, KS);
  const int qt = un.qt, piece = un.piece, n_pc = un.n_pc;
  const int q0 = qt * kBr, kt0 = piece * KS, kt1 = min(un.n_kt, kt0 + KS);
  const int n_keys = min(q0 + kBr, L);
  const int kvh = h / (NH / KVH);
  const size_t q_stride = (size_t)NH * HD, kv_stride = (size_t)KVH * HD;
  const float* qb = q + (size_t)b * L * q_stride + (size_t)h * HD;
  const float* kb = k + (size_t)b * L * kv_stride + (size_t)kvh * HD;
  const float* vb = v + (size_t)b * L * kv_stride + (size_t)kvh * HD;

  // Rows r0 .. r0 + 63 of [.., HD] as float4s, rows >= n and columns >= HD
  // as zeros (a masked P = 0 never meets a non-finite V).
  auto fetch = [&](float4 (&x)[kPer], const float* src, size_t rs, int r0, int n) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kBThreads, r = e / (HDP / 4), c = (e - r * (HDP / 4)) * 4;
      x[i] = r0 + r < n && c < HD
                 ? __ldg(reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * rs + c))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store_planes = [&](bf16* dst, const float4 (&x)[kPer]) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kBThreads, r = e / (HDP / 4), c = (e - r * (HDP / 4)) * 4;
      uint32_t p[3][2];
      split3_pair(x[i].x, x[i].y, p[0][0], p[1][0], p[2][0]);
      split3_pair(x[i].z, x[i].w, p[0][1], p[1][1], p[2][1]);
#pragma unroll
      for (int s = 0; s < 3; ++s)
        *reinterpret_cast<uint2*>(dst + s * kPlane + r * kRow + c) = make_uint2(p[s][0], p[s][1]);
    }
  };

  float4 kx[kPer], vx[kPer];
  fetch(kx, qb, q_stride, q0, L);
  store_planes(Qp, kx);
  fetch(kx, kb, kv_stride, kt0 * kBc, n_keys);
  fetch(vx, vb, kv_stride, kt0 * kBc, n_keys);

  const int row0 = q0 + warp * 16;  // this warp's first query row
  const int g = lane >> 2, tig = lane & 3;
  const int lr = lane & 7, lm = lane >> 3;  // ldmatrix: lane l gives row l % 8 of matrix l / 8
  const uint32_t q_addr =
      smem_u32(Qp + (warp * 16 + (lm & 1) * 8 + lr) * kRow + (lm >> 1) * 8);
  const int k_off = ((lm >> 1) * 8 + lr) * kRow + (lm & 1) * 8;  // two key n-tiles
  const int v_off = ((lm & 1) * 8 + lr) * kRow + (lm >> 1) * 8;  // two dim n-tiles

  float acc[HDP / 8][4];
#pragma unroll
  for (int n = 0; n < HDP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};  // rows g, g + 8

  for (int it = kt0; it < kt1; ++it) {
    __syncthreads();  // the previous tile's pieces are consumed
    store_planes(Kp, kx);
    store_planes(Vp, vx);
    __syncthreads();
    if (it + 1 < kt1) {  // the next tile's loads fly while this one is used
      fetch(kx, kb, kv_stride, (it + 1) * kBc, n_keys);
      fetch(vx, vb, kv_stride, (it + 1) * kBc, n_keys);
    }
    const int t0 = it * kBc;

    // S = Q K^T: 16 rows x 64 keys a warp, six products a pair of pieces.
    float s[kBc / 8][4];
#pragma unroll
    for (int n = 0; n < kBc / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      uint32_t a[3][4];
#pragma unroll
      for (int p = 0; p < 3; ++p) ldmatrix_x4(a[p], q_addr + (p * kPlane + kk * 16) * 2);
#pragma unroll
      for (int n = 0; n < kBc / 8; n += 2) {
        uint32_t bb[3][4];
#pragma unroll
        for (int p = 0; p < 3; ++p)
          ldmatrix_x4(bb[p], smem_u32(Kp + p * kPlane + n * 8 * kRow + k_off + kk * 16));
        const uint32_t b0[3] = {bb[0][0], bb[1][0], bb[2][0]}, b1[3] = {bb[0][1], bb[1][1], bb[2][1]};
        const uint32_t b2[3] = {bb[0][2], bb[1][2], bb[2][2]}, b3[3] = {bb[0][3], bb[1][3], bb[2][3]};
        mma_x3(s[n], a, b0, b1);
        mma_x3(s[n + 1], a, b2, b3);
      }
    }

    // Online softmax in the log2 domain, as the bf16 kernel's.
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
    for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + psum[i];
#pragma unroll
    for (int n = 0; n < HDP / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += P V, P split in three pieces like every other operand.
#pragma unroll
    for (int j = 0; j < kBc / 16; ++j) {
      uint32_t pp[3][4];
      split3_pair(s[2 * j][0], s[2 * j][1], pp[0][0], pp[1][0], pp[2][0]);
      split3_pair(s[2 * j][2], s[2 * j][3], pp[0][1], pp[1][1], pp[2][1]);
      split3_pair(s[2 * j + 1][0], s[2 * j + 1][1], pp[0][2], pp[1][2], pp[2][2]);
      split3_pair(s[2 * j + 1][2], s[2 * j + 1][3], pp[0][3], pp[1][3], pp[2][3]);
#pragma unroll
      for (int n = 0; n < HDP / 8; n += 2) {
        uint32_t vv[3][4];
#pragma unroll
        for (int p = 0; p < 3; ++p)
          ldmatrix_x4_trans(vv[p], smem_u32(Vp + p * kPlane + j * 16 * kRow + v_off + n * 8));
        const uint32_t b0[3] = {vv[0][0], vv[1][0], vv[2][0]}, b1[3] = {vv[0][1], vv[1][1], vv[2][1]};
        const uint32_t b2[3] = {vv[0][2], vv[1][2], vv[2][2]}, b3[3] = {vv[0][3], vv[1][3], vv[2][3]};
        mma_x3(acc[n], pp, b0, b1);
        mma_x3(acc[n + 1], pp, b2, b3);
      }
    }
  }

  // The row sums cross the 4 threads of a row.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  // Columns n * 8 + 2 tig (+1) of `row`: a0/a1 the pair of each n-tile.
  auto store = [&](int row, const float (&a0)[HDP / 8], const float (&a1)[HDP / 8], float den) {
    float* op = o + ((size_t)b * L + row) * q_stride + (size_t)h * HD;
#pragma unroll
    for (int n = 0; n < HDP / 8; ++n) {
      const int col = n * 8 + 2 * tig;
      if (col < HD) *reinterpret_cast<float2*>(op + col) = make_float2(a0[n] / den, a1[n] / den);
    }
  };
  if (n_pc == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + g + 8 * i;
      if (row >= L) continue;
      float a0[HDP / 8], a1[HDP / 8];
#pragma unroll
      for (int n = 0; n < HDP / 8; ++n) {
        a0[n] = acc[n][2 * i];
        a1[n] = acc[n][2 * i + 1];
      }
      store(row, a0, a1, fmaxf(l_run[i], 1e-30f));
    }
    return;
  }

  // A piece: (m, l, acc) to this piece's slot ([kBr][2] then [kBr][HD]),
  // the last piece of the tile to arrive merges the slots in piece order.
  const int tile = (b * NH + h) * n_qt + qt;
  const int max_pc = ((L + kBc - 1) / kBc + KS - 1) / KS;
  const size_t slot_words = (size_t)kBr * (2 + HD);
  float* tile_part = part + (size_t)tile * max_pc * slot_words;
  {
    float* mine = tile_part + piece * slot_words;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rl = warp * 16 + g + 8 * i;
      if (tig == 0) *reinterpret_cast<float2*>(mine + 2 * rl) = make_float2(m_run[i], l_run[i]);
#pragma unroll
      for (int n = 0; n < HDP / 8; ++n) {
        const int col = n * 8 + 2 * tig;
        if (col < HD)
          *reinterpret_cast<float2*>(mine + 2 * kBr + rl * HD + col) =
              make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(count + tile, 1u) == (unsigned)(n_pc - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rl = warp * 16 + g + 8 * i, row = q0 + rl;
    if (row >= L) continue;
    float mx = -INFINITY;
    for (int p = 0; p < n_pc; ++p) mx = fmaxf(mx, __ldcg(tile_part + p * slot_words + 2 * rl));
    float lsum = 0.f, a0[HDP / 8], a1[HDP / 8];
#pragma unroll
    for (int n = 0; n < HDP / 8; ++n) a0[n] = a1[n] = 0.f;
    for (int p = 0; p < n_pc; ++p) {
      const float* sp = tile_part + p * slot_words;
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(sp + 2 * rl));
      const float wgt = mx == -INFINITY ? 0.f : exp2f(ml.x - mx);
      lsum = fmaf(wgt, ml.y, lsum);
#pragma unroll
      for (int n = 0; n < HDP / 8; ++n) {
        const int col = n * 8 + 2 * tig;
        if (col < HD) {
          const float2 x = __ldcg(reinterpret_cast<const float2*>(sp + 2 * kBr + rl * HD + col));
          a0[n] = fmaf(wgt, x.x, a0[n]);
          a1[n] = fmaf(wgt, x.y, a1[n]);
        }
      }
    }
    store(row, a0, a1, fmaxf(lsum, 1e-30f));
  }
  if (tid == 0) count[tile] = 0u;
}

template <int HDP>
cudaError_t launch_x3(const float* q, const float* k, const float* v, float* o, float* part,
                      unsigned* count, int B, int L, int NH, int KVH, int HD, int KS,
                      cudaStream_t st) {
  const size_t smem = (size_t)9 * kBc * (HDP + 8) * sizeof(bf16);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_x3_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const float scale_log2 = (float)(1.0 / sqrt((double)HD)) * kLog2e;
  dim3 grid(NH, B, units_of(kBr, L, KS));
  flash_prefill_x3_kernel<HDP><<<grid, kBThreads, smem, st>>>(
      q, k, v, o, part, count, L, NH, KVH, HD, KS, scale_log2);
  return cudaGetLastError();
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

// q [B,L,NH,HD], k/v [B,L,KVH,HD] -> o [B,L,NH,HD], float32.  BM: query
// rows a block (16 or 64); KS: key tiles of 64 a block (the key range
// of a longer query tile is split into pieces and merged).  part: the
// pieces' partials, count: one zeroed ticket a (batch, head, query tile),
// left zero (`ops/kernels/flash_prefill.f32_plan` sizes both; unused, and
// may be null, when KS covers every tile).
extern "C" int l3t_flash_prefill_f32(const float* q, const float* k, const float* v,
                                     float* o, float* part, unsigned* count, int B,
                                     int L, int NH, int KVH, int HD, int BM, int KS,
                                     int device, void* stream) {
  const cudaError_t err = set_device_and_check(B, L, NH, KVH, HD, device);
  if (err != cudaSuccess) return (int)err;
  if (KS < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BM == 64 && HD % 4 == 0 && HD <= 64 && aligned16(q, k, v, o)) {  // tensor cores
    switch ((HD + 15) / 16) {
      case 1: return (int)launch_x3<16>(q, k, v, o, part, count, B, L, NH, KVH, HD, KS, st);
      case 2: return (int)launch_x3<32>(q, k, v, o, part, count, B, L, NH, KVH, HD, KS, st);
      case 3: return (int)launch_x3<48>(q, k, v, o, part, count, B, L, NH, KVH, HD, KS, st);
      default: return (int)launch_x3<64>(q, k, v, o, part, count, B, L, NH, KVH, HD, KS, st);
    }
  }
  switch (BM) {
    case 16: return (int)dispatch_f32<1>(q, k, v, o, part, count, B, L, NH, KVH, HD, KS, st);
    case 64: return (int)dispatch_f32<4>(q, k, v, o, part, count, B, L, NH, KVH, HD, KS, st);
    default: return (int)cudaErrorInvalidValue;
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
