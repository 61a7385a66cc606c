// Paged decode attention for Hopper (sm_90a): float32 pools, int8 pools
// with per-(token, KV head) f32 scales under a float32, bf16 or float16 q,
// or bf16 / float16 pools with q and out of the pools' type.
//
// Replaces: llama3np_tpu/ops/kernels/paged_attention.py, `paged_attention`
// (:257; kernel body `_kernel` :66, pallas_call at :375).  One decode token
// per batch row attends the tokens its block table maps in a page pool
// [P, KVH, page, HD] (or layer `layer` of the stacked pools [NL, P, KVH,
// page, HD]), masked to kv_idx <= vlim, with the optional extra columns of
// the serving layer loop folded in: the quantum's in-flight window (columns
// s < win_count of win_k/win_v [B, KVH, Q, HD]) and the current token's
// appended column (cur_k/cur_v [B, KVH, HD]).  Out [B, 1, NH, HD].
// int8 mode (the TPU kernel's `quant` branches, :85-101, :175-191,
// :215-229, :242-250): pools are int8 and scale pools f32 [NL, P, KVH,
// page]; a score is (q . k8) * k_scale / sqrt(HD), the probability that
// multiplies v8 is p * v_scale, and the normalizer sums p without the V
// scale; cur_k/cur_v and the window rows are int8 with scales
// cur_ks/cur_vs [B, KVH] and win_ks/win_vs [B, KVH, Q], folded in as a
// read-back of their slot would be.
// int8 pools under a bf16 or float16 q (the 16-bit models' int8 KV): q is
// widened to f32 once, as it is staged (the TPU kernel's :134 widens q
// whatever its dtype), the scores, softmax and P.V are the f32 int8 mode's,
// and the output is rounded to q's dtype once (:254).
// bf16 and float16 modes: 16-bit pools, q, rows and output; everything is
// widened to f32 and accumulated in f32, as the TPU kernel does (pools
// upcast to f32, :167-170, :239, :251; the output in q's dtype, :254).
//
// What bounds it on the H100: bytes.  Each visible token's K and V rows are
// read once for all G = NH/KVH query heads of their KV head (2*KVH*HD*4
// bytes a token in fp32, 2*KVH*HD*2 in bf16, 2*KVH*(HD+4) in int8), at
// 4*G flops per 8 bytes read in fp32: far below the card's ratio of compute
// to bandwidth.  The floor is the visible K/V (plus q and out) over
// 3.35 TB/s: ~57 MB, ~17 us, for 8 rows at positions 0..8191 of llama3-8b
// in bf16; ~11 MB, ~3.3 us, for 8 rows up to 2047 of tinyllama-1.1b in
// fp32; ~3 MB, ~0.9 us, in int8.  To reach it, every SM must keep tens of
// KB in flight, and the rows' very different lengths must not leave a few
// blocks walking the long rows while the others idle.
//
// Design.  The TPU kernel runs one program per row and walks the row's
// pages in 2-deep DMA chunks.  Here:
//  * Chunks of a fixed C pages.  Each row's visible tokens are cut into
//    chunks of C pages (C from static shapes only, chosen by the wrapper:
//    about 128-256 tokens a block), and block (s, KV head, row) walks chunk
//    s.  A long row gets many blocks, a short row one, so a block's work is
//    bounded whatever the lengths; a block whose chunk lies past its row's
//    visible tokens exits at once.  A row's split depends on its own length
//    only, so another row's pos never changes its output.  A row that fits
//    one chunk writes its normalized output; the others write (max, sum,
//    P.V) partials, which a second launch merges, reading only the chunks
//    the row used (from pos, on the device).
//  * An asynchronous staging ring.  A block loads its chunk's page ids
//    (clamped to the pool, so a garbage entry cannot read out of bounds),
//    then streams 64-token tiles of K and V (int8: and their scale rows,
//    read through the block table) through a shared-memory ring with
//    cp.async: the next tiles are in flight while one is scored,
//    soft-maxed and multiplied.  A chunk of up to two tiles takes a
//    3-stage ring (all its tiles in flight at once), a longer one a 2-stage
//    ring, so that three blocks fit an SM (measured: PERF.md).  A (page,
//    KV head) block is page*HD contiguous elements; rows are copied in
//    16-byte pieces when a row is a whole number of them (else 4-byte
//    pieces) into rows padded to an odd number of pieces, so the score
//    loop, which reads a row's pieces, meets distinct banks.  Split 0 also streams the extra columns
//    (window rows, then the current row) as the last tiles of its walk.
//  * The G = NH/KVH query heads of a KV head share each staged K/V row:
//    neighbouring threads score the G heads of one token (the row is read
//    once and broadcast); an online softmax per head (one warp a head);
//    P.V with each thread owning fixed (head, 4-byte word) outputs in
//    registers, a word holding 1 (fp32), 2 (bf16) or 4 (int8) dims.
//  * Only the visible prefix of a tile enters the scores and the P.V sum,
//    so a masked column contributes an exact 0 to both: a stale or
//    non-finite value or scale behind the mask (the null page, the tail of
//    a row's last page, unwritten window columns) is never multiplied.  The
//    normalizer is clamped at 1e-30, as the TPU kernel's :254 is.
// int8 widens 4 int8 of a row at a time to f32 with byte permutes (exact,
// full ALU rate); the softmax stores p * v_scale for the P.V loop.  bf16
// widens a 4-byte word (two values) by shifts, float16 by the half2
// conversion.  q is widened to f32 as it is staged.  The 16-bit pools take
// the tensor-core form (HD % 16 == 0, G <= 16) with mma.sync operands of
// their own type: a product of two bf16 or two float16 values is exact in
// f32, and P enters P.V as a hi + lo pair of that type (float16: a lo part
// below 2^-14 is subnormal, an absolute error under 2^-25 a probability,
// far inside the output's one rounding).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;          // tokens a ring stage holds
constexpr int kMaxOut = 8;         // f32 outputs a thread owns
constexpr int kMaxChunkPages = 256;
constexpr int kMaxSmem = 227 * 1024;

typedef __nv_bfloat16 bf16;
typedef __half f16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(f16 v) { return __half2float(v); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(bf16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store_f(f16* p, float v) { *p = __float2half_rn(v); }

// A 16-bit float type (the tensor-core form's operands).
template <typename T>
constexpr bool kHalf16 = std::is_same<T, bf16>::value || std::is_same<T, f16>::value;

struct Args {
  const void* q;        // [B, NH, HD]: float (float pools), float/bf16/f16 (int8 pools),
                        // or the 16-bit pools' type
  const void* kp;       // pool of the layer: [P, KVH, page, HD], float, int8, bf16 or f16
  const void* vp;
  const float* ksp;     // int8: scale pools of the layer [P, KVH, page]
  const float* vsp;
  const int* bt;        // [B, maxp]
  const int* pos;       // [B]
  const void* cur_k;    // [B, KVH, HD] or null
  const void* cur_v;
  const float* cur_ks;  // int8: [B, KVH]
  const float* cur_vs;
  const void* win_k;    // [B, KVH, win_q, HD] or null
  const void* win_v;
  const float* win_ks;  // int8: [B, KVH, win_q]
  const float* win_vs;
  void* out;            // [B, NH, HD], q's type
  float* part_ml;       // [B, KVH, S, G, 2]
  float* part_acc;      // [B, KVH, S, G, HD]
  int NH, KVH, HD, P, page, maxp;
  int stacked, win_q, win_count;
  int chunk_pages;      // C: pages a block walks
  float scale;
};

// The tokens of row b that its pool slots hold (`held`: pos+1 in plain
// mode, pos in stacked mode, where the current token is the appended
// column), clamped to the table, and the number of C-page chunks they
// take (at least 1: chunk 0 always runs, for the extra columns or to
// write an empty row).
struct RowSpan {
  int vis, used;
};
__device__ __forceinline__ RowSpan row_span(int pos, int stacked, int page, int maxp, int C) {
  const int held = max(stacked ? pos : pos + 1, 0);
  const int vis = min(held, maxp * page);
  return {vis, max(1, ((vis + page - 1) / page + C - 1) / C)};
}

// Staged rows: VEC-byte pieces (16 or 4), an odd number of them a row.
template <typename T, int VEC>
__host__ __device__ constexpr int row_bytes(int HD) {
  return VEC * ((((int)sizeof(T) * HD + VEC - 1) / VEC) | 1);
}

// q in shared memory: f32 rows of a multiple of 4 floats, an odd number of
// 16-byte pieces apart.
__host__ __device__ constexpr int q_stride(int HD) { return 4 * (((HD + 3) / 4) | 1); }

struct Layout {
  int qs, sc, ml, scales, pids, ring, total;  // byte offsets, and the total
};
template <typename T, int VEC, int STAGES, bool TC>
__host__ __device__ Layout layout(int G, int HD, int C) {
  const bool i8 = std::is_same<T, int8_t>::value;
  Layout s;
  s.qs = 0;  // TC: 16-bit q [16][HD + 8] (rows >= G zero), else f32 [G][q_stride]
  s.sc = s.qs + (TC ? 16 * (HD + 8) * 2 : G * q_stride(HD) * 4);
  s.ml = s.sc + G * kTile * 4;                          // m, l, alpha: [3][G]
  s.scales = s.ml + 3 * G * 4;                          // int8: [STAGES][2][kTile]
  s.pids = s.scales + (i8 ? STAGES * 2 * kTile * 4 : 0);
  s.ring = (s.pids + C * 4 + 15) / 16 * 16;             // [STAGES][2][kTile][row]
  s.total = s.ring + STAGES * 2 * kTile * row_bytes<T, VEC>(HD);
  return s;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
template <int VEC>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (VEC == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr) : "memory");
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
// accumulators.
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
// Two f32 probabilities (lower column first) as the hi and lo pairs of T of
// an A fragment register: hi = T(p), lo = T(p - hi).
template <typename T>
__device__ __forceinline__ void split_pair(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  if constexpr (std::is_same<T, f16>::value) {
    const __half2 h = __floats2half2_rn(p0, p1);
    const __half2 l = __floats2half2_rn(p0 - __low2float(h), p1 - __high2float(h));
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
    const __nv_bfloat162 l = __floats2bfloat162_rn(p0 - __low2float(h), p1 - __high2float(h));
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  }
}

// Four signed bytes of v -> floats, exactly: b ^ 0x80 = b + 128 as an
// unsigned byte u; the float with bits 0x4B0000uu is 2^23 + u.
__device__ __forceinline__ void i8x4_to_f32(uint32_t v, float* f) {
  const unsigned u = v ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

// A 4-byte word of a staged row as f32 values: 1 (float), 2 (bf16, f16),
// 4 (int8).
template <typename T>
__device__ __forceinline__ void widen(uint32_t w, float* f) {
  if constexpr (std::is_same<T, int8_t>::value) {
    i8x4_to_f32(w, f);
  } else if constexpr (std::is_same<T, bf16>::value) {
    f[0] = __uint_as_float(w << 16);
    f[1] = __uint_as_float(w & 0xffff0000u);
  } else if constexpr (std::is_same<T, f16>::value) {
    const float2 v = __half22float2(*reinterpret_cast<const __half2*>(&w));
    f[0] = v.x;
    f[1] = v.y;
  } else {
    f[0] = __uint_as_float(w);
  }
}

// q . (one staged K row), in pieces of VEC bytes, d ascending.
template <typename T, int VEC>
__device__ __forceinline__ float row_dot(const float* qr, const unsigned char* kr, int HD) {
  constexpr int kPer = 4 / (int)sizeof(T);  // values a word
  constexpr int kWords = VEC / 4;
  float dot = 0.f;
  const int pieces = (int)sizeof(T) * HD / VEC;
#pragma unroll 2
  for (int u = 0; u < pieces; ++u) {
    uint32_t w[kWords];
    if constexpr (kWords == 4) {
      const uint4 x = *reinterpret_cast<const uint4*>(kr + u * VEC);
      w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(kr + u * VEC);
    }
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      float f[kPer];
      widen<T>(w[i], f);
      const float* qd = qr + (u * kWords + i) * kPer;
#pragma unroll
      for (int j = 0; j < kPer; ++j) dot = fmaf(qd[j], f[j], dot);
    }
  }
  return dot;
}

// T: the pools' type; TQ: q's and out's (T for 16-bit pools; float, bf16
// or f16 for int8 pools).  TC: the tensor-core form (16-bit pools only; HD %
// 16 == 0, G <= 16).
template <typename T, typename TQ, int VEC, int STAGES, bool TC>  // 3 blocks an SM with 2 stages, else 2
__global__ void __launch_bounds__(kThreads, STAGES == 2 ? 3 : 2)
paged_attn_kernel(const Args a) {
  constexpr bool kI8 = std::is_same<T, int8_t>::value;
  constexpr int kPer = 4 / (int)sizeof(T);  // dims a 4-byte word holds
  static_assert(!TC || (kHalf16<T> && std::is_same<T, TQ>::value),
                "the tensor-core form takes 16-bit pools under a q of their type");
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = blockIdx.x, S = gridDim.x, kh = blockIdx.y, b = blockIdx.z;
  const int HD = a.HD, G = a.NH / a.KVH, C = a.chunk_pages, page = a.page;

  const RowSpan span = row_span(a.pos[b], a.stacked, page, a.maxp, C);
  if (s >= span.used) return;  // past the row's tokens: nothing to do

  const Layout lay = layout<T, VEC, STAGES, TC>(G, HD, C);
  const int qp = q_stride(HD), rb = row_bytes<T, VEC>(HD);
  float* qs = reinterpret_cast<float*>(smem + lay.qs);  // [G][qp] queries
  float* sc = reinterpret_cast<float*>(smem + lay.sc);  // [G][kTile] scores, then probabilities
  float* m_run = reinterpret_cast<float*>(smem + lay.ml);  // [G] running max
  float* l_run = m_run + G;                                 // [G] running sum
  float* alpha = l_run + G;                                 // [G] rescale of this tile
  float* scales = reinterpret_cast<float*>(smem + lay.scales);  // int8: [stage][k|v][kTile]
  int* pids = reinterpret_cast<int*>(smem + lay.pids);          // [C] page ids of the chunk
  unsigned char* ring = smem + lay.ring;                        // [stage][k|v][kTile][rb]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* kp = static_cast<const T*>(a.kp);
  const T* vp = static_cast<const T*>(a.vp);

  // This block's tokens [c0, c1) of the row, then (split 0, stacked) the
  // extra columns: window rows s < win_count, then the current row.
  const int c0 = s * C * page, c1 = min(span.vis, c0 + C * page);
  const int n_ptiles = c1 > c0 ? (c1 - c0 + kTile - 1) / kTile : 0;
  const int extra = (s == 0 && a.stacked) ? a.win_count + 1 : 0;
  const int n_tiles = n_ptiles + (extra + kTile - 1) / kTile;
  const size_t bk = (size_t)b * a.KVH + kh;

  if constexpr (TC) {  // 16-bit q rows as they are, 16 of them (rows >= G zero)
    T* qb = reinterpret_cast<T*>(qs);
    for (int e = tid; e < 16 * HD; e += kThreads) {
      const int g = e / HD, d = e - g * HD;
      store_f(qb + g * (HD + 8) + d,
              g < G ? to_f(static_cast<const T*>(a.q)[(bk * G + g) * HD + d]) : 0.f);
    }
  } else {
    for (int e = tid; e < G * HD; e += kThreads) {
      const int g = e / HD, d = e - g * HD;
      qs[g * qp + d] = to_f(static_cast<const TQ*>(a.q)[(bk * G + g) * HD + d]);
    }
  }
  for (int g = tid; g < G; g += kThreads) {
    m_run[g] = -INFINITY;
    l_run[g] = 0.f;
  }
  for (int i = tid; i < (c1 - c0 + page - 1) / page; i += kThreads) {
    const int id = a.bt[(size_t)b * a.maxp + s * C + i];
    pids[i] = min(max(id, 0), a.P - 1);
  }
  __syncthreads();

  // Tile i of the walk into ring stage st, as cp.async copies; its visible
  // token count.
  const int pieces = (int)sizeof(T) * HD / VEC;  // copies a row
  auto tile_tokens = [&](int i) {
    return i < n_ptiles ? min(kTile, c1 - c0 - i * kTile)
                        : min(kTile, extra - (i - n_ptiles) * kTile);
  };
  auto issue = [&](int i, int st) {
    unsigned char* kd = ring + (size_t)(2 * st) * kTile * rb;
    unsigned char* vd = kd + (size_t)kTile * rb;
    const int ntok = tile_tokens(i);
    if (i < n_ptiles) {
      const int j0 = c0 + i * kTile;  // the tile's first token of the row
      for (int e = tid; e < ntok * pieces; e += kThreads) {
        const int t = e / pieces, u = e - t * pieces;
        const int j = j0 + t, pg = j / page;
        const size_t src = ((size_t)pids[pg - s * C] * a.KVH + kh) * page + (j - pg * page);
        cp_async<VEC>(kd + t * rb + u * VEC,
                      reinterpret_cast<const unsigned char*>(kp + src * HD) + u * VEC);
        cp_async<VEC>(vd + t * rb + u * VEC,
                      reinterpret_cast<const unsigned char*>(vp + src * HD) + u * VEC);
      }
      if constexpr (kI8) {
        for (int t = tid; t < ntok; t += kThreads) {
          const int j = j0 + t, pg = j / page;
          const size_t src = ((size_t)pids[pg - s * C] * a.KVH + kh) * page + (j - pg * page);
          cp_async<4>(scales + (2 * st) * kTile + t, a.ksp + src);
          cp_async<4>(scales + (2 * st + 1) * kTile + t, a.vsp + src);
        }
      }
    } else {
      const int x0 = (i - n_ptiles) * kTile;  // the tile's first extra column
      for (int e = tid; e < ntok * pieces; e += kThreads) {
        const int t = e / pieces, u = e - t * pieces, c = x0 + t;
        const bool win = c < a.win_count;
        const size_t row = win ? (bk * a.win_q + c) * HD : bk * HD;
        const T* ks = static_cast<const T*>(win ? a.win_k : a.cur_k) + row;
        const T* vs = static_cast<const T*>(win ? a.win_v : a.cur_v) + row;
        cp_async<VEC>(kd + t * rb + u * VEC, reinterpret_cast<const unsigned char*>(ks) + u * VEC);
        cp_async<VEC>(vd + t * rb + u * VEC, reinterpret_cast<const unsigned char*>(vs) + u * VEC);
      }
      if constexpr (kI8) {
        for (int t = tid; t < ntok; t += kThreads) {
          const int c = x0 + t;
          const bool win = c < a.win_count;
          cp_async<4>(scales + (2 * st) * kTile + t, win ? a.win_ks + bk * a.win_q + c : a.cur_ks + bk);
          cp_async<4>(scales + (2 * st + 1) * kTile + t, win ? a.win_vs + bk * a.win_q + c : a.cur_vs + bk);
        }
      }
    }
  };

  // Outputs a thread owns: (head, word) pairs o = tid + i*kThreads, each
  // kPer dims.
  constexpr int kOwn = kMaxOut / kPer;
  const int n_own = G * HD / kPer;
  float acc[kMaxOut];
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) acc[i] = 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_tiles) issue(i, i);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<STAGES - 2>();  // tile `it` has landed (this thread's copies)
    __syncthreads();              // ... every thread's; stage it-1 is consumed
    if (it + STAGES - 1 < n_tiles) issue(it + STAGES - 1, (it + STAGES - 1) % STAGES);
    cp_async_commit();
    const int st = it % STAGES, tvis = tile_tokens(it);
    unsigned char* kt = ring + (size_t)(2 * st) * kTile * rb;
    unsigned char* vt = kt + (size_t)kTile * rb;
    const float* ksc = scales + (2 * st) * kTile;
    const float* vsc = ksc + kTile;

    if constexpr (TC) {
      // V rows past the visible prefix, up to the P.V step's 16, as zeros:
      // a zero P must not meet a stale non-finite value there.
      const int tz = min(kTile, (tvis + 15) / 16 * 16);
      for (int e = tid; e < (tz - tvis) * (rb / 16); e += kThreads)
        *reinterpret_cast<uint4*>(vt + (tvis + e / (rb / 16)) * rb + e % (rb / 16) * 16) =
            make_uint4(0u, 0u, 0u, 0u);
      // Scores on the tensor cores: warp w takes tokens 8w..8w+7 of the
      // tile for the 16 (G used) query rows; 16-bit products are exact in f32.
      if (8 * warp < tvis) {
        const int lr = lane & 7, lm = lane >> 3;
        const uint32_t q_addr =
            smem_u32(reinterpret_cast<const T*>(qs) + ((lm & 1) * 8 + lr) * (HD + 8) +
                     (lm >> 1) * 8);
        const uint32_t k_addr = smem_u32(kt + (8 * warp + lr) * rb + (lm & 1) * 16);
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int kk = 0; kk < HD / 16; ++kk) {
          uint32_t qa[4], kb[2];
          ldmatrix_x4(qa, q_addr + kk * 32);
          ldmatrix_x2(kb, k_addr + kk * 32);
          mma16<T>(c, qa, kb[0], kb[1]);
        }
        const int t = 8 * warp + 2 * (lane & 3);  // c[e]: row lane/4 + 8(e/2), token t + e%2
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int g = (lane >> 2) + (e >> 1) * 8;
          if (g < G && t + (e & 1) < tvis) sc[g * kTile + t + (e & 1)] = c[e] * a.scale;
        }
      }
    } else {
      // Scores: neighbouring threads take the G heads of one token.
      for (int e = tid; e < G * tvis; e += kThreads) {
        const int g = e % G, t = e / G;
        const float dot = row_dot<T, VEC>(qs + g * qp, kt + t * rb, HD);
        sc[g * kTile + t] = (kI8 ? dot * ksc[t] : dot) * a.scale;
      }
    }
    __syncthreads();

    // Online softmax, one warp a head.  int8: the normalizer sums p, and
    // p * v_scale is what the P.V loop multiplies.
    for (int g = warp; g < G; g += kWarps) {
      float* row = sc + g * kTile;
      float mx = -INFINITY;
      for (int t = lane; t < tvis; t += 32) mx = fmaxf(mx, row[t]);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_run[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < tvis; t += 32) {
        const float e = expf(row[t] - m_new);
        row[t] = kI8 ? e * vsc[t] : e;
        sum += e;
      }
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        // exp(-inf - -inf) is nan: while nothing visible has been seen the
        // max stays -inf, and nothing has accumulated to rescale.
        const float al = m_new == -INFINITY ? 1.f : expf(m_old - m_new);
        alpha[g] = al;
        l_run[g] = l_run[g] * al + sum;
        m_run[g] = m_new;
      }
    }
    __syncthreads();

    if constexpr (TC) {
      // P.V on the tensor cores: warp w takes dims 16w..16w+15 (two
      // n-tiles); P (f32) enters as P_hi + P_lo, two 16-bit products, zero
      // past the visible prefix and for rows >= G.
      if (16 * warp < HD) {
        const int g = lane >> 2, tig = lane & 3, lr = lane & 7, lm = lane >> 3;
        const float al0 = g < G ? alpha[g] : 1.f, al1 = g + 8 < G ? alpha[g + 8] : 1.f;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          acc[4 * n] *= al0;
          acc[4 * n + 1] *= al0;
          acc[4 * n + 2] *= al1;
          acc[4 * n + 3] *= al1;
        }
        auto p_at = [&](int row, int t) {
          return row < G && t < tvis ? sc[row * kTile + t] : 0.f;
        };
        const uint32_t v_addr =
            smem_u32(vt + ((lm & 1) * 8 + lr) * rb + (16 * warp + (lm >> 1) * 8) * 2);
        for (int j = 0; j < (tvis + 15) / 16; ++j) {
          const int t = 16 * j + 2 * tig;
          uint32_t ph[4], pl[4], vb[4];
          split_pair<T>(p_at(g, t), p_at(g, t + 1), ph[0], pl[0]);
          split_pair<T>(p_at(g + 8, t), p_at(g + 8, t + 1), ph[1], pl[1]);
          split_pair<T>(p_at(g, t + 8), p_at(g, t + 9), ph[2], pl[2]);
          split_pair<T>(p_at(g + 8, t + 8), p_at(g + 8, t + 9), ph[3], pl[3]);
          ldmatrix_x4_trans(vb, v_addr + j * 16 * rb);
          mma16<T>(acc, ph, vb[0], vb[1]);
          mma16<T>(acc + 4, ph, vb[2], vb[3]);
          mma16<T>(acc, pl, vb[0], vb[1]);
          mma16<T>(acc + 4, pl, vb[2], vb[3]);
        }
      }
      continue;
    }
    // P.V over the visible prefix only; neighbouring threads take
    // neighbouring words of one V row.
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      const int o = tid + i * kThreads;
      if (o < n_own) {
        const int g = o * kPer / HD, d = o * kPer - g * HD;
        const float* pr = sc + g * kTile;
        const float al = alpha[g];
        float v[kPer];
#pragma unroll
        for (int j = 0; j < kPer; ++j) v[j] = acc[i * kPer + j] * al;
        const unsigned char* vcol = vt + d * (int)sizeof(T);
#pragma unroll 4
        for (int t = 0; t < tvis; ++t) {
          float f[kPer];
          widen<T>(*reinterpret_cast<const uint32_t*>(vcol + t * rb), f);
          const float pt = pr[t];
#pragma unroll
          for (int j = 0; j < kPer; ++j) v[j] = fmaf(pt, f[j], v[j]);
        }
#pragma unroll
        for (int j = 0; j < kPer; ++j) acc[i * kPer + j] = v[j];
      }
    }
  }

  const size_t split = bk * S + s;
  if constexpr (TC) {  // acc[4n + e]: row lane/4 + 8(e/2), dim 16w + 8n + 2(lane%4) + e%2
    if (16 * warp < HD) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int g = (lane >> 2) + ((e >> 1) & 1) * 8;
        const int od = g * HD + 16 * warp + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
        if (g >= G) continue;
        if (span.used == 1) {
          store_f(static_cast<TQ*>(a.out) + bk * G * HD + od, acc[e] / fmaxf(l_run[g], 1e-30f));
        } else {
          a.part_acc[split * G * HD + od] = acc[e];
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < (TC ? 0 : kOwn); ++i) {
    const int o = tid + i * kThreads;
    if (o < n_own) {
      const int g = o * kPer / HD;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int od = o * kPer + j;  // g * HD + dim
        if (span.used == 1) {
          store_f(static_cast<TQ*>(a.out) + bk * G * HD + od,
                  acc[i * kPer + j] / fmaxf(l_run[g], 1e-30f));
        } else {
          a.part_acc[split * G * HD + od] = acc[i * kPer + j];
        }
      }
    }
  }
  if (span.used > 1) {
    for (int g = tid; g < G; g += kThreads) {
      a.part_ml[(split * G + g) * 2] = m_run[g];
      a.part_ml[(split * G + g) * 2 + 1] = l_run[g];
    }
  }
}

// Merge the chunks row b used (none to merge if it used one: its chunk 0
// wrote the output) for each query head: rescale each chunk's sum and P.V
// to the common max.  TQ: the output's type (q's).
template <typename TQ>
__global__ void __launch_bounds__(128)
paged_attn_merge_kernel(const float* __restrict__ part_ml,
                        const float* __restrict__ part_acc, const int* __restrict__ pos,
                        int NH, int KVH, int HD, int S, int stacked, int page, int maxp,
                        int C, TQ* __restrict__ out) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int used = row_span(pos[b], stacked, page, maxp, C).used;
  if (used == 1) return;
  const int G = NH / KVH, kh = h / G, g = h - kh * G;
  const size_t base = ((size_t)b * KVH + kh) * S;
  float mx = -INFINITY;
  for (int s = 0; s < used; ++s) mx = fmaxf(mx, part_ml[((base + s) * G + g) * 2]);
  for (int d = threadIdx.x; d < HD; d += blockDim.x) {
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < used; ++s) {
      const size_t i = (base + s) * G + g;
      const float m = part_ml[i * 2];
      const float w = m == -INFINITY ? 0.f : expf(m - mx);
      l = fmaf(part_ml[i * 2 + 1], w, l);
      acc = fmaf(part_acc[i * HD + d], w, acc);
    }
    store_f(out + ((size_t)b * NH + h) * HD + d, acc / fmaxf(l, 1e-30f));
  }
}

template <typename T, typename TQ, int VEC, int STAGES, bool TC>
cudaError_t launch(const Args& a, int B, int S, cudaStream_t st) {
  const size_t smem = layout<T, VEC, STAGES, TC>(a.NH / a.KVH, a.HD, a.chunk_pages).total;
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidConfiguration;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(paged_attn_kernel<T, TQ, VEC, STAGES, TC>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
    if (err != cudaSuccess) return err;
  }
  paged_attn_kernel<T, TQ, VEC, STAGES, TC><<<dim3(S, a.KVH, B), kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// The ring's depth: a chunk of at most two tiles keeps all of them in
// flight (3 stages); a longer one takes 2 stages, so that three blocks fit
// an SM and the longer walk overlaps its copies with the other blocks'
// compute.
template <typename T, typename TQ, int VEC, bool TC = false>
cudaError_t launch_ring(const Args& a, int B, int S, cudaStream_t st) {
  return a.chunk_pages * a.page <= 2 * kTile ? launch<T, TQ, VEC, 3, TC>(a, B, S, st)
                                             : launch<T, TQ, VEC, 2, TC>(a, B, S, st);
}

// Checks the shapes, launches the chunk walk, and merges the chunks.  T:
// the pools' type, TQ: q's and out's.
template <typename T, typename TQ>
int run(Args a, int B, int layer, int device, void* stream) {
  constexpr bool kI8 = std::is_same<T, int8_t>::value;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaGetLastError();  // clear any stale error of this runtime
  const int NH = a.NH, KVH = a.KVH, HD = a.HD, P = a.P, page = a.page, C = a.chunk_pages;
  const int G = KVH > 0 ? NH / KVH : 0;
  if (B < 1 || KVH < 1 || NH % KVH != 0 || HD < 2 || HD > 128 ||
      HD % (kI8 ? 4 : 2) != 0 || G * HD > kThreads * kMaxOut || P < 1 ||
      page < 1 || a.maxp < 1 || layer < 0 || C < 1 || C > a.maxp ||
      C > kMaxChunkPages || (!a.stacked && a.win_q != 0) || a.win_q < 0 ||
      a.win_count < 0 || a.win_count > a.win_q)
    return (int)cudaErrorInvalidValue;

  const size_t layer_off = (size_t)layer * P * KVH * page;  // tokens of a layer
  a.kp = static_cast<const T*>(a.kp) + layer_off * HD;
  a.vp = static_cast<const T*>(a.vp) + layer_off * HD;
  if (kI8) {
    a.ksp += layer_off;
    a.vsp += layer_off;
  }
  a.scale = (float)(1.0 / sqrt((double)HD));
  const int S = (a.maxp + C - 1) / C;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (kHalf16<T>) {
    if (HD % 16 == 0 && G <= 16)  // the tensor-core form: 16 query rows, 16-dim steps
      err = launch_ring<T, TQ, 16, true>(a, B, S, st);
    else
      err = HD % 8 == 0 ? launch_ring<T, TQ, 16>(a, B, S, st)
                        : launch_ring<T, TQ, 4>(a, B, S, st);
  } else {
    err = (int)sizeof(T) * HD % 16 == 0 ? launch_ring<T, TQ, 16>(a, B, S, st)
                                         : launch_ring<T, TQ, 4>(a, B, S, st);
  }
  if (err != cudaSuccess) return (int)err;
  if (S > 1) {
    paged_attn_merge_kernel<<<dim3(NH, B), 128, 0, st>>>(
        a.part_ml, a.part_acc, a.pos, NH, KVH, HD, S, a.stacked, page, a.maxp, C,
        static_cast<TQ*>(a.out));
    err = cudaGetLastError();
  }
  return (int)err;
}

Args make_args(const void* q, const void* k_pools, const void* v_pools,
               const int* block_table, const int* pos, const void* cur_k,
               const void* cur_v, const void* win_k, const void* win_v,
               void* out, float* part_ml, float* part_acc, int NH, int KVH,
               int HD, int P, int page, int maxp, int stacked, int win_q,
               int win_count, int chunk_pages) {
  Args a = {};
  a.q = q;
  a.kp = k_pools;
  a.vp = v_pools;
  a.bt = block_table;
  a.pos = pos;
  a.cur_k = cur_k;
  a.cur_v = cur_v;
  a.win_k = win_k;
  a.win_v = win_v;
  a.out = out;
  a.part_ml = part_ml;
  a.part_acc = part_acc;
  a.NH = NH;
  a.KVH = KVH;
  a.HD = HD;
  a.P = P;
  a.page = page;
  a.maxp = maxp;
  a.stacked = stacked;
  a.win_q = win_q;
  a.win_count = win_count;
  a.chunk_pages = chunk_pages;
  return a;
}

}  // namespace

// q [B,1,NH,HD]; pools [NL,P,KVH,page,HD] (NL = 1 in plain mode), read at
// layer `layer`; block_table [B,maxp] and pos [B] int32 on the device.
// stacked != 0: the pools hold tokens < pos and cur_k/cur_v are appended;
// win_q > 0 (stacked only): window rows win_k/win_v, the first win_count
// visible.  chunk_pages: C, the pages a block walks; part_ml/part_acc:
// scratch of B*KVH*S*G*(2 | HD) floats, S = ceil(maxp / C).
extern "C" int l3t_paged_attention_f32(
    const float* q, const float* k_pools, const float* v_pools,
    const int* block_table, const int* pos, const float* cur_k,
    const float* cur_v, const float* win_k, const float* win_v, float* out,
    float* part_ml, float* part_acc, int B, int NH, int KVH, int HD, int P,
    int page, int maxp, int layer, int stacked, int win_q, int win_count,
    int chunk_pages, int device, void* stream) {
  const Args a = make_args(q, k_pools, v_pools, block_table, pos, cur_k, cur_v,
                           win_k, win_v, out, part_ml, part_acc, NH, KVH, HD, P,
                           page, maxp, stacked, win_q, win_count, chunk_pages);
  return run<float, float>(a, B, layer, device, stream);
}

namespace {

// int8 pools under a q (and out) of TQ: the scales' checks and pointers.
template <typename TQ>
int run_i8(const TQ* q, const int8_t* k_pools, const int8_t* v_pools,
           const float* k_scales, const float* v_scales, const int* block_table,
           const int* pos, const int8_t* cur_k, const int8_t* cur_v,
           const float* cur_ks, const float* cur_vs, const int8_t* win_k,
           const int8_t* win_v, const float* win_ks, const float* win_vs, TQ* out,
           float* part_ml, float* part_acc, int B, int NH, int KVH, int HD, int P,
           int page, int maxp, int layer, int stacked, int win_q, int win_count,
           int chunk_pages, int device, void* stream) {
  if (k_scales == nullptr || v_scales == nullptr ||
      (stacked && (cur_ks == nullptr || cur_vs == nullptr)) ||
      (win_q > 0 && (win_ks == nullptr || win_vs == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a = make_args(q, k_pools, v_pools, block_table, pos, cur_k, cur_v, win_k,
                     win_v, out, part_ml, part_acc, NH, KVH, HD, P, page, maxp,
                     stacked, win_q, win_count, chunk_pages);
  a.ksp = k_scales;
  a.vsp = v_scales;
  a.cur_ks = cur_ks;
  a.cur_vs = cur_vs;
  a.win_ks = win_ks;
  a.win_vs = win_vs;
  return run<int8_t, TQ>(a, B, layer, device, stream);
}

}  // namespace

#define L3T_PAGED_I8_ARGS(TQ)                                                         \
  const TQ *q, const int8_t *k_pools, const int8_t *v_pools, const float *k_scales,   \
      const float *v_scales, const int *block_table, const int *pos,                  \
      const int8_t *cur_k, const int8_t *cur_v, const float *cur_ks,                  \
      const float *cur_vs, const int8_t *win_k, const int8_t *win_v,                  \
      const float *win_ks, const float *win_vs, TQ *out, float *part_ml,              \
      float *part_acc, int B, int NH, int KVH, int HD, int P, int page, int maxp,     \
      int layer, int stacked, int win_q, int win_count, int chunk_pages, int device,  \
      void *stream
#define L3T_PAGED_I8_CALL                                                             \
  run_i8(q, k_pools, v_pools, k_scales, v_scales, block_table, pos, cur_k, cur_v,     \
         cur_ks, cur_vs, win_k, win_v, win_ks, win_vs, out, part_ml, part_acc, B, NH, \
         KVH, HD, P, page, maxp, layer, stacked, win_q, win_count, chunk_pages,       \
         device, stream)

// int8 pools with their f32 scale pools [NL,P,KVH,page]; int8 cur_k/cur_v
// with cur_ks/cur_vs [B,KVH], int8 window rows with win_ks/win_vs
// [B,KVH,win_q]; float32 q and out.  Otherwise as l3t_paged_attention_f32.
extern "C" int l3t_paged_attention_i8(L3T_PAGED_I8_ARGS(float)) { return L3T_PAGED_I8_CALL; }

// As l3t_paged_attention_i8, under a bf16 q: q widened to f32 inside, the
// output rounded to bf16 once.
extern "C" int l3t_paged_attention_i8_bf16(L3T_PAGED_I8_ARGS(bf16)) { return L3T_PAGED_I8_CALL; }

// As l3t_paged_attention_i8, under a float16 q and out.
extern "C" int l3t_paged_attention_i8_f16(L3T_PAGED_I8_ARGS(f16)) { return L3T_PAGED_I8_CALL; }

// bf16 q, pools, cur_k/cur_v, window rows and out (f32 math inside).
// Otherwise as l3t_paged_attention_f32.
extern "C" int l3t_paged_attention_bf16(
    const bf16* q, const bf16* k_pools, const bf16* v_pools,
    const int* block_table, const int* pos, const bf16* cur_k, const bf16* cur_v,
    const bf16* win_k, const bf16* win_v, bf16* out, float* part_ml,
    float* part_acc, int B, int NH, int KVH, int HD, int P, int page, int maxp,
    int layer, int stacked, int win_q, int win_count, int chunk_pages, int device,
    void* stream) {
  const Args a = make_args(q, k_pools, v_pools, block_table, pos, cur_k, cur_v,
                           win_k, win_v, out, part_ml, part_acc, NH, KVH, HD, P,
                           page, maxp, stacked, win_q, win_count, chunk_pages);
  return run<bf16, bf16>(a, B, layer, device, stream);
}

// float16 q, pools, cur_k/cur_v, window rows and out (f32 math inside).
// Otherwise as l3t_paged_attention_f32.
extern "C" int l3t_paged_attention_f16(
    const f16* q, const f16* k_pools, const f16* v_pools,
    const int* block_table, const int* pos, const f16* cur_k, const f16* cur_v,
    const f16* win_k, const f16* win_v, f16* out, float* part_ml,
    float* part_acc, int B, int NH, int KVH, int HD, int P, int page, int maxp,
    int layer, int stacked, int win_q, int win_count, int chunk_pages, int device,
    void* stream) {
  const Args a = make_args(q, k_pools, v_pools, block_table, pos, cur_k, cur_v,
                           win_k, win_v, out, part_ml, part_acc, NH, KVH, HD, P,
                           page, maxp, stacked, win_q, win_count, chunk_pages);
  return run<f16, f16>(a, B, layer, device, stream);
}
