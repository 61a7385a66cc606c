// Paged decode attention for Hopper (sm_90a): float32 pools, int8 pools
// with per-(token, KV head) f32 scales, or bf16 pools with bf16 q and out.
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
//
// What bounds it on the H100: bytes.  Each visible token's K and V rows are
// read once for all G = NH/KVH query heads of their KV head (2*KVH*HD*4
// bytes a token in fp32, 2*KVH*HD*2 in bf16, 2*KVH*(HD+4) in int8), at
// 4*G flops per 8 bytes read in fp32: far below the card's ratio of compute
// to bandwidth.  The floor is the visible K/V (plus q and out) over
// 3.35 TB/s: ~11 MB, ~3.3 us, for 8 rows at positions up to 2047 of
// tinyllama-1.1b (KVH=4, HD=64); ~3 MB, ~0.9 us, in int8.
//
// Design.  The TPU kernel runs one program per row and walks the row's pages
// in 2-deep DMA chunks.  On the GPU one row's walk in one block would use
// B*KVH blocks (32 at B=8, KVH=4) of 132 SMs, so each row's page list is
// split over `splits` blocks as well (flash-decoding): grid (split, KV head,
// row).  A block loads the row's block-table entries and position itself,
// clamps the page count to the table width (`n = min(ceil(held/page),
// maxp)`, as the TPU kernel does at :106-114), and stages its pages in
// tiles of up to 128 tokens into shared memory: a (page, KV head) block is
// page*HD contiguous floats, read as float4 (float2 when HD % 4 != 0) by
// neighbouring threads, four vectors of K and of V in flight per thread;
// rows are padded to HD+1 floats so the score loop is
// free of bank conflicts.  For each tile: scores for the G heads (threads
// take (head, token) pairs, so a K row is read once and broadcast), an
// online softmax per head (one warp a head), and P.V with each thread
// owning fixed (head, dim) outputs in registers.  Only the visible prefix of
// a tile enters the scores and the P.V sum, so a masked column contributes
// an exact 0 to both: a stale or non-finite value behind the mask (the null
// page, the tail of a row's last page, unwritten window columns) is never
// multiplied.  Split 0 also folds the extra columns (window rows, then the
// current row) as one more tile.  With one split the block writes the
// normalized output; otherwise its (max, sum, P.V) partials, which a second
// launch merges per query head.  The normalizer is clamped at 1e-30, as the
// TPU kernel's :254 is.  Page ids are clamped to the pool, so a garbage
// table entry cannot read out of bounds.
// int8 mode: the tiles stay int8 in shared memory (a 128-token tile at
// HD=64 is 8 KB instead of 32 KB), staged with 16-byte loads when HD % 16
// == 0 and 4-byte loads otherwise (HD % 4 == 0 is required); a row is
// padded to an odd number of 4-byte words, so neighbouring tokens of the
// score loop fall in different banks.  The block reads the tile's scales
// through the block table from the scale pools, as it reads the values
// (the TPU kernel took them pre-gathered per row, a VMEM-block rule).  The
// score loop widens 4 int8 of a K row at a time to f32 with byte permutes
// (exact, full ALU rate) against q in f32; the softmax stores p * v_scale
// for the P.V loop, in which a thread owns 4 neighbouring dims of one head
// and widens one 4-byte word of a V row per token.  The scales of masked
// slots (stale tails, the null page, unwritten window columns) may be
// non-finite: the visible-prefix rule keeps them out as it keeps out the
// values.
// bf16 mode: the tiles stay bf16 in shared memory (half the fp32 bytes: a
// 128-token tile at HD=128 is 32 KB of K and 32 KB of V), staged with
// 16-byte loads when HD % 8 == 0 and 4-byte loads otherwise (HD even); a
// row is padded to an odd number of 4-byte words, so the score loop's
// neighbouring tokens fall in different banks.  q (the activation dtype)
// is widened to f32 as it is staged; the score loop widens one word (two
// bf16) of a K row at a time, the P.V loop one element of a V row, and
// everything else (scores, softmax, sums, the split merge) is the f32
// mode's, so the TPU kernel's semantics hold (pools upcast to f32 and
// accumulated in f32, :167-170, :239, :251; the output in q's dtype,
// :254).  cur_k/cur_v and the window rows come in the pool dtype, as the
// serving loop makes them.  cp.async double buffering is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileTokens = 128;  // tokens a block stages at once
constexpr int kMaxOut = 8;        // (head, dim) outputs a thread owns
constexpr int kLoadUnroll = 4;    // page loads in flight per thread
constexpr int kMaxSmem = 227 * 1024;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(bf16* p, float v) { *p = __float2bfloat16(v); }

// The type of q and out for pools of T: bf16 with bf16 pools, else float.
template <typename T>
using QType = typename std::conditional<std::is_same<T, bf16>::value, bf16, float>::type;

struct Args {
  const void* q;        // [B, NH, HD], float (float/int8 pools) or bf16
  const void* kp;       // pool of the layer: [P, KVH, page, HD], float, int8 or bf16
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
  int pages_per_split, tile_pages;
  float scale;
};

// A staged row's stride: float rows pad to HD+1 floats; int8 and bf16 rows
// to an odd number of 4-byte words.
template <typename T>
__host__ __device__ constexpr int row_stride(int HD) {
  return std::is_same<T, int8_t>::value ? 4 * ((HD / 4) | 1)
         : std::is_same<T, bf16>::value ? 2 * ((HD / 2) | 1)
                                        : HD + 1;
}

// The query's row stride in shared memory: int8 mode reads q as float4.
template <typename T>
__host__ __device__ constexpr int q_stride(int HD) {
  return std::is_same<T, int8_t>::value ? HD + 4 : HD + 1;
}

// Shared memory of one block, in bytes (layout in paged_attn_kernel).
template <typename T>
size_t smem_bytes(int G, int HD, int T_tok, int tile_pages) {
  const bool i8 = std::is_same<T, int8_t>::value;
  return (size_t)(G * q_stride<T>(HD) + G * T_tok + 3 * G + (i8 ? 2 * T_tok : 0)) *
             sizeof(float) +
         2 * (size_t)T_tok * row_stride<T>(HD) * sizeof(T) +
         (size_t)tile_pages * sizeof(int);
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

// One vector of VEC elements from global memory into registers, and from
// registers into a staged row.  float: VEC 4 or 2; int8: VEC 16 or 4 bytes;
// bf16: VEC 8 or 2.
template <typename T, int VEC>
struct Vec {
  static constexpr int kWords = VEC * (int)sizeof(T) / 4;
  uint32_t w[kWords];
  __device__ __forceinline__ void load(const T* src) {
    if constexpr (kWords == 4) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(src));
      w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
    } else if constexpr (kWords == 2) {
      const uint2 x = __ldg(reinterpret_cast<const uint2*>(src));
      w[0] = x.x; w[1] = x.y;
    } else {
      w[0] = __ldg(reinterpret_cast<const unsigned int*>(src));
    }
  }
  __device__ __forceinline__ void store(T* dst) const {  // 4-byte aligned
#pragma unroll
    for (int i = 0; i < kWords; ++i) reinterpret_cast<uint32_t*>(dst)[i] = w[i];
  }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const Args a) {
  constexpr bool kI8 = std::is_same<T, int8_t>::value;
  constexpr bool kF32 = std::is_same<T, float>::value;
  using TQ = QType<T>;
  extern __shared__ __align__(16) float smem[];
  const int s = blockIdx.x, S = gridDim.x, kh = blockIdx.y, b = blockIdx.z;
  const int HD = a.HD, G = a.NH / a.KVH;
  const int qp = q_stride<T>(HD), rs = row_stride<T>(HD);
  const int T_tok = a.tile_pages * a.page;  // tile capacity in tokens
  float* qs = smem;                     // [G][qp] queries
  float* sc = qs + G * qp;              // [G][T] scores, then probabilities
  float* m_run = sc + G * T_tok;        // [G] running max
  float* l_run = m_run + G;             // [G] running sum
  float* alpha = l_run + G;             // [G] rescale of this tile
  float* ksc = alpha + G;               // int8: [T] K scales of the tile
  float* vsc = ksc + (kI8 ? T_tok : 0); // int8: [T] V scales of the tile
  T* kt = reinterpret_cast<T*>(vsc + (kI8 ? T_tok : 0));  // [T][rs]
  T* vt = kt + (size_t)T_tok * rs;                         // [T][rs]
  int* pids = reinterpret_cast<int*>(vt + (size_t)T_tok * rs);  // [tile_pages]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* kp = static_cast<const T*>(a.kp);
  const T* vp = static_cast<const T*>(a.vp);

  // The pool holds `held` tokens of this row: pos+1 in plain mode, pos in
  // stacked mode (the current token is the appended column).
  const int p = a.pos[b];
  const int held = max(a.stacked ? p : p + 1, 0);
  const int n = min((held + a.page - 1) / a.page, a.maxp);
  const int j_begin = s * a.pages_per_split;
  const int j_end = min(n, j_begin + a.pages_per_split);
  const int n_page_tiles =
      j_end > j_begin ? (j_end - j_begin + a.tile_pages - 1) / a.tile_pages : 0;
  const int extra = (s == 0 && a.stacked) ? a.win_count + 1 : 0;
  const int n_tiles = n_page_tiles + (extra > 0 ? 1 : 0);

  for (int e = tid; e < G * HD; e += kThreads) {
    const int g = e / HD, d = e - g * HD;
    qs[g * qp + d] = to_f(static_cast<const TQ*>(a.q)[((size_t)b * a.NH + kh * G + g) * HD + d]);
  }
  for (int g = tid; g < G; g += kThreads) {
    m_run[g] = -INFINITY;
    l_run[g] = 0.f;
  }
  // Outputs a thread owns: fp32, (head, dim) pairs o = tid + i*kThreads;
  // int8, (head, 4-dim word) pairs, 4 outputs each.
  constexpr int kPerOut = kI8 ? 4 : 1;
  constexpr int kOwn = kMaxOut / kPerOut;
  const int n_own = G * HD / kPerOut;
  float acc[kMaxOut];
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) acc[i] = 0.f;
  __syncthreads();

  const int per_page = a.page * HD;  // elements of one (page, KV head) block
  for (int it = 0; it < n_tiles; ++it) {
    int tvis;  // visible tokens of the tile: a prefix
    if (it < n_page_tiles) {
      const int j0 = j_begin + it * a.tile_pages;
      const int np = min(a.tile_pages, j_end - j0);
      tvis = min(np * a.page, held - j0 * a.page);
      if (tid < np) {
        const int id = a.bt[(size_t)b * a.maxp + j0 + tid];
        pids[tid] = min(max(id, 0), a.P - 1);
      }
      __syncthreads();
      // kLoadUnroll vector loads of K and of V in flight per thread before
      // any is stored: a load consumed at once would wait out the whole
      // memory latency once per vector.
      const int nvec = np * per_page / VEC;
      for (int f0 = tid; f0 < nvec; f0 += kThreads * kLoadUnroll) {
        Vec<T, VEC> kr[kLoadUnroll], vr[kLoadUnroll];
        int dst[kLoadUnroll];
#pragma unroll
        for (int u = 0; u < kLoadUnroll; ++u) {
          const int f = f0 + u * kThreads;
          dst[u] = -1;
          if (f < nvec) {
            const int e = f * VEC;
            const int pi = e / per_page, r = e - pi * per_page;
            const int t = r / HD, d = r - t * HD;
            const size_t src = ((size_t)pids[pi] * a.KVH + kh) * per_page + r;
            kr[u].load(kp + src);
            vr[u].load(vp + src);
            dst[u] = (pi * a.page + t) * rs + d;
          }
        }
#pragma unroll
        for (int u = 0; u < kLoadUnroll; ++u) {
          if (dst[u] >= 0) {
            if constexpr (!kF32) {  // rows padded to whole words: word stores
              kr[u].store(kt + dst[u]);
              vr[u].store(vt + dst[u]);
            } else {  // padded float rows: element stores
#pragma unroll
              for (int j = 0; j < VEC; ++j) {
                kt[dst[u] + j] = __uint_as_float(kr[u].w[j]);
                vt[dst[u] + j] = __uint_as_float(vr[u].w[j]);
              }
            }
          }
        }
      }
      if constexpr (kI8) {  // the tile's scales, through the same page ids
        for (int i = tid; i < np * a.page; i += kThreads) {
          const int pi = i / a.page;
          const size_t idx = ((size_t)pids[pi] * a.KVH + kh) * a.page + (i - pi * a.page);
          ksc[i] = a.ksp[idx];
          vsc[i] = a.vsp[idx];
        }
      }
    } else {  // split 0's extra columns: window rows s < win_count, then current
      tvis = extra;
      const size_t bk = (size_t)b * a.KVH + kh;
      for (int e = tid; e < extra * (HD / VEC); e += kThreads) {
        const int c = e / (HD / VEC), d = (e - c * (HD / VEC)) * VEC;
        const bool win = c < a.win_count;
        const size_t row = win ? (bk * a.win_q + c) * HD : bk * HD;
        Vec<T, VEC> kr, vr;
        kr.load(static_cast<const T*>(win ? a.win_k : a.cur_k) + row + d);
        vr.load(static_cast<const T*>(win ? a.win_v : a.cur_v) + row + d);
        if constexpr (!kF32) {
          kr.store(kt + c * rs + d);
          vr.store(vt + c * rs + d);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            kt[c * rs + d + j] = __uint_as_float(kr.w[j]);
            vt[c * rs + d + j] = __uint_as_float(vr.w[j]);
          }
        }
      }
      if constexpr (kI8) {
        for (int c = tid; c < extra; c += kThreads) {
          const bool win = c < a.win_count;
          ksc[c] = win ? a.win_ks[bk * a.win_q + c] : a.cur_ks[bk];
          vsc[c] = win ? a.win_vs[bk * a.win_q + c] : a.cur_vs[bk];
        }
      }
    }
    __syncthreads();

    // Scores: neighbouring threads take the G heads of one token.
    for (int e = tid; e < G * tvis; e += kThreads) {
      const int g = e % G, t = e / G;
      const float* qr = qs + g * qp;
      float dot = 0.f;
      if constexpr (kI8) {
        const int* kr = reinterpret_cast<const int*>(kt + t * rs);
#pragma unroll 4
        for (int w = 0; w < HD / 4; ++w) {
          float k4[4];
          i8x4_to_f32(kr[w], k4);
          const float4 q4 = reinterpret_cast<const float4*>(qr)[w];
          dot = fmaf(q4.x, k4[0], dot);
          dot = fmaf(q4.y, k4[1], dot);
          dot = fmaf(q4.z, k4[2], dot);
          dot = fmaf(q4.w, k4[3], dot);
        }
        sc[g * T_tok + t] = dot * ksc[t] * a.scale;
      } else if constexpr (!kF32) {  // bf16: two elements a word
        const uint32_t* kr = reinterpret_cast<const uint32_t*>(kt + t * rs);
#pragma unroll 4
        for (int w = 0; w < HD / 2; ++w) {
          const uint32_t u = kr[w];
          dot = fmaf(qr[2 * w], __uint_as_float(u << 16), dot);
          dot = fmaf(qr[2 * w + 1], __uint_as_float(u & 0xffff0000u), dot);
        }
        sc[g * T_tok + t] = dot * a.scale;
      } else {
        const float* kr = kt + t * rs;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
        sc[g * T_tok + t] = dot * a.scale;
      }
    }
    __syncthreads();

    // Online softmax, one warp a head.  int8: the normalizer sums p, and
    // p * v_scale is what the P.V loop multiplies.
    for (int g = warp; g < G; g += kWarps) {
      float* row = sc + g * T_tok;
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

    // P.V over the visible prefix only; neighbouring threads take
    // neighbouring dims (int8: 4-dim words) of one V row.
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      const int o = tid + i * kThreads;
      if (o < n_own) {
        const int g = o * kPerOut / HD, d = o * kPerOut - g * HD;
        const float* pr = sc + g * T_tok;
        const float al = alpha[g];
        if constexpr (kI8) {
          float v0 = acc[4 * i] * al, v1 = acc[4 * i + 1] * al;
          float v2 = acc[4 * i + 2] * al, v3 = acc[4 * i + 3] * al;
#pragma unroll 4
          for (int t = 0; t < tvis; ++t) {
            float v4[4];
            i8x4_to_f32(*reinterpret_cast<const int*>(vt + t * rs + d), v4);
            const float pt = pr[t];
            v0 = fmaf(pt, v4[0], v0);
            v1 = fmaf(pt, v4[1], v1);
            v2 = fmaf(pt, v4[2], v2);
            v3 = fmaf(pt, v4[3], v3);
          }
          acc[4 * i] = v0;
          acc[4 * i + 1] = v1;
          acc[4 * i + 2] = v2;
          acc[4 * i + 3] = v3;
        } else {
          float v = acc[i] * al;
#pragma unroll 4
          for (int t = 0; t < tvis; ++t) v = fmaf(pr[t], to_f(vt[t * rs + d]), v);
          acc[i] = v;
        }
      }
    }
    __syncthreads();
  }

  const size_t split = ((size_t)b * a.KVH + kh) * S + s;
#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    const int o = tid + i * kThreads;
    if (o < n_own) {
      const int g = o * kPerOut / HD;
#pragma unroll
      for (int j = 0; j < kPerOut; ++j) {
        const int od = o * kPerOut + j;  // g * HD + dim
        if (S == 1) {
          store_f(static_cast<TQ*>(a.out) + ((size_t)b * a.NH + kh * G) * HD + od,
                  acc[i * kPerOut + j] / fmaxf(l_run[g], 1e-30f));
        } else {
          a.part_acc[split * G * HD + od] = acc[i * kPerOut + j];
        }
      }
    }
  }
  if (S > 1) {
    for (int g = tid; g < G; g += kThreads) {
      a.part_ml[(split * G + g) * 2] = m_run[g];
      a.part_ml[(split * G + g) * 2 + 1] = l_run[g];
    }
  }
}

// Merge the S splits of each (row, query head): rescale each split's sum
// and P.V to the common max.  An empty split has max -inf and weighs 0.
// TQ: the output's type (q's).
template <typename TQ>
__global__ void __launch_bounds__(128)
paged_attn_merge_kernel(const float* __restrict__ part_ml,
                        const float* __restrict__ part_acc, int NH, int KVH,
                        int HD, int S, TQ* __restrict__ out) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = NH / KVH, kh = h / G, g = h - kh * G;
  const size_t base = ((size_t)b * KVH + kh) * S;
  float mx = -INFINITY;
  for (int s = 0; s < S; ++s) mx = fmaxf(mx, part_ml[((base + s) * G + g) * 2]);
  for (int d = threadIdx.x; d < HD; d += blockDim.x) {
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < S; ++s) {
      const size_t i = (base + s) * G + g;
      const float m = part_ml[i * 2];
      const float w = m == -INFINITY ? 0.f : expf(m - mx);
      l = fmaf(part_ml[i * 2 + 1], w, l);
      acc = fmaf(part_acc[i * HD + d], w, acc);
    }
    store_f(out + ((size_t)b * NH + h) * HD + d, acc / fmaxf(l, 1e-30f));
  }
}

template <typename T, int VEC>
cudaError_t launch(const Args& a, int B, int S, size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attn_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  paged_attn_kernel<T, VEC><<<dim3(S, a.KVH, B), kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// Checks the shapes, sizes shared memory, launches, and merges the splits.
template <typename T>
int run(Args a, int B, int layer, int splits, int device, void* stream) {
  constexpr bool kI8 = std::is_same<T, int8_t>::value;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaGetLastError();  // clear any stale error of this runtime
  const int NH = a.NH, KVH = a.KVH, HD = a.HD, P = a.P, page = a.page;
  const int G = KVH > 0 ? NH / KVH : 0;
  const int tile_pages = page > 0 ? max(1, kTileTokens / page) : 0;
  if (B < 1 || KVH < 1 || NH % KVH != 0 || HD < 2 || HD > 128 ||
      HD % (kI8 ? 4 : 2) != 0 || G * HD > kThreads * kMaxOut || P < 1 ||
      page < 1 || page > kTileTokens || a.maxp < 1 || layer < 0 || splits < 1 ||
      splits > a.maxp || (!a.stacked && a.win_q != 0) || a.win_q < 0 ||
      a.win_count < 0 || a.win_count > a.win_q || a.win_q + 1 > tile_pages * page)
    return (int)cudaErrorInvalidValue;
  const int T_tok = tile_pages * page;
  const size_t smem = smem_bytes<T>(G, HD, T_tok, tile_pages);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidConfiguration;

  const size_t layer_off = (size_t)layer * P * KVH * page;  // tokens of a layer
  a.kp = static_cast<const T*>(a.kp) + layer_off * HD;
  a.vp = static_cast<const T*>(a.vp) + layer_off * HD;
  if (kI8) {
    a.ksp += layer_off;
    a.vsp += layer_off;
  }
  a.pages_per_split = (a.maxp + splits - 1) / splits;
  a.tile_pages = tile_pages;
  a.scale = (float)(1.0 / sqrt((double)HD));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (kI8) {
    err = HD % 16 == 0 ? launch<T, 16>(a, B, splits, smem, st)
                       : launch<T, 4>(a, B, splits, smem, st);
  } else if constexpr (std::is_same<T, bf16>::value) {
    err = HD % 8 == 0 ? launch<T, 8>(a, B, splits, smem, st)
                      : launch<T, 2>(a, B, splits, smem, st);
  } else {
    err = HD % 4 == 0 ? launch<T, 4>(a, B, splits, smem, st)
                      : launch<T, 2>(a, B, splits, smem, st);
  }
  if (err != cudaSuccess) return (int)err;
  if (splits > 1) {
    paged_attn_merge_kernel<<<dim3(NH, B), 128, 0, st>>>(
        a.part_ml, a.part_acc, NH, KVH, HD, splits, static_cast<QType<T>*>(a.out));
    err = cudaGetLastError();
  }
  return (int)err;
}

Args make_args(const void* q, const void* k_pools, const void* v_pools,
               const int* block_table, const int* pos, const void* cur_k,
               const void* cur_v, const void* win_k, const void* win_v,
               void* out, float* part_ml, float* part_acc, int NH, int KVH,
               int HD, int P, int page, int maxp, int stacked, int win_q,
               int win_count) {
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
  return a;
}

}  // namespace

// q [B,1,NH,HD]; pools [NL,P,KVH,page,HD] (NL = 1 in plain mode), read at
// layer `layer`; block_table [B,maxp] and pos [B] int32 on the device.
// stacked != 0: the pools hold tokens < pos and cur_k/cur_v are appended;
// win_q > 0 (stacked only): window rows win_k/win_v, the first win_count
// visible.  part_ml/part_acc: scratch of B*KVH*splits*G*(2 | HD) floats.
extern "C" int l3t_paged_attention_f32(
    const float* q, const float* k_pools, const float* v_pools,
    const int* block_table, const int* pos, const float* cur_k,
    const float* cur_v, const float* win_k, const float* win_v, float* out,
    float* part_ml, float* part_acc, int B, int NH, int KVH, int HD, int P,
    int page, int maxp, int layer, int stacked, int win_q, int win_count,
    int splits, int device, void* stream) {
  const Args a = make_args(q, k_pools, v_pools, block_table, pos, cur_k, cur_v,
                           win_k, win_v, out, part_ml, part_acc, NH, KVH, HD, P,
                           page, maxp, stacked, win_q, win_count);
  return run<float>(a, B, layer, splits, device, stream);
}

// int8 pools with their f32 scale pools [NL,P,KVH,page]; int8 cur_k/cur_v
// with cur_ks/cur_vs [B,KVH], int8 window rows with win_ks/win_vs
// [B,KVH,win_q].  Otherwise as l3t_paged_attention_f32.
extern "C" int l3t_paged_attention_i8(
    const float* q, const int8_t* k_pools, const int8_t* v_pools,
    const float* k_scales, const float* v_scales, const int* block_table,
    const int* pos, const int8_t* cur_k, const int8_t* cur_v,
    const float* cur_ks, const float* cur_vs, const int8_t* win_k,
    const int8_t* win_v, const float* win_ks, const float* win_vs, float* out,
    float* part_ml, float* part_acc, int B, int NH, int KVH, int HD, int P,
    int page, int maxp, int layer, int stacked, int win_q, int win_count,
    int splits, int device, void* stream) {
  if (k_scales == nullptr || v_scales == nullptr ||
      (stacked && (cur_ks == nullptr || cur_vs == nullptr)) ||
      (win_q > 0 && (win_ks == nullptr || win_vs == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a = make_args(q, k_pools, v_pools, block_table, pos, cur_k, cur_v, win_k,
                     win_v, out, part_ml, part_acc, NH, KVH, HD, P, page, maxp,
                     stacked, win_q, win_count);
  a.ksp = k_scales;
  a.vsp = v_scales;
  a.cur_ks = cur_ks;
  a.cur_vs = cur_vs;
  a.win_ks = win_ks;
  a.win_vs = win_vs;
  return run<int8_t>(a, B, layer, splits, device, stream);
}

// bf16 q, pools, cur_k/cur_v, window rows and out (f32 math inside).
// Otherwise as l3t_paged_attention_f32.
extern "C" int l3t_paged_attention_bf16(
    const bf16* q, const bf16* k_pools, const bf16* v_pools,
    const int* block_table, const int* pos, const bf16* cur_k, const bf16* cur_v,
    const bf16* win_k, const bf16* win_v, bf16* out, float* part_ml,
    float* part_acc, int B, int NH, int KVH, int HD, int P, int page, int maxp,
    int layer, int stacked, int win_q, int win_count, int splits, int device,
    void* stream) {
  const Args a = make_args(q, k_pools, v_pools, block_table, pos, cur_k, cur_v,
                           win_k, win_v, out, part_ml, part_acc, NH, KVH, HD, P,
                           page, maxp, stacked, win_q, win_count);
  return run<bf16>(a, B, layer, splits, device, stream);
}
