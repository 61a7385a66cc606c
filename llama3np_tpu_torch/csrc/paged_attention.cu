// Paged decode attention for Hopper (sm_90a), float32.
//
// Replaces: llama3np_tpu/ops/kernels/paged_attention.py, `paged_attention`
// (:257; kernel body `_kernel` :66, pallas_call at :375).  One decode token
// per batch row attends the tokens its block table maps in a page pool
// [P, KVH, page, HD] (or layer `layer` of the stacked pools [NL, P, KVH,
// page, HD]), masked to kv_idx <= vlim, with the optional extra columns of
// the serving layer loop folded in: the quantum's in-flight window (columns
// s < win_count of win_k/win_v [B, KVH, Q, HD]) and the current token's
// appended column (cur_k/cur_v [B, KVH, HD]).  Out [B, 1, NH, HD].
//
// What bounds it on the H100: bytes.  Each visible token's K and V rows are
// read once for all G = NH/KVH query heads of their KV head (2*KVH*HD*4
// bytes a token), at 4*G flops per 8 bytes read: far below the card's ratio
// of compute to bandwidth.  The floor is the visible K/V (plus q and out)
// over 3.35 TB/s: ~11 MB, ~3.3 us, for 8 rows at positions up to 2047 of
// tinyllama-1.1b (KVH=4, HD=64).
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
// table entry cannot read out of bounds.  cp.async double buffering, bf16
// and int8 pools are later work (ROADMAP A8).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileTokens = 128;  // tokens a block stages at once
constexpr int kMaxOut = 8;        // (head, dim) outputs a thread owns
constexpr int kLoadUnroll = 4;    // page loads in flight per thread
constexpr int kMaxSmem = 227 * 1024;

struct Args {
  const float* q;       // [B, NH, HD]
  const float* kp;      // pool of the layer: [P, KVH, page, HD]
  const float* vp;
  const int* bt;        // [B, maxp]
  const int* pos;       // [B]
  const float* cur_k;   // [B, KVH, HD] or null
  const float* cur_v;
  const float* win_k;   // [B, KVH, win_q, HD] or null
  const float* win_v;
  float* out;           // [B, NH, HD]
  float* part_ml;       // [B, KVH, S, G, 2]
  float* part_acc;      // [B, KVH, S, G, HD]
  int NH, KVH, HD, P, page, maxp;
  int stacked, win_q, win_count;
  int pages_per_split, tile_pages;
  float scale;
};

template <int VEC>
__device__ __forceinline__ void load_vec(const float* src, float (&dst)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(src));
    dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
  } else {
    const float2 x = __ldg(reinterpret_cast<const float2*>(src));
    dst[0] = x.x; dst[1] = x.y;
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const Args a) {
  extern __shared__ float smem[];
  const int s = blockIdx.x, S = gridDim.x, kh = blockIdx.y, b = blockIdx.z;
  const int HD = a.HD, G = a.NH / a.KVH, hp = HD + 1;
  const int T = a.tile_pages * a.page;  // tile capacity in tokens
  float* qs = smem;                     // [G][HD+1]
  float* ks = qs + G * hp;              // [T][HD+1]
  float* vs = ks + T * hp;              // [T][HD+1]
  float* sc = vs + T * hp;              // [G][T] scores, then probabilities
  float* m_run = sc + G * T;            // [G] running max
  float* l_run = m_run + G;             // [G] running sum
  float* alpha = l_run + G;             // [G] rescale of this tile
  int* pids = reinterpret_cast<int*>(alpha + G);  // [tile_pages]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

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
    qs[g * hp + d] = a.q[((size_t)b * a.NH + kh * G + g) * HD + d];
  }
  for (int g = tid; g < G; g += kThreads) {
    m_run[g] = -INFINITY;
    l_run[g] = 0.f;
  }
  float acc[kMaxOut];
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) acc[i] = 0.f;
  __syncthreads();

  const int per_page = a.page * HD;  // floats of one (page, KV head) block
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
        float kr[kLoadUnroll][VEC], vr[kLoadUnroll][VEC];
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
            load_vec<VEC>(a.kp + src, kr[u]);
            load_vec<VEC>(a.vp + src, vr[u]);
            dst[u] = (pi * a.page + t) * hp + d;
          }
        }
#pragma unroll
        for (int u = 0; u < kLoadUnroll; ++u) {
          if (dst[u] >= 0) {
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              ks[dst[u] + j] = kr[u][j];
              vs[dst[u] + j] = vr[u][j];
            }
          }
        }
      }
    } else {  // split 0's extra columns: window rows s < win_count, then current
      tvis = extra;
      for (int e = tid; e < extra * HD; e += kThreads) {
        const int c = e / HD, d = e - c * HD;
        const size_t row = c < a.win_count
            ? (((size_t)b * a.KVH + kh) * a.win_q + c) * HD
            : ((size_t)b * a.KVH + kh) * HD;
        const float* kr = c < a.win_count ? a.win_k : a.cur_k;
        const float* vr = c < a.win_count ? a.win_v : a.cur_v;
        ks[c * hp + d] = kr[row + d];
        vs[c * hp + d] = vr[row + d];
      }
    }
    __syncthreads();

    // Scores: neighbouring threads take the G heads of one token.
    for (int e = tid; e < G * tvis; e += kThreads) {
      const int g = e % G, t = e / G;
      const float* qr = qs + g * hp;
      const float* kr = ks + t * hp;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
      sc[g * T + t] = dot * a.scale;
    }
    __syncthreads();

    // Online softmax, one warp a head.
    for (int g = warp; g < G; g += kWarps) {
      float* row = sc + g * T;
      float mx = -INFINITY;
      for (int t = lane; t < tvis; t += 32) mx = fmaxf(mx, row[t]);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_run[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < tvis; t += 32) {
        const float e = expf(row[t] - m_new);
        row[t] = e;
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
    // neighbouring dims of one V row.
#pragma unroll
    for (int i = 0; i < kMaxOut; ++i) {
      const int o = tid + i * kThreads;
      if (o < G * HD) {
        const int g = o / HD, d = o - g * HD;
        const float* pr = sc + g * T;
        float v = acc[i] * alpha[g];
#pragma unroll 4
        for (int t = 0; t < tvis; ++t) v = fmaf(pr[t], vs[t * hp + d], v);
        acc[i] = v;
      }
    }
    __syncthreads();
  }

  const size_t split = ((size_t)b * a.KVH + kh) * S + s;
#pragma unroll
  for (int i = 0; i < kMaxOut; ++i) {
    const int o = tid + i * kThreads;
    if (o < G * HD) {
      const int g = o / HD, d = o - g * HD;
      if (S == 1) {
        a.out[((size_t)b * a.NH + kh * G + g) * HD + d] = acc[i] / fmaxf(l_run[g], 1e-30f);
      } else {
        a.part_acc[split * G * HD + o] = acc[i];
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
__global__ void __launch_bounds__(128)
paged_attn_merge_kernel(const float* __restrict__ part_ml,
                        const float* __restrict__ part_acc, int NH, int KVH,
                        int HD, int S, float* __restrict__ out) {
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
    out[((size_t)b * NH + h) * HD + d] = acc / fmaxf(l, 1e-30f);
  }
}

template <int VEC>
cudaError_t launch(const Args& a, int B, int S, size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attn_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  paged_attn_kernel<VEC><<<dim3(S, a.KVH, B), kThreads, smem, st>>>(a);
  return cudaGetLastError();
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaGetLastError();  // clear any stale error of this runtime
  const int G = KVH > 0 ? NH / KVH : 0;
  const int tile_pages = page > 0 ? max(1, kTileTokens / page) : 0;
  if (B < 1 || KVH < 1 || NH % KVH != 0 || HD < 2 || HD > 128 || HD % 2 != 0 ||
      G * HD > kThreads * kMaxOut || P < 1 || page < 1 || page > kTileTokens ||
      maxp < 1 || layer < 0 || splits < 1 || splits > maxp ||
      (!stacked && win_q != 0) || win_q < 0 || win_count < 0 ||
      win_count > win_q || win_q + 1 > tile_pages * page)
    return (int)cudaErrorInvalidValue;
  const int T = tile_pages * page;
  const size_t smem = (size_t)((G + 2 * T) * (HD + 1) + G * T + 3 * G) * sizeof(float) +
                      (size_t)tile_pages * sizeof(int);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidConfiguration;

  const size_t layer_off = (size_t)layer * P * KVH * page * HD;
  Args a;
  a.q = q;
  a.kp = k_pools + layer_off;
  a.vp = v_pools + layer_off;
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
  a.pages_per_split = (maxp + splits - 1) / splits;
  a.tile_pages = tile_pages;
  a.scale = (float)(1.0 / sqrt((double)HD));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = HD % 4 == 0 ? launch<4>(a, B, splits, smem, st) : launch<2>(a, B, splits, smem, st);
  if (err != cudaSuccess) return (int)err;
  if (splits > 1) {
    paged_attn_merge_kernel<<<dim3(NH, B), 128, 0, st>>>(part_ml, part_acc, NH, KVH,
                                                         HD, splits, out);
    err = cudaGetLastError();
  }
  return (int)err;
}
