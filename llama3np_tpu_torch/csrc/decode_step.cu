// Fused batch-1 decode step for Hopper (sm_90a): all layers of one token,
// with float32 weights, int8 weights and per-output-column f32 scales, or
// bf16 weights, activations and caches.
//
// Replaces: llama3np_tpu/ops/kernels/decode_step.py, `decode_layers` (:917)
// in its whole-layer form (`make_decode_kernel` :266, pallas_call at :992),
// and so the math its FFN-blocked / KV-head-grouped / streamed TPU layouts
// (:417, :563, :793) share; the int8 mode is the streamed layout's
// (`_streamed_decode_layers` :793 with its scale blocks, pallas_call :899):
// the bf16 mode follows the streamed layout's rounding points
// (`make_streamed_kernel` :629, its body :659-788):
// per layer RMSNorm -> fused QKV -> split-halves
// RoPE -> attention over the cache masked to kv_idx < pos with the current
// token appended as an explicit column -> o-proj + residual -> RMSNorm ->
// SwiGLU + residual, emitting the new K/V rows for position `pos`.
//
// What bounds it on the H100: bytes.  Each token reads every layer weight
// once (fp32: 23.9 MB for stories15M, 3.88 GB for tinyllama-1.1b; int8 a
// quarter of that plus 4 bytes of scale per output column; bf16: 13.96 GB
// for llama3-8b), plus 2*KVH*HD cache elements per layer and position, at
// 1 FLOP per 2 bytes (fp32), 1 per byte (bf16) or 2 per byte (int8): far
// below the card's ratio of compute to bandwidth.  The floor is bytes /
// 3.35 TB/s (~1.16 ms a token at tinyllama widths in fp32, ~0.29 ms in
// int8, ~4.17 ms at llama3-8b in bf16).
//
// Design.  The TPU kernel walks the layers as one sequential grid with all
// of a layer resident in VMEM.  A GPU needs the weight stream spread across
// all SMs instead, so the C entry below loops over layers on the host and
// launches seven or eight small kernels a layer, each across the card:
//   1. residual + RMSNorm (one block): x = base + sum of the previous
//      GEMV's partial sums; writes x and x*rsqrt(mean(x^2)+eps)*w;
//   2. GEMV x_norm @ wqkv;
//   3. attention over (KV head, chunk of cache rows) blocks: each sums the
//      QKV partials of its G query heads and its KV head, applies
//      split-halves RoPE (cos/sin for `pos` only), scores its rows once for
//      all G heads, softmax, P.V; chunk 0 also takes the appended (k_rot,
//      v_new) column.  Chunks give the card ~2 blocks per SM at long
//      positions ("split-K" over positions, as flash-decoding does);
//   3b. when there is more than one chunk, a merge of the chunks' partial
//      (max, sum, P.V) per query head;
//   4. GEMV attn @ wo;  5. residual + RMSNorm;  6. GEMV z_norm @ wgu;
//   7. GEMV silu(gate)*up @ w_down, the SwiGLU taken in its prologue.
// The GEMVs are hand-written: weights are [in, out] row-major, each lane
// reads 16 bytes of a row (a float4, or 16 int8 weights), so a warp reads
// 128 (fp32) or 512 (int8) neighbouring output columns of one row as 512
// contiguous bytes; 8 warps take interleaved rows, and when the columns
// alone give too few blocks the rows are split across blocks too
// ("split-K": up to 16 splits in fp32, 32 in int8, whose blocks hold 4x
// the columns), each split writing its own partial sums; the consumer adds
// the partials in a fixed order, so results are deterministic.  No
// atomics, no cuBLAS.
// int8 mode: a lane widens its 16 weights to f32 with byte permutes (the
// float whose bits are 0x4B0000uu is 2^23 + uu, exact, at full ALU rate,
// where an I2F conversion runs at a quarter of it) and multiplies them by
// the f32 activations, which are never narrowed (the TPU kernel's bf16 cast
// in `_wdot` :241 was an MXU dtype rule; the XLA int8 path, the numerics
// oracle, keeps f32).  The per-column scale multiplies each split's
// finished partial sum in the GEMV's epilogue: (sum of partials) * s equals
// the sum of (partial * s) up to rounding, so the consumers (the
// residual+RMSNorm, the attention prologue, the SwiGLU prologue) read
// scaled partials and stay as they are, and the gate/up scale is in place
// before SiLU.
// bf16 mode: a lane reads 8 bf16 weights as one 16-byte vector (a bf16 is
// the high half of its float, so widening is a shift), 32 row splits as in
// int8 (a warp covers 256 columns).  The rounding points are the streamed
// TPU layout's: x enters in bf16 and is widened; RMSNorm, the QKV sums, RoPE
// and attention are f32 (cache rows widened, f32 scores and softmax, the
// current token appended as its f32 k_rot/v_new column); every GEMV rounds
// its activation to bf16 in its prologue (`_wdot` :248: the normed x, the
// attention output, silu(gate)*up) and sums in f32; the new K/V rows are
// stored as bf16 (:713-714); the o-projection and the FFN accumulate over
// the layer's f32 residual, which is rounded to bf16 once, at the end of
// the layer (`x_out_ref` :788): the next layer's residual+RMSNorm rounds
// what it stores, and the last one writes x_out in bf16.  Activations in
// shared memory and the partial sums stay f32.
// The cache is updated in place: chunk 0 of each KV head writes k_rot and
// v_new into row `pos`, and attention never reads row `pos` (it masks
// kv_idx < pos), so the write cannot race a read; pos = 0 attends only the
// appended column; pos = M-1 writes the last row.
// Numerics follow the TPU kernel: f32 throughout (bf16 at the points
// above), the RMS scale multiplied in before the weight (_rms_scale :235),
// SiLU as g/(1+exp(-g)) (:261), residuals summed in f32.  CUDA graphs and
// wgmma are later work; the launch count per token (7 or 8 a layer, plus
// one) is this design's cost at small widths.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kMaxSplit = 16;    // max row splits of one fp32 GEMV
constexpr int kMaxSplitI8 = 32;  // int8: 4x the columns a block, more splits
constexpr int kGemvThreads = 256;
constexpr int kGemvRowGroups = kGemvThreads / 32;

// Weights a lane reads as one 16-byte vector: 4 floats, 8 bf16 or 16 int8.
template <typename W>
constexpr int kVec = 16 / (int)sizeof(W);

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(bf16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// A GEMV's activation as its product sees it: rounded to bf16 before a bf16
// weight (the TPU kernel's x.astype(w.dtype)), f32 otherwise.
template <typename W>
__device__ __forceinline__ float act_in(float v) {
  return sizeof(W) == 2 ? round_bf16(v) : v;
}

// Four consecutive elements of a cache row, widened (8-byte aligned in bf16).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void load_w(const float* p, float (&w)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
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
  const int4 v = __ldg(reinterpret_cast<const int4*>(p));
  i8x4_to_f32(v.x, w);
  i8x4_to_f32(v.y, w + 4);
  i8x4_to_f32(v.z, w + 8);
  i8x4_to_f32(v.w, w + 12);
}

// Eight bf16 weights -> floats: a bf16 is the high half of its float.
__device__ __forceinline__ void load_w(const bf16* p, float (&w)[8]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[2 * i] = __uint_as_float(u[i] << 16);
    w[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
constexpr int kAttnThreads = 256;
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr int kNormThreads = 1024;
constexpr int kAttnMaxSplit = 64;  // max position splits of attention
constexpr int kAttnMinRows = 16;   // cache rows a split takes at least

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

// store = base + sum_s part[s] (rounded to bf16 when round_store: the end
// of a bf16 layer); if w: xn = store * rsqrt(mean(store^2)+eps) * w.
// TB/TN/TS: the types of base, the norm weight and store (float or bf16).
template <typename TB, typename TN, typename TS>
__global__ void __launch_bounds__(kNormThreads)
residual_rmsnorm_kernel(const TB* __restrict__ base,
                        const float* __restrict__ part, int ks, int D,
                        const TN* __restrict__ w, float eps, int round_store,
                        TS* __restrict__ store, float* __restrict__ xn) {
  __shared__ float red[32];
  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    float o = 0.f;
    for (int s = 0; s < ks; ++s) o += part[(size_t)s * D + i];
    float x = to_f(base[i]) + o;
    if (round_store) x = round_bf16(x);
    store_f(store + i, x);
    ss += x * x;
  }
  if (w == nullptr) return;
  const float rs = rsqrtf(block_sum(ss, red) / D + eps);
  for (int i = threadIdx.x; i < D; i += blockDim.x)
    xn[i] = to_f(store[i]) * rs * to_f(w[i]);
}

enum { kPlain = 0, kSwiglu = 1 };

// out_part[blockIdx.y, c] = (sum over rows r of split blockIdx.y of
// in[r] * W[r, c]) * wscale[c] (no scale for float weights).
// kPlain: in = vec[K].  kSwiglu: vec holds ks_in partial rows of [gate | up]
// ([ks_in][2K]) and in = silu(gate) * up.  Before bf16 weights, in is
// rounded to bf16 (act_in).
template <int MODE, typename W>
__global__ void __launch_bounds__(kGemvThreads)
gemv_kernel(const W* __restrict__ Wt, const float* __restrict__ wscale, int K,
            int N, int rows_per_split, const float* __restrict__ vec,
            int ks_in, float* __restrict__ out_part) {
  constexpr int V = kVec<W>;
  constexpr int kCols = 32 * V;  // output columns of a block
  extern __shared__ float smem[];
  const int rps_al = (rows_per_split + 3) & ~3;
  float* xs = smem;             // [rows_per_split] input slice
  float* red = smem + rps_al;   // [row groups][kCols] partial column sums
  const int k0 = blockIdx.y * rows_per_split;
  const int nk = min(rows_per_split, K - k0);
  for (int i = threadIdx.x; i < nk; i += kGemvThreads) {
    if (MODE == kPlain) {
      xs[i] = act_in<W>(vec[k0 + i]);
    } else {
      float g = 0.f, u = 0.f;
      for (int s = 0; s < ks_in; ++s) {
        g += vec[(size_t)s * 2 * K + k0 + i];
        u += vec[(size_t)s * 2 * K + K + k0 + i];
      }
      xs[i] = act_in<W>(g * (1.f / (1.f + expf(-g))) * u);
    }
  }
  __syncthreads();

  const int cx = threadIdx.x & 31, ry = threadIdx.x >> 5;
  const int col = blockIdx.x * kCols + cx * V;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  if (col < N) {  // N % V == 0: the whole vector is in range
    const W* wp = Wt + (size_t)k0 * N + col;
#pragma unroll 4
    for (int r = ry; r < nk; r += kGemvRowGroups) {
      float w[V];
      load_w(wp + (size_t)r * N, w);
      const float a = xs[r];
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = fmaf(a, w[j], acc[j]);
    }
  }
  float4* rr = reinterpret_cast<float4*>(red + ry * kCols + cx * V);
#pragma unroll
  for (int j = 0; j < V / 4; ++j)
    rr[j] = make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
  __syncthreads();
  for (int c0 = threadIdx.x; c0 < kCols; c0 += kGemvThreads) {
    const int c = blockIdx.x * kCols + c0;
    if (c < N) {
      float s = 0.f;
      for (int r = 0; r < kGemvRowGroups; ++r) s += red[r * kCols + c0];
      out_part[(size_t)blockIdx.y * N + c] = wscale != nullptr ? s * wscale[c] : s;
    }
  }
}

// Attention of the G query heads of one KV head over one chunk of cache
// rows.  grid (KVH, S): block (kh, s) takes rows [s*chunk, min(pos,
// (s+1)*chunk)); split 0 also takes the appended column (this token's own
// k_rot, v_new) and writes them into row pos.  With S == 1 it writes the
// normalized output; otherwise its (max, sum, unnormalized P.V) partials,
// which attn_combine_kernel merges.  kc/vc: this layer's cache [KVH][M][HD]
// of T (float, or bf16 widened as it is read and rounded as it is written).
template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
attn_split_kernel(const float* __restrict__ qkv_part, int ks, int qkvd,
                  int NH, int KVH, int HD,
                  const float* __restrict__ cos_row,
                  const float* __restrict__ sin_row,
                  T* kc, T* vc, int M, int pos, int chunk, float scale,
                  float* __restrict__ attn_out, float* __restrict__ part_ml,
                  float* __restrict__ part_acc) {
  extern __shared__ float smem[];
  const int kh = blockIdx.x, s = blockIdx.y, S = gridDim.y;
  const int G = NH / KVH;
  const int half = HD / 2;
  const int qd = NH * HD, kvd = KVH * HD;
  const int qs = HD + 1;               // padded query row: no bank conflicts
  const int cw = chunk + 1;            // score row: chunk rows + appended column
  float* qv = smem;                    // [G][HD+1] rotated queries
  float* kv = qv + G * qs;             // [HD] rotated new key
  float* vv = kv + HD;                 // [HD] new value
  float* red_m = vv + HD;              // [G] softmax max
  float* red_l = red_m + G;            // [G] softmax sum
  float* sc = red_l + G;               // [G][chunk+1] scores, then probabilities
  const int tid = threadIdx.x;

  auto colsum = [&](int c) {
    float a = 0.f;
    for (int i = 0; i < ks; ++i) a += qkv_part[(size_t)i * qkvd + c];
    return a;
  };
  for (int e = tid; e < G * half; e += kAttnThreads) {  // split-halves RoPE
    const int g = e / half, j = e - g * half;
    const float c = cos_row[j], sn = sin_row[j];
    const int col = (kh * G + g) * HD + j;
    const float a = colsum(col), b = colsum(col + half);
    qv[g * qs + j] = a * c - b * sn;
    qv[g * qs + j + half] = a * sn + b * c;
  }
  for (int j = tid; j < half; j += kAttnThreads) {
    const float c = cos_row[j], sn = sin_row[j];
    const float a = colsum(qd + kh * HD + j), b = colsum(qd + kh * HD + j + half);
    kv[j] = a * c - b * sn;
    kv[j + half] = a * sn + b * c;
  }
  for (int d = tid; d < HD; d += kAttnThreads) vv[d] = colsum(qd + kvd + kh * HD + d);
  __syncthreads();

  T* krow = kc + (size_t)kh * M * HD;
  T* vrow = vc + (size_t)kh * M * HD;
  if (s == 0) {  // one writer per KV head; no block reads row pos
    for (int d = tid; d < HD; d += kAttnThreads) {
      store_f(krow + (size_t)pos * HD + d, kv[d]);
      store_f(vrow + (size_t)pos * HD + d, vv[d]);
    }
  }

  const int j0 = s * chunk;
  const int n = max(0, min(pos, j0 + chunk) - j0);  // cache rows of this split
  const int n_all = n + (s == 0 ? 1 : 0);           // + the appended column
  // Scores: neighbouring threads take the G heads of one row, so each K row
  // is fetched once and broadcast.
  for (int e = tid; e < G * n; e += kAttnThreads) {
    const int g = e % G, r = e / G;
    const T* kr = krow + (size_t)(j0 + r) * HD;
    const float* q = qv + g * qs;
    float acc = 0.f;
    for (int i = 0; i < HD / 4; ++i) {
      const float4 kk = load4(kr + 4 * i);
      acc = fmaf(q[4 * i], kk.x, acc);
      acc = fmaf(q[4 * i + 1], kk.y, acc);
      acc = fmaf(q[4 * i + 2], kk.z, acc);
      acc = fmaf(q[4 * i + 3], kk.w, acc);
    }
    sc[g * cw + r] = acc * scale;
  }
  if (s == 0) {
    for (int g = tid; g < G; g += kAttnThreads) {
      float acc = 0.f;
      for (int d = 0; d < HD; ++d) acc = fmaf(qv[g * qs + d], kv[d], acc);
      sc[g * cw + n] = acc * scale;
    }
  }
  __syncthreads();

  // Softmax of each head's row, one warp per head.
  const int warp = tid >> 5, lane = tid & 31;
  for (int g = warp; g < G; g += kAttnWarps) {
    float mx = -INFINITY;
    for (int r = lane; r < n_all; r += 32) mx = fmaxf(mx, sc[g * cw + r]);
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int r = lane; r < n_all; r += 32) {
      const float e = expf(sc[g * cw + r] - mx);
      sc[g * cw + r] = e;
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
  for (int o = tid; o < G * HD; o += kAttnThreads) {
    const int g = o / HD, d = o - g * HD;
    const float* p = sc + g * cw;
    float acc = 0.f;
    for (int r = 0; r < n; ++r) acc = fmaf(p[r], to_f(vrow[(size_t)(j0 + r) * HD + d]), acc);
    if (s == 0) acc = fmaf(p[n], vv[d], acc);
    if (S == 1) {
      attn_out[(kh * G + g) * HD + d] = acc / red_l[g];
    } else {
      part_acc[((size_t)(kh * S + s) * G + g) * HD + d] = acc;
    }
  }
  if (S > 1) {
    for (int g = tid; g < G; g += kAttnThreads) {
      part_ml[((size_t)(kh * S + s) * G + g) * 2] = red_m[g];
      part_ml[((size_t)(kh * S + s) * G + g) * 2 + 1] = red_l[g];
    }
  }
}

// Merge the S splits of each query head: rescale each split's sum and P.V
// to the common max.  Split 0 holds the appended column, so the max is
// finite; an empty split has max -inf and weighs 0.
__global__ void __launch_bounds__(128)
attn_combine_kernel(const float* __restrict__ part_ml,
                    const float* __restrict__ part_acc, int NH, int KVH,
                    int HD, int S, float* __restrict__ attn_out) {
  const int h = blockIdx.x;
  const int G = NH / KVH, kh = h / G, g = h - kh * G;
  const size_t base = (size_t)kh * S * G + g;  // (kh, s=0, g); stride G per split
  float mx = -INFINITY;
  for (int s = 0; s < S; ++s) mx = fmaxf(mx, part_ml[(base + (size_t)s * G) * 2]);
  for (int d = threadIdx.x; d < HD; d += blockDim.x) {
    float l = 0.f, a = 0.f;
    for (int s = 0; s < S; ++s) {
      const size_t i = base + (size_t)s * G;
      const float w = expf(part_ml[i * 2] - mx);
      l = fmaf(part_ml[i * 2 + 1], w, l);
      a = fmaf(part_acc[i * HD + d], w, a);
    }
    attn_out[h * HD + d] = a / l;
  }
}

int g_num_sms = 0;

int num_sms(int device) {
  if (g_num_sms == 0) {
    cudaDeviceGetAttribute(&g_num_sms, cudaDevAttrMultiProcessorCount, device);
    if (g_num_sms <= 0) g_num_sms = 132;
  }
  return g_num_sms;
}

// Launch one GEMV with enough row splits to give ~2 blocks per SM; returns
// the number of splits (partial rows written) through *ks_out.
template <int MODE, typename W>
cudaError_t launch_gemv(const W* Wt, const float* wscale, int K, int N,
                        const float* vec, int ks_in, float* out_part,
                        int* ks_out, int sms, cudaStream_t st) {
  constexpr int kCols = 32 * kVec<W>;
  constexpr int kSplits = sizeof(W) == 4 ? kMaxSplit : kMaxSplitI8;
  const int nb = (N + kCols - 1) / kCols;
  int ks = (2 * sms + nb - 1) / nb;
  ks = max(1, min(ks, min(kSplits, K / 32)));
  const int rps = (K + ks - 1) / ks;
  ks = (K + rps - 1) / rps;
  const size_t smem = (((rps + 3) & ~3) + kGemvRowGroups * kCols) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gemv_kernel<MODE, W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(nb, ks);
  gemv_kernel<MODE, W><<<grid, kGemvThreads, smem, st>>>(Wt, wscale, K, N, rps, vec,
                                                         ks_in, out_part);
  *ks_out = ks;
  return cudaGetLastError();
}

// Every layer of one token; W = float, or int8_t with the per-column scales
// s_* ([NL][N] each; null otherwise), or bf16.  T: the type of the norms,
// x_in/x_out and the caches (float, or bf16 with bf16 weights).
template <typename W, typename T>
int decode_layers(const W* wqkv, const W* wo, const W* wgu, const W* wdown,
                  const float* s_qkv, const float* s_o, const float* s_gu,
                  const float* s_dn, const T* attn_norm,
                  const T* ffn_norm, const T* x_in, T* x_out,
                  T* k_cache, T* v_cache, const float* cos_row,
                  const float* sin_row, float* scratch, int nl, int d, int nh,
                  int kvh, int hd, int fd, int m, int pos, float eps,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaGetLastError();  // clear any stale error of this runtime
  const int qd = nh * hd, kvd = kvh * hd, qkvd = qd + 2 * kvd;
  if (hd % 4 != 0 || hd > 128 || kvh < 1 || nh % kvh != 0 || d % 4 != 0 ||
      fd % 2 != 0 || pos < 0 || pos >= m)
    return (int)cudaErrorInvalidValue;
  constexpr int V = kVec<W>;  // whole, aligned 16-byte vectors
  if (qkvd % V != 0 || d % V != 0 || (2 * fd) % V != 0)
    return (int)cudaErrorInvalidValue;
  constexpr int kRound = sizeof(T) == 2;  // bf16: the layer's end rounds
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sms = num_sms(device);

  float* xn = scratch;          // [d] normalized input of the next GEMV
  float* x_store = xn + d;      // [d] residual stream after attention input
  float* h_buf = x_store + d;   // [d] residual stream after the FFN input
  float* attn = h_buf + d;      // [qd]
  float* qkv_p = attn + qd;     // [kMaxSplitI8][qkvd]
  float* o_p = qkv_p + (size_t)kMaxSplitI8 * qkvd;    // [kMaxSplitI8][d]
  float* gu_p = o_p + (size_t)kMaxSplitI8 * d;        // [kMaxSplitI8][2fd]
  float* dn_p = gu_p + (size_t)kMaxSplitI8 * 2 * fd;  // [kMaxSplitI8][d]
  float* at_ml = dn_p + (size_t)kMaxSplitI8 * d;      // [KVH][S][G][2]
  float* at_acc = at_ml + (size_t)kAttnMaxSplit * nh * 2;  // [KVH][S][G][hd]

  const float scale = (float)(1.0 / sqrt((double)hd));
  // Attention splits: ~2 blocks per SM over (KV head, position chunk), each
  // chunk at least kAttnMinRows rows; short caches take one split.
  const int G = nh / kvh;
  int S = (pos + kAttnMinRows - 1) / kAttnMinRows;
  S = max(1, min(S, min(kAttnMaxSplit, (2 * sms + kvh - 1) / kvh)));
  const int chunk = S == 1 ? pos : (pos + S - 1) / S;
  const size_t attn_smem =
      (size_t)(G * (hd + 1) + 2 * hd + 2 * G + G * (chunk + 1)) * sizeof(float);
  if (attn_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(attn_split_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)attn_smem);
    if (err != cudaSuccess) return (int)err;
  }
  auto layer_scale = [](const float* s, int l, int n) {
    return s == nullptr ? nullptr : s + (size_t)l * n;
  };

  int ks_dn = 0, ks_qkv = 0, ks_o = 0, ks_gu = 0;
  for (int l = 0; l < nl; ++l) {
    const W* Wqkv = wqkv + (size_t)l * d * qkvd;
    const W* Wo = wo + (size_t)l * qd * d;
    const W* Wgu = wgu + (size_t)l * d * 2 * fd;
    const W* Wdn = wdown + (size_t)l * fd * d;
    T* kc = k_cache + (size_t)l * kvh * m * hd;
    T* vc = v_cache + (size_t)l * kvh * m * hd;

    // The residual stream entering the layer: x_in, then the previous
    // layer's (rounded to bf16 in bf16 mode, as the TPU kernel's x_out).
    if (l == 0) {
      residual_rmsnorm_kernel<<<1, kNormThreads, 0, st>>>(
          x_in, dn_p, 0, d, attn_norm, eps, kRound, x_store, xn);
    } else {
      residual_rmsnorm_kernel<<<1, kNormThreads, 0, st>>>(
          h_buf, dn_p, ks_dn, d, attn_norm + (size_t)l * d, eps, kRound, x_store, xn);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if ((err = launch_gemv<kPlain>(Wqkv, layer_scale(s_qkv, l, qkvd), d, qkvd, xn,
                                   0, qkv_p, &ks_qkv, sms, st)) != cudaSuccess)
      return (int)err;
    attn_split_kernel<<<dim3(kvh, S), kAttnThreads, attn_smem, st>>>(
        qkv_p, ks_qkv, qkvd, nh, kvh, hd, cos_row, sin_row, kc, vc, m, pos,
        chunk, scale, attn, at_ml, at_acc);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (S > 1) {
      attn_combine_kernel<<<nh, 128, 0, st>>>(at_ml, at_acc, nh, kvh, hd, S, attn);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    if ((err = launch_gemv<kPlain>(Wo, layer_scale(s_o, l, d), qd, d, attn, 0, o_p,
                                   &ks_o, sms, st)) != cudaSuccess)
      return (int)err;
    residual_rmsnorm_kernel<<<1, kNormThreads, 0, st>>>(
        x_store, o_p, ks_o, d, ffn_norm + (size_t)l * d, eps, 0, h_buf, xn);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if ((err = launch_gemv<kPlain>(Wgu, layer_scale(s_gu, l, 2 * fd), d, 2 * fd, xn,
                                   0, gu_p, &ks_gu, sms, st)) != cudaSuccess)
      return (int)err;
    if ((err = launch_gemv<kSwiglu>(Wdn, layer_scale(s_dn, l, d), fd, d, gu_p, ks_gu,
                                    dn_p, &ks_dn, sms, st)) != cudaSuccess)
      return (int)err;
  }
  residual_rmsnorm_kernel<<<1, kNormThreads, 0, st>>>(
      h_buf, dn_p, ks_dn, d, static_cast<const T*>(nullptr), eps, kRound, x_out, nullptr);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of scratch the C entries below need for these widths.
extern "C" long l3t_decode_scratch_floats(int d, int nh, int kvh, int hd, int fd) {
  const long qd = (long)nh * hd, qkvd = qd + 2L * kvh * hd;
  return 3L * d + qd + kMaxSplitI8 * (qkvd + d + 2L * fd + d) +
         (long)kAttnMaxSplit * nh * (hd + 2);
}

extern "C" int l3t_decode_layers_f32(
    const float* wqkv, const float* wo, const float* wgu, const float* wdown,
    const float* attn_norm, const float* ffn_norm, const float* x_in,
    float* x_out, float* k_cache, float* v_cache, const float* cos_row,
    const float* sin_row, float* scratch, int nl, int d, int nh, int kvh,
    int hd, int fd, int m, int pos, float eps, int device, void* stream) {
  return decode_layers<float, float>(wqkv, wo, wgu, wdown, nullptr, nullptr, nullptr,
                              nullptr, attn_norm, ffn_norm, x_in, x_out, k_cache,
                              v_cache, cos_row, sin_row, scratch, nl, d, nh, kvh,
                              hd, fd, m, pos, eps, device, stream);
}

// int8 weights ([in, out] row-major like the float ones) with their
// per-output-column f32 scales [NL][out].
extern "C" int l3t_decode_layers_i8(
    const int8_t* wqkv, const int8_t* wo, const int8_t* wgu,
    const int8_t* wdown, const float* s_qkv, const float* s_o,
    const float* s_gu, const float* s_dn, const float* attn_norm,
    const float* ffn_norm, const float* x_in, float* x_out, float* k_cache,
    float* v_cache, const float* cos_row, const float* sin_row,
    float* scratch, int nl, int d, int nh, int kvh, int hd, int fd, int m,
    int pos, float eps, int device, void* stream) {
  return decode_layers<int8_t, float>(wqkv, wo, wgu, wdown, s_qkv, s_o, s_gu, s_dn,
                               attn_norm, ffn_norm, x_in, x_out, k_cache, v_cache,
                               cos_row, sin_row, scratch, nl, d, nh, kvh, hd, fd,
                               m, pos, eps, device, stream);
}

// bf16 weights ([in, out] row-major), norms, x_in/x_out and caches; cos/sin
// rows and scratch f32.  Otherwise as l3t_decode_layers_f32.
extern "C" int l3t_decode_layers_bf16(
    const bf16* wqkv, const bf16* wo, const bf16* wgu, const bf16* wdown,
    const bf16* attn_norm, const bf16* ffn_norm, const bf16* x_in, bf16* x_out,
    bf16* k_cache, bf16* v_cache, const float* cos_row, const float* sin_row,
    float* scratch, int nl, int d, int nh, int kvh, int hd, int fd, int m, int pos,
    float eps, int device, void* stream) {
  return decode_layers<bf16, bf16>(wqkv, wo, wgu, wdown, nullptr, nullptr, nullptr,
                                   nullptr, attn_norm, ffn_norm, x_in, x_out, k_cache,
                                   v_cache, cos_row, sin_row, scratch, nl, d, nh, kvh,
                                   hd, fd, m, pos, eps, device, stream);
}
