// Flash prefill attention for Hopper (sm_90a), float32 or bf16.
//
// Replaces: llama3np_tpu/ops/kernels/flash_prefill.py, `flash_prefill` (body
// `_kernel`, pallas_call at :102).  Causal GQA self-attention for the
// start_pos == 0 prefill: q [B,L,NH,HD], k/v [B,L,KVH,HD] -> o [B,L,NH,HD],
// online softmax in f32, key tiles above the diagonal never touched.
//
// What bounds it on the H100: operations in float32, bytes in bf16.  The
// work is 4*NH*HD*L(L+1)/2 FLOPs against (2*NH + 2*KVH)*L*HD elements of
// traffic; at L=512 (tinyllama widths, f32) that is ~1.08 GFLOP a layer,
// ~16 us at the 67 TFLOP/s fp32 CUDA-core peak (TF32 stays off on the fp32
// path), against ~0.7 MB (~0.2 us).  In bf16 at llama3-8b widths it is
// 2.15 GFLOP (2.2 us at the 989 TFLOP/s bf16 tensor-core peak) against
// 10.5 MB (3.1 us): the bytes bound the published peaks, though this kernel
// computes on CUDA cores.
//
// Design.  The TPU kernel walks a sequential (q-block, kv-block) grid with
// VMEM scratch carrying (m, l, acc) across kv steps.  Here one block of 256
// threads owns one (batch, query head, tile of 64 query rows) and loops over
// the 64-key tiles up to the tile's last row itself, so the carry lives in
// registers.  It is the register-tiled form of a CUDA-core GEMM:
//  * Q (once) and each K tile are staged in shared memory transposed
//    ([HD][64], read as float4), V as it lies ([64][HD]); k/v are read as
//    they lie in [B,L,KVH,HD] (no transposes in device memory);
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
// The GQA map is h / (NH / KVH), as in the TPU kernel's index map (:109).
// bf16 mode is the TPU kernel's own semantics (:46-48, :73): q, k and v
// tiles are widened to f32 as they are staged, every product, the softmax
// and the sums stay f32 (the probabilities are never narrowed), and the
// output is rounded to bf16 once, when it is stored.  Shared memory holds
// f32 tiles either way (120 KB at HD=128, one block an SM).  wgmma/TMA and
// tensor cores are later work: TF32 would break fp32 parity, and bf16
// tensor-core products would round where the TPU kernel does not.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kTile = 64;      // query rows and keys per tile
constexpr int kPad = kTile + 4;  // transposed row stride (keeps float4 alignment)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <int DT, typename T>  // head dims per thread: HD <= 16 * DT
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
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
  const T* qb = q + (size_t)b * L * q_stride + (size_t)h * HD;
  const T* kb = k + (size_t)b * L * kv_stride + (size_t)kvh * HD;
  const T* vb = v + (size_t)b * L * kv_stride + (size_t)kvh * HD;

  for (int e = tid; e < kTile * HD; e += kThreads) {
    const int r = e / HD, d = e - r * HD;
    Qt[d * kPad + r] = q0 + r < L ? to_f(qb[(size_t)(q0 + r) * q_stride + d]) : 0.f;
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
      Kt[d * kPad + r] = ok ? to_f(kb[(size_t)(t0 + r) * kv_stride + d]) : 0.f;
      Vs[r * HD + d] = ok ? to_f(vb[(size_t)(t0 + r) * kv_stride + d]) : 0.f;
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
    T* op = o + ((size_t)b * L + row) * q_stride + (size_t)h * HD;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const int d = tx + 16 * j;
      if (d < HD) store_f(op + d, acc[i][j] / den);
    }
  }
}

template <int DT, typename T>
cudaError_t launch(const T* q, const T* k, const T* v, T* o, int B, int L,
                   int NH, int KVH, int HD, cudaStream_t st) {
  const size_t smem = ((size_t)2 * HD * kPad + (size_t)kTile * HD +
                       (size_t)kTile * kPad) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_kernel<DT, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const float scale = (float)(1.0 / sqrt((double)HD));
  dim3 grid((L + kTile - 1) / kTile, NH, B);
  flash_prefill_kernel<DT, T><<<grid, kThreads, smem, st>>>(q, k, v, o, L, NH, KVH, HD, scale);
  return cudaGetLastError();
}

template <typename T>
int run(const T* q, const T* k, const T* v, T* o, int B, int L, int NH, int KVH,
        int HD, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaGetLastError();  // clear any stale error of this runtime
  if (B < 1 || L < 1 || KVH < 1 || NH % KVH != 0 || HD < 1 || HD > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((HD + 15) / 16) {
    case 1: return (int)launch<1>(q, k, v, o, B, L, NH, KVH, HD, st);
    case 2: return (int)launch<2>(q, k, v, o, B, L, NH, KVH, HD, st);
    case 3: return (int)launch<3>(q, k, v, o, B, L, NH, KVH, HD, st);
    case 4: return (int)launch<4>(q, k, v, o, B, L, NH, KVH, HD, st);
    case 5: return (int)launch<5>(q, k, v, o, B, L, NH, KVH, HD, st);
    case 6: return (int)launch<6>(q, k, v, o, B, L, NH, KVH, HD, st);
    case 7: return (int)launch<7>(q, k, v, o, B, L, NH, KVH, HD, st);
    default: return (int)launch<8>(q, k, v, o, B, L, NH, KVH, HD, st);
  }
}

}  // namespace

extern "C" int l3t_flash_prefill_f32(const float* q, const float* k,
                                     const float* v, float* o, int B, int L,
                                     int NH, int KVH, int HD, int device,
                                     void* stream) {
  return run<float>(q, k, v, o, B, L, NH, KVH, HD, device, stream);
}

// As l3t_flash_prefill_f32, with bf16 q, k, v and o (f32 math inside).
extern "C" int l3t_flash_prefill_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                      const __nv_bfloat16* v, __nv_bfloat16* o,
                                      int B, int L, int NH, int KVH, int HD,
                                      int device, void* stream) {
  return run<__nv_bfloat16>(q, k, v, o, B, L, NH, KVH, HD, device, stream);
}
