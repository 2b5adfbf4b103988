// Blockwise online-softmax attention forward (prefill) for Hopper.
//
// Replaces repro/kernels/flash_attention.py::_attn_kernel (the Pallas TPU
// kernel behind repro.kernels.ops.flash_attention).  Same contract as
// repro_torch/kernels/ref.py::attention_ref: scale 1/sqrt(hd), causal
// k <= q + q_offset, window k > q + q_offset - window, masked scores set to
// -1e30 before the softmax, fp32 (m, l, acc) statistics, output divided by
// max(l, 1e-20) and written in the input type.
//
// Layout: q (B, Sq, H, hd), k/v (B, Sk, KV, hd), out (B, Sq, H, hd), all
// contiguous.  GQA is read by index (q head h uses kv head h / (H / KV)),
// so the repeat the TPU wrapper materialises never exists here.
//
// Design (a simple kernel that is right first):
//   * one block of 256 threads per (64-row q tile, head, batch row);
//   * Q, and each 64-row K/V tile, staged in shared memory as fp32 with a
//     row stride of hd + 1 so that column reads are free of bank conflicts;
//   * S = Q K^T for the tile on CUDA cores: each thread a 4x4 micro-tile
//     (rows rg + 16i, cols cg + 16j); then one row's softmax update per four
//     threads; then P V with each thread owning 4 rows x hd/16 columns of
//     the fp32 accumulator in registers;
//   * k tiles that are fully masked for the whole q tile are never visited,
//     as _attn_kernel skips them; the ragged edges (k >= Sk, q >= Sq) are
//     masked here, so the TPU wrapper's padding to block multiples and
//     shrink_block_k are not needed.
//
// What bounds it on the card: at the serving shape (B=4, S=512, H=32,
// KV=8, hd=128, causal) a layer needs about 8.6 GFLOP (8.7 us at the
// 989 TFLOP/s bf16 tensor-core peak) and moves about 42 MB (12.5 us at
// 3.35 TB/s).  This first design does its arithmetic in fp32 on CUDA
// cores (67 TFLOP/s peak, about 128 us for the same work), so its real
// limit is that arithmetic rate; mma.sync / wgmma tiles are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int LDP = BK + 1;          // row stride of the score tile
constexpr float NEG_INF = -1e30f;    // the reference's mask value

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (3 * BQ * (HD + 1) + BQ * LDP + 3 * BQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
attn_fwd(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, T* __restrict__ out,
         int Sq, int Sk, int H, int KV, int causal, int window, int q_offset,
         float scale) {
  constexpr int LD = HD + 1;
  constexpr int CPT = HD / 16;       // accumulator columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                 // BQ x LD
  float* k_s = q_s + BQ * LD;        // BK x LD
  float* v_s = k_s + BK * LD;        // BK x LD
  float* p_s = v_s + BK * LD;        // BQ x LDP: scores, then probabilities
  float* m_s = p_s + BQ * LDP;       // running max per row
  float* l_s = m_s + BQ;             // running sum per row
  float* a_s = l_s + BQ;             // this tile's rescale factor per row

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long q_row = (long)H * HD;   // elements between sequence positions
  const long kv_row = (long)KV * HD;
  const T* qb = q + ((long)b * Sq * H + h) * HD;
  const T* kb = k + ((long)b * Sk * KV + kvh) * HD;
  const T* vb = v + ((long)b * Sk * KV + kvh) * HD;
  T* ob = out + ((long)b * Sq * H + h) * HD;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    q_s[r * LD + d] = (q0 + r < Sq) ? to_f(qb[(q0 + r) * q_row + d]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  const int rg = tid / 16, cg = tid % 16;
  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  // k tiles that hold an unmasked key for some row of this q tile (the
  // same run condition as _attn_kernel, over the full 64-row tile)
  const int q_lo = q0 + q_offset, q_hi = q0 + BQ - 1 + q_offset;
  int kt_end = (Sk + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, q_hi < 0 ? 0 : q_hi / BK + 1);
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q_lo - window + 1;
    kt_begin = lo > 0 ? lo / BK : 0;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                 // last tile's readers are done
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int r = i / HD, d = i % HD;
      const bool in = k0 + r < Sk;
      k_s[r * LD + d] = in ? to_f(kb[(k0 + r) * kv_row + d]) : 0.f;
      v_s[r * LD + d] = in ? to_f(vb[(k0 + r) * kv_row + d]) : 0.f;
    }
    __syncthreads();

    // scores for rows rg + 16i, cols cg + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(rg + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(cg + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg + 16 * i;
      const int qp = q0 + r + q_offset;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cg + 16 * j;
        const int kp = k0 + c;
        bool ok = true;
        if (causal) ok = kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        // keys past Sk do not exist in the reference: -inf gives them
        // exactly zero weight; masked keys that do exist get -1e30 as there
        p_s[r * LDP + c] = kp >= Sk ? -INFINITY : (ok ? s[i][j] * scale : NEG_INF);
      }
    }
    __syncthreads();

    // online softmax: four neighbouring lanes per row, 16 columns each
    {
      const int r = tid >> 2, t = tid & 3;
      float* pr = p_s + r * LDP;
      float mx = -INFINITY;
#pragma unroll
      for (int c = t; c < BK; c += 4) mx = fmaxf(mx, pr[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = t; c < BK; c += 4) {
        const float p = expf(pr[c] - m_new);
        pr[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (t == 0) {                  // the shuffles ordered every read of m_s[r]
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[rg + 16 * i];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4], vv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(rg + 16 * i) * LDP + j];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = v_s[j * LD + cg + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }
  __syncthreads();                   // l_s is final

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg + 16 * i;
    if (q0 + r >= Sq) continue;
    const float l = fmaxf(l_s[r], 1e-20f);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      ob[(q0 + r) * q_row + cg + 16 * c] = from_f<T>(acc[i][c] / l);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int KV, int causal, int window,
           int q_offset, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  attn_fwd<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, KV, causal,
      window, q_offset, 1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int Sq,
                                     int Sk, int H, int KV, int hd, int causal,
                                     int window, int q_offset, int dtype,
                                     void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64)
    return launch<float, 64>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, q_offset, s);
  if (dtype == 0 && hd == 128)
    return launch<float, 128>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, q_offset, s);
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, q_offset, s);
  if (dtype == 1 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, q_offset, s);
  return (int)cudaErrorInvalidValue;
}
