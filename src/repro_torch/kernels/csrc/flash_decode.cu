// Single-query attention over the resident KV cache (decode) for Hopper.
//
// Replaces repro/kernels/flash_decode.py::_decode_kernel (the Pallas TPU
// kernel behind repro.kernels.ops.flash_decode).  Same contract: q
// (B, KV, G, hd), the G query heads of one kv head; k/v (B, KV, S, hd) read
// in place in the cache layout; an additive fp32 bias (0 for attendable
// slots, -1e30 for masked ones) that carries the causal, window and ring
// masks, one row per batch element bias_stride floats apart (the wrapper
// passes one (S,) row with stride 0, since every row decodes the same
// position; the TPU wrapper broadcasts that row to (B, S)); scale
// 1/sqrt(hd), then softcap tanh(s/c)*c, then the bias; fp32 online softmax;
// output divided by max(l, 1e-20) in the input type.  Any S works: the last
// page is ragged and masked here, so the TPU wrapper's padding of S to whole
// pages and of G to MIN_GROUP are gone.
//
// Design (a simple kernel that is right first): one block of 256 threads
// per (batch row, kv head) walks the cache in 64-slot pages.  Each page of
// K and V is staged once in shared memory as fp32 (row stride hd + 1) and
// serves all G query heads of that kv head; a page whose bias is masked in
// every slot is skipped before it is read, as _decode_kernel skips it.
// Scores, then one warp per query head for the softmax update, then each
// thread owns up to 8 of the G*hd fp32 accumulators in registers.
//
// What bounds it on the card: memory.  Per layer it must read the live
// part of K and V, 2*B*KV*S*hd*2 bytes in bf16: about 8.9 MB at B=4, KV=8,
// S=544, hd=128, or 2.7 us at 3.35 TB/s.  A single pass over the pages
// gives only B*KV blocks (32 at that shape, on 132 SMs), so it cannot
// reach that rate; split-K over pages with a combine pass is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int PAGE = 64;
constexpr int THREADS = 256;
constexpr int MAX_OUT = 8;           // accumulators per thread: G*hd <= 2048
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int HD>
size_t smem_bytes(int G) {
  return sizeof(float) * (2 * PAGE * (HD + 1) + G * HD + G * PAGE + 3 * G);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
decode_fwd(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ bias,
           T* __restrict__ out, int KV, int G, int S, long long bias_stride,
           float scale, float softcap) {
  constexpr int LD = HD + 1;
  extern __shared__ float smem[];
  float* k_s = smem;                 // PAGE x LD
  float* v_s = k_s + PAGE * LD;      // PAGE x LD
  float* q_s = v_s + PAGE * LD;      // G x HD
  float* p_s = q_s + G * HD;         // G x PAGE: scores, then probabilities
  float* m_s = p_s + G * PAGE;       // running max per query head
  float* l_s = m_s + G;              // running sum per query head
  float* a_s = l_s + G;              // this page's rescale factor

  const int bkv = blockIdx.x;        // b * KV + kv head
  const int b = bkv / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_out = G * HD;
  const T* qb = q + (long)bkv * n_out;
  const T* kb = k + (long)bkv * S * HD;
  const T* vb = v + (long)bkv * S * HD;
  // bias_stride is always 0 today, but dropping it and indexing `bias`
  // directly made this kernel 36% slower on an H100 (0.0716 -> 0.0976 ms
  // at the serving shape, same registers; PERF.md): keep it until the
  // split-K rewrite, and time that change.
  const float* bb = bias + (long)b * bias_stride;

  for (int i = tid; i < n_out; i += THREADS) q_s[i] = to_f(qb[i]);
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  float acc[MAX_OUT];
#pragma unroll
  for (int o = 0; o < MAX_OUT; ++o) acc[o] = 0.f;

  for (int p0 = 0; p0 < S; p0 += PAGE) {
    const int n = min(PAGE, S - p0);
    // a page whose every slot is masked contributes nothing: skip it (the
    // barrier also retires the previous page's readers of k_s/v_s/p_s)
    const bool live = tid < n && bb[p0 + tid] > 0.5f * NEG_INF;
    if (!__syncthreads_or(live)) continue;
    for (int i = tid; i < n * HD; i += THREADS) {
      const int r = i / HD, d = i % HD;
      k_s[r * LD + d] = to_f(kb[(long)(p0 + r) * HD + d]);
      v_s[r * LD + d] = to_f(vb[(long)(p0 + r) * HD + d]);
    }
    __syncthreads();

    for (int i = tid; i < G * PAGE; i += THREADS) {
      const int g = i / PAGE, j = i % PAGE;
      float s = -INFINITY;           // slots past S do not exist
      if (j < n) {
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) dot = fmaf(q_s[g * HD + d], k_s[j * LD + d], dot);
        s = dot * scale;
        if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
        s += bb[p0 + j];
      }
      p_s[i] = s;
    }
    __syncthreads();

    for (int g = warp; g < G; g += THREADS / 32) {
      float* pr = p_s + g * PAGE;
      float mx = fmaxf(pr[lane], pr[lane + 32]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float e0 = expf(pr[lane] - m_new), e1 = expf(pr[lane + 32] - m_new);
      pr[lane] = e0;
      pr[lane + 32] = e1;
      float sum = e0 + e1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int o = 0; o < MAX_OUT; ++o) {
      const int i = tid + o * THREADS;
      if (i < n_out) {
        const int g = i / HD, d = i % HD;
        const float* pr = p_s + g * PAGE;
        float a = acc[o] * a_s[g];
        for (int j = 0; j < n; ++j) a = fmaf(pr[j], v_s[j * LD + d], a);
        acc[o] = a;
      }
    }
  }
  __syncthreads();                   // l_s is final

#pragma unroll
  for (int o = 0; o < MAX_OUT; ++o) {
    const int i = tid + o * THREADS;
    if (i < n_out)
      out[(long)bkv * n_out + i] = from_f<T>(acc[o] / fmaxf(l_s[i / HD], 1e-20f));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* out, int B, int KV, int G, int S, long long bias_stride,
           float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>(G);
  cudaError_t err = cudaFuncSetAttribute(
      decode_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_fwd<T, HD><<<B * KV, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<T*>(out), KV, G, S,
      bias_stride, 1.0f / sqrtf((float)HD), softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  bias_stride: floats between the bias
// rows of two batch elements (0 when one row serves the batch).  G * hd
// above MAX_OUT * THREADS accumulators is refused.  Returns a cudaError_t
// (0 = launched).
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  const void* bias, void* out, int B, int KV,
                                  int G, int S, int hd, long long bias_stride,
                                  float softcap, int dtype, void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || S <= 0 || G * hd > MAX_OUT * THREADS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  if (dtype == 0 && hd == 64)
    return launch<float, 64>(q, k, v, bf, out, B, KV, G, S, bias_stride, softcap, s);
  if (dtype == 0 && hd == 128)
    return launch<float, 128>(q, k, v, bf, out, B, KV, G, S, bias_stride, softcap, s);
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, bf, out, B, KV, G, S, bias_stride, softcap, s);
  if (dtype == 1 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, bf, out, B, KV, G, S, bias_stride, softcap, s);
  return (int)cudaErrorInvalidValue;
}
