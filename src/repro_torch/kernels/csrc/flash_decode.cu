// Single-query attention over the resident KV cache (decode) for Hopper,
// split over the cache (split-K) with a combine pass.
//
// Replaces src/repro/kernels/flash_decode.py:49 (_decode_kernel, the
// Pallas TPU kernel behind repro.kernels.ops.flash_decode).  Same
// contract: q (B, KV, G, hd), the G query heads of one kv head; k/v
// (B, KV, S, hd) read in place in the cache layout; one decode position
// `pos` for the batch; scale 1/sqrt(hd), then softcap tanh(s/c)*c, then
// the mask (-1e30 on slots the query may not attend); fp32 online softmax;
// output divided by max(l, 1e-20) in the input type.  The mask is computed
// here from (pos, S, window, ring) with the slot -> position map of
// ref.decode_slot_positions / decode_valid, so no bias row is built or read.
// Any S works: the last page is ragged and masked here, so the TPU
// wrapper's padding of S to whole pages and of G to MIN_GROUP are gone.
//
// What bounds it on the card: memory.  A call must read the live part of
// K and V, 2*B*KV*S*hd*2 bytes in bf16: about 8.9 MB at B=4, KV=8, S=544,
// hd=128, or 2.7 us at 3.35 TB/s (3.3 MB, 1.0 us, at paligemma's B=4,
// KV=1, S=800, hd=256); its arithmetic (4 G flops a byte of K/V
// row) is far below the card's ridge.  Reaching that rate takes many
// loads in flight on every SM, which one block per (batch row, kv head)
// (32 blocks on 132 SMs at that shape) cannot give.  Measured on an H100,
// this design is still ~4x from the rate: its time grows with blocks per
// SM, and its in-block work (converting and multiplying from registers,
// the partial sums in shared memory) is a large share of it (PERF.md).
//
// Design:
//   * pass 1, decode_split: a grid of (B*KV, n_split) blocks of 128
//     threads.  Each block walks a contiguous range of 64-slot pages for
//     one (batch row, kv head) and all G of its query heads; a page with no
//     live slot is skipped before it is read.  Every K and V load of a page
//     is issued at once, 16 bytes each, straight into registers, and
//     converted to fp32 there: a thread holds one slot's whole K row for
//     the scores (full dot products for its share of the G heads, no
//     cross-lane reduction) and one 16-byte column chunk of JV V rows for
//     P V (8 in bf16 at hd 128; at hd 80, whose 10 chunks do not divide
//     128 threads, 12 subsets of 5 or 6 rows cover the page in bf16, 6 of
//     10 or 11 in fp32, and 8 threads idle in P V; at hd 256, paligemma's,
//     4 subsets of 16 rows in bf16 and 2 of 32 in fp32, so a thread holds
//     32 K and 16 V vectors in bf16, 64 and 32 in fp32, more than the
//     255-register cap can keep: phase 2 of chip_smoke.py prints the
//     spills).  The softmax update is one warp a head.  Each thread
//     keeps its fp32 partial of P V in its own slice of shared memory, so
//     G stays a runtime value; the block sums the slices and writes its
//     partial (acc[G][hd], m, l) to scratch.
//   * pass 2, decode_combine: one block of hd threads (80 at hd 80: the
//     threads share nothing, so a part-filled warp is harmless) per (batch row,
//     head) computes sum_i e^(m_i - M) acc_i / max(sum_i e^(m_i - M) l_i,
//     1e-20); a split that found no live page has m = -inf and adds nothing.
//   * n_split is chosen by the wrapper (ops.decode_splits): about two
//     blocks per SM, at least one page a split (9 at the serving shape:
//     288 blocks).  Both kernels take fp32, bf16 or fp16; fp16 reads the
//     same 16-byte vectors of eight as bf16 (Vec<__half>) and converts
//     them to fp32 in registers, so it holds as many registers as bf16.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int PAGE = 64;
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

// 16 bytes of T: loaded as they are, converted to N floats where used.
template <typename T> struct Vec;
template <> struct Vec<float> {
  using Raw = float4;
  static constexpr int N = 4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void convert(const Raw& v, float (&x)[4]) {
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
};
template <> struct Vec<__nv_bfloat16> {
  using Raw = uint4;
  static constexpr int N = 8;
  static __device__ __forceinline__ Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void convert(const Raw& v, float (&x)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};
template <> struct Vec<__half> {
  using Raw = uint4;
  static constexpr int N = 8;
  static __device__ __forceinline__ Raw load(const __half* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ void convert(const Raw& v, float (&x)[8]) {
    const __half2* h = reinterpret_cast<const __half2*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};


template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// May the query at `pos` attend to cache slot i?  Linear cache: slot i
// holds position i.  Ring cache: the latest p <= pos with p % S == i
// (negative: never written).  ref.decode_slot_positions / decode_valid.
__device__ __forceinline__ bool slot_valid(long long i, long long pos, int S,
                                           int window, int ring) {
  long long kp = i;
  if (ring) {
    long long r = (pos - i) % S;     // floored, as Python's %
    if (r < 0) r += S;
    kp = pos - r;
  }
  bool ok = kp >= 0 && kp <= pos;
  if (window > 0) ok = ok && kp > pos - window;
  return ok;
}

template <typename T, int HD>
struct Split {
  static constexpr int VEC = Vec<T>::N;
  static_assert(HD % VEC == 0, "a row is whole 16-byte vectors");
  static constexpr int NV = HD / VEC;          // 16-byte vectors in a row
  // P V: a thread owns VEC columns (chunk c of NV) of the rows of its slot
  // subset t (SUBS subsets, slots j = t, t + SUBS, ... below PAGE).  Where
  // NV does not divide THREADS (hd 80: NV 10 in bf16, 20 in fp32) the
  // THREADS - SUBS * NV threads left over take no part in P V, and the
  // last subsets hold one row fewer than the first (JV rounds up)
  static constexpr int SUBS = THREADS / NV;
  static constexpr int JV = (PAGE + SUBS - 1) / SUBS;  // V vectors a thread holds
  // q, scores, (m, l, alpha), then each thread's fp32 partial P V
  static size_t smem_bytes(int G) {   // + up to 3 floats to align the float4s
    return sizeof(float) * (G * HD + G * PAGE + 3 * G + 3 + SUBS * G * HD);
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
decode_split(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, float* __restrict__ part, int G, int S,
             int n_split, long long pos, int window, int ring, float scale,
             float softcap) {
  using P = Split<T, HD>;
  using Raw = typename Vec<T>::Raw;
  constexpr int VEC = P::VEC, NV = P::NV, SUBS = P::SUBS, JV = P::JV;
  extern __shared__ float smem[];
  float* q_s = smem;                 // G x HD
  float* p_s = q_s + G * HD;         // G x PAGE: scores, then probabilities
  float* m_s = p_s + G * PAGE;       // running max per head
  float* l_s = m_s + G;              // running sum per head
  float* a_s = l_s + G;              // this page's rescale factor per head
  // SUBS x G x HD: P V per slot subset, each (subset, head) row stored
  // as VEC / 4 planes of NV float4s, so that the threads of a warp read and
  // write neighbouring float4s (no bank conflicts)
  float4* r_s = reinterpret_cast<float4*>(a_s + G + ((4 - 3 * G % 4) % 4));

  const int bkv = blockIdx.x, split = blockIdx.y;   // bkv = b * KV + kv head
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid % NV, t = tid / NV;   // P V: columns [c VEC, c VEC + VEC), subset t
  const bool pv = t < SUBS;               // the threads past SUBS * NV idle in P V
  const int n_pages = (S + PAGE - 1) / PAGE;
  const int pg_end = (int)((long long)(split + 1) * n_pages / n_split);
  const T* qb = q + (long long)bkv * G * HD;
  const T* kb = k + (long long)bkv * S * HD;
  const T* vb = v + (long long)bkv * S * HD + c * VEC;

  for (int i = tid; i < SUBS * G * HD / 4; i += THREADS)
    r_s[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = -INFINITY;              // stays -inf if no page is live
    l_s[g] = 0.f;
  }

  bool q_ready = false;
  for (int pg = (int)((long long)split * n_pages / n_split); pg < pg_end; ++pg) {
    const int p0 = pg * PAGE, n = min(PAGE, S - p0);
    // a page whose every slot is masked contributes nothing: skip it (the
    // barrier also retires the previous page's readers of p_s and a_s)
    const bool live = tid < n && slot_valid(p0 + tid, pos, S, window, ring);
    if (!__syncthreads_or(live)) continue;

    // every K and V load of the page in flight at once, into registers:
    // for the scores, the whole K row of slot tid % PAGE; for P V, this
    // thread's column chunk of its subset's V rows
    const int j = tid % PAGE;
    Raw kr[NV], vr[JV];
#pragma unroll
    for (int u = 0; u < NV; ++u)
      kr[u] = j < n ? Vec<T>::load(kb + (long long)(p0 + j) * HD + u * VEC) : Raw{};
#pragma unroll
    for (int u = 0; u < JV; ++u) {
      const int jv = t + u * SUBS;      // < n <= PAGE: a row of the page
      vr[u] = pv && jv < n ? Vec<T>::load(vb + (long long)(p0 + jv) * HD) : Raw{};
    }
    if (!q_ready) {                  // q's loads overlap the page's
      for (int i = tid * VEC; i < G * HD; i += THREADS * VEC) {
        float x[VEC];
        Vec<T>::convert(Vec<T>::load(qb + i), x);
#pragma unroll
        for (int e = 0; e < VEC; ++e) q_s[i + e] = x[e];
      }
      q_ready = true;
      __syncthreads();
    }

    // scores of slot j for the heads g = tid / PAGE, + THREADS / PAGE, ...
    const bool ok = j < n && slot_valid(p0 + j, pos, S, window, ring);
    for (int g = tid / PAGE; g < G; g += THREADS / PAGE) {
      const float4* qg = reinterpret_cast<const float4*>(q_s + g * HD);
      float dot0 = 0.f, dot1 = 0.f;
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        float kx[VEC];
        Vec<T>::convert(kr[u], kx);
#pragma unroll
        for (int e = 0; e < VEC; e += 4) {
          const float4 qv = qg[(u * VEC + e) / 4];
          dot0 = fmaf(qv.x, kx[e], dot0);
          dot1 = fmaf(qv.y, kx[e + 1], dot1);
          dot0 = fmaf(qv.z, kx[e + 2], dot0);
          dot1 = fmaf(qv.w, kx[e + 3], dot1);
        }
      }
      float s = -INFINITY;           // slots past S do not exist
      if (j < n) {
        s = (dot0 + dot1) * scale;
        if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
        if (!ok) s = NEG_INF;
      }
      p_s[g * PAGE + j] = s;
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

    // P V from the V vectors in registers, into this thread's own slice of
    // r_s (no other thread touches it until the final sum)
    float vx[JV][VEC];
#pragma unroll
    for (int u = 0; u < JV; ++u) Vec<T>::convert(vr[u], vx[u]);
    for (int g = 0; pv && g < G; ++g) {
      const float* pr = p_s + g * PAGE + t;
      float4* acc = r_s + (t * G + g) * (HD / 4) + c;   // plane h at + h * NV
      const float alpha = a_s[g];
      float a[VEC];
#pragma unroll
      for (int h = 0; h < VEC / 4; ++h) {
        const float4 x = acc[h * NV];
        a[4 * h] = x.x * alpha;
        a[4 * h + 1] = x.y * alpha;
        a[4 * h + 2] = x.z * alpha;
        a[4 * h + 3] = x.w * alpha;
      }
#pragma unroll
      for (int u = 0; u < JV; ++u) {
        const float pj = t + u * SUBS < n ? pr[u * SUBS] : 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) a[e] = fmaf(pj, vx[u][e], a[e]);
      }
#pragma unroll
      for (int h = 0; h < VEC / 4; ++h)
        acc[h * NV] = make_float4(a[4 * h], a[4 * h + 1], a[4 * h + 2], a[4 * h + 3]);
    }
  }
  __syncthreads();

  // partial of this split: per head hd accumulators, then m, then l
  float* out = part + ((long long)bkv * n_split + split) * G * (HD + 2);
  const float* r = reinterpret_cast<const float*>(r_s);
  for (int i = tid; i < G * HD; i += THREADS) {
    const int g = i / HD, d = i % HD;
    // column d sits in plane (d % VEC) / 4 of chunk d / VEC
    const int at = (((d % VEC) / 4) * NV + d / VEC) * 4 + d % 4;
    float sum = 0.f;
    for (int sub = 0; sub < SUBS; ++sub) sum += r[(sub * G + g) * HD + at];
    out[g * (HD + 2) + d] = sum;
  }
  for (int g = tid; g < G; g += THREADS) {
    out[g * (HD + 2) + HD] = m_s[g];
    out[g * (HD + 2) + HD + 1] = l_s[g];
  }
}

// One block of HD threads per (batch row, query head).
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
decode_combine(const float* __restrict__ part, T* __restrict__ out, int G,
               int n_split) {
  const int bkv = blockIdx.x / G, g = blockIdx.x % G, d = threadIdx.x;
  const long long step = (long long)G * (HD + 2);
  const float* p = part + (long long)bkv * n_split * step + g * (HD + 2);
  float M = -INFINITY;
#pragma unroll 8
  for (int i = 0; i < n_split; ++i) M = fmaxf(M, p[i * step + HD]);
  float num = 0.f, den = 0.f;
  if (M > -INFINITY) {
#pragma unroll 8
    for (int i = 0; i < n_split; ++i) {
      const float w = expf(p[i * step + HD] - M);  // 0 for a split with m = -inf
      num = fmaf(w, p[i * step + d], num);
      den = fmaf(w, p[i * step + HD + 1], den);
    }
  }
  out[(long long)blockIdx.x * HD + d] = from_f<T>(num / fmaxf(den, 1e-20f));
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* part, void* out,
           int B, int KV, int G, int S, int n_split, long long pos, int window,
           int ring, float softcap, cudaStream_t stream) {
  using P = Split<T, HD>;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16)
    return (int)cudaErrorMisalignedAddress;    // 16-byte loads
  // the opt-in is a property of the function on the current card: set it
  // on every call, so a second card in the process gets it too
  const size_t smem = P::smem_bytes(G);
  const cudaError_t attr = cudaFuncSetAttribute(
      decode_split<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  decode_split<T, HD><<<dim3(B * KV, n_split), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<float*>(part), G, S, n_split, pos,
      window, ring, 1.0f / sqrtf((float)HD), softcap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine<T, HD><<<B * KV * G, HD, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(out), G, n_split);
  return (int)cudaGetLastError();
}

// The head dim's instantiation, for elements of type T.
template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* part,
              void* out, int B, int KV, int G, int S, int hd, int n_split,
              long long pos, int window, int ring, float softcap,
              cudaStream_t s) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, part, out, B, KV, G, S, n_split, pos, window, ring, softcap, s);
    case 80:
      return launch<T, 80>(q, k, v, part, out, B, KV, G, S, n_split, pos, window, ring, softcap, s);
    case 128:
      return launch<T, 128>(q, k, v, part, out, B, KV, G, S, n_split, pos, window, ring, softcap, s);
    case 256:
      return launch<T, 256>(q, k, v, part, out, B, KV, G, S, n_split, pos, window, ring, softcap, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  part: fp32 scratch of
// B * KV * n_split * G * (hd + 2) floats.  ring: 0 linear cache, 1 ring
// buffer.  hd 64, 80, 128 or 256; G * hd above 2048 is refused (paligemma's
// G 8 at hd 256 is exactly 2048).  Launches both passes; returns a
// cudaError_t (0 = launched).
extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  void* part, void* out, int B, int KV, int G,
                                  int S, int hd, int n_split, long long pos,
                                  int window, int ring, float softcap,
                                  int dtype, void* stream) {
  if (B <= 0 || KV <= 0 || G <= 0 || S <= 0 || n_split <= 0 || G * hd > 2048)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_hd<float>(q, k, v, part, out, B, KV, G, S, hd, n_split, pos, window, ring, softcap, s);
    case 1:
      return launch_hd<__nv_bfloat16>(q, k, v, part, out, B, KV, G, S, hd, n_split, pos, window, ring, softcap, s);
    case 2:
      return launch_hd<__half>(q, k, v, part, out, B, KV, G, S, hd, n_split, pos, window, ring, softcap, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
