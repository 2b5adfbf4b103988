// Fused RMSNorm for Hopper: y = x * rsqrt(mean(x^2) + eps) * scale per row.
//
// Replaces repro/kernels/rmsnorm.py::_rmsnorm_kernel (the Pallas TPU kernel
// behind repro.kernels.ops.rmsnorm).  Same contract: x viewed as (rows, d),
// scale (d,), statistics and products in fp32, output in x's type.  x is
// float32, bfloat16 or float16; scale may be any of the three,
// independently of x (in the model a norm's scale is fp32 while its input
// is bf16 or fp16).  fp16 and bf16 take the same code: 16-byte vectors of
// eight 2-byte elements, converted to fp32 in registers.
//
// What bounds it on the card: memory.  It must read x once and write y once,
// 2 * rows * d * sizeof(x) bytes (the scale is d elements): at the profile's
// 4096 x 4096 bf16, 67.1 MB, or 0.020 ms at 3.35 TB/s.  So the design is
// about keeping enough bytes in flight and spending nothing else:
//
// * rmsnorm_fwd_warp, for rows of up to 32 16-byte vectors a lane (16 KB:
//   d <= 8192 in bf16, 4096 in fp32): one warp a row, eight rows to a block
//   of 256 threads, a persistent grid of (blocks that fit an SM) x (SMs)
//   whose warps stride over the rows.  A lane issues all of its row's
//   16-byte loads (16 at d 4096 bf16) before it sums anything, keeps them
//   in registers, reduces the sum of squares with shuffles alone (no block
//   barrier) and writes the row back from registers.  Each block converts
//   the scale to fp32 in shared memory once, with 16-byte loads where it is
//   aligned, and reads it back as float4.  x is loaded and y stored with
//   streaming hints (__ldcs / __stcs): neither is read again.
// * rmsnorm_fwd_block, for longer rows: one block of 256 threads a row,
//   up to 8 vectors a thread in registers (a longer row reads the rest
//   again, from cache), the sum across warps through shared memory.
//
// Both read a row's body with 16-byte vector loads from its first
// 16-byte-aligned element on; the unaligned head and the tail shorter
// than a vector are read one element at a time, so any d and any offset
// of x work (x and out must share their offset from a 16-byte boundary
// for the vector loads, or every element goes the scalar way).  The TPU
// kernel's BLOCK_ROWS = 256 tiling and its search for a row count that
// divides the rows are not needed.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;  // rows a block of the warp path holds at once
constexpr int MAXV = 8;              // vectors a thread keeps on the block path
constexpr int WARP_KEEP = 32;        // most vectors a lane keeps on the warp path

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// a 16-byte vector holds V elements of x's type
template <typename T> __host__ __device__ constexpr int vec_len() { return 16 / (int)sizeof(T); }

template <typename T>
__device__ __forceinline__ float sum_sq(const uint4& v) {
  const T* e = reinterpret_cast<const T*>(&v);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < vec_len<T>(); ++i) {
    const float f = to_f(e[i]);
    s += f * f;
  }
  return s;
}

// v * inv * sc, element by element (sc: the vector's V scale values)
template <typename T>
__device__ __forceinline__ uint4 scaled(const uint4& v, float inv, const float* sc) {
  const T* e = reinterpret_cast<const T*>(&v);
  uint4 o;
  T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
  for (int i = 0; i < vec_len<T>(); ++i) oe[i] = from_f<T>(to_f(e[i]) * inv * sc[i]);
  return o;
}

// The layout of one row: a scalar head up to x's first 16-byte boundary,
// nv vectors, then a scalar tail from element `tail` on.  vec: the host
// found x and out with the same offset from a 16-byte boundary, so a row's
// aligned body lines up in both.
template <typename T>
struct RowSplit {
  int head, nv, tail;
  __device__ __forceinline__ RowSplit(const T* xr, int d, int vec) {
    head = d;
    nv = 0;
    if (vec) {
      const int mis = (int)(reinterpret_cast<uintptr_t>(xr) & 15);
      head = mis ? min(d, (16 - mis) / (int)sizeof(T)) : 0;
      nv = (d - head) / vec_len<T>();
    }
    tail = head + nv * vec_len<T>();
  }
};

template <typename T, typename S, int KEEP>
__global__ void __launch_bounds__(THREADS)
rmsnorm_fwd_warp(const T* __restrict__ x, const S* __restrict__ scale,
                 T* __restrict__ out, int rows, int d, float eps, int vec) {
  extern __shared__ float4 smem4[];
  float* scale_s = reinterpret_cast<float*>(smem4);   // d fp32
  constexpr int V = vec_len<T>();
  constexpr int VS = vec_len<S>();

  // the scale, once a block, as fp32
  const int nsv = (reinterpret_cast<uintptr_t>(scale) & 15) ? 0 : d / VS;
  for (int j = threadIdx.x; j < nsv; j += THREADS) {
    const uint4 v = reinterpret_cast<const uint4*>(scale)[j];
    const S* e = reinterpret_cast<const S*>(&v);
#pragma unroll
    for (int k = 0; k < VS; ++k) scale_s[j * VS + k] = to_f(e[k]);
  }
  for (int i = nsv * VS + threadIdx.x; i < d; i += THREADS) scale_s[i] = to_f(scale[i]);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long step = (long long)gridDim.x * WARPS;
  for (long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5); row < rows;
       row += step) {
    const T* xr = x + row * d;
    T* orow = out + row * d;
    const RowSplit<T> rs(xr, d, vec);
    const uint4* xv = reinterpret_cast<const uint4*>(xr + rs.head);
    uint4* ov = reinterpret_cast<uint4*>(orow + rs.head);

    uint4 keep[KEEP];                // every load of the row issued first
#pragma unroll
    for (int k = 0; k < KEEP; ++k) {
      const int j = lane + 32 * k;
      if (j < rs.nv) keep[k] = __ldcs(xv + j);
    }
    float ss = 0.f;
    for (int i = lane; i < rs.head; i += 32) { const float f = to_f(xr[i]); ss += f * f; }
    for (int i = rs.tail + lane; i < d; i += 32) { const float f = to_f(xr[i]); ss += f * f; }
#pragma unroll
    for (int k = 0; k < KEEP; ++k)
      if (lane + 32 * k < rs.nv) ss += sum_sq<T>(keep[k]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const float inv = rsqrtf(ss / (float)d + eps);

    for (int i = lane; i < rs.head; i += 32)
      orow[i] = from_f<T>(to_f(xr[i]) * inv * scale_s[i]);
    for (int i = rs.tail + lane; i < d; i += 32)
      orow[i] = from_f<T>(to_f(xr[i]) * inv * scale_s[i]);
    // a vector's scale values start at an element that is a multiple of 4
    // (float4 reads) exactly when the head is
    const bool sc4 = (rs.head & 3) == 0;
#pragma unroll
    for (int k = 0; k < KEEP; ++k) {
      const int j = lane + 32 * k;
      if (j >= rs.nv) continue;
      const float* sp = scale_s + rs.head + j * V;
      float sc[V];
      if (sc4) {
#pragma unroll
        for (int q = 0; q < V / 4; ++q) {
          const float4 f = reinterpret_cast<const float4*>(sp)[q];
          sc[4 * q] = f.x; sc[4 * q + 1] = f.y; sc[4 * q + 2] = f.z; sc[4 * q + 3] = f.w;
        }
      } else {
#pragma unroll
        for (int q = 0; q < V; ++q) sc[q] = sp[q];
      }
      __stcs(ov + j, scaled<T>(keep[k], inv, sc));
    }
  }
}

template <typename T, typename S>
__global__ void __launch_bounds__(THREADS)
rmsnorm_fwd_block(const T* __restrict__ x, const S* __restrict__ scale,
                  T* __restrict__ out, int rows, int d, float eps, int vec) {
  __shared__ float red[WARPS];
  constexpr int V = vec_len<T>();
  const long long row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* xr = x + row * d;
  T* orow = out + row * d;
  const RowSplit<T> rs(xr, d, vec);
  const uint4* xv = reinterpret_cast<const uint4*>(xr + rs.head);
  uint4* ov = reinterpret_cast<uint4*>(orow + rs.head);

  float ss = 0.f;
  for (int i = tid; i < rs.head; i += THREADS) { const float f = to_f(xr[i]); ss += f * f; }
  for (int i = rs.tail + tid; i < d; i += THREADS) { const float f = to_f(xr[i]); ss += f * f; }
  uint4 keep[MAXV];
#pragma unroll
  for (int k = 0; k < MAXV; ++k) {
    const int j = tid + k * THREADS;
    if (j < rs.nv) { keep[k] = xv[j]; ss += sum_sq<T>(keep[k]); }
  }
  for (int j = tid + MAXV * THREADS; j < rs.nv; j += THREADS) ss += sum_sq<T>(xv[j]);

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  ss = lane < WARPS ? red[lane] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float inv = rsqrtf(ss / (float)d + eps);

  for (int i = tid; i < rs.head; i += THREADS)
    orow[i] = from_f<T>(to_f(xr[i]) * inv * to_f(scale[i]));
  for (int i = rs.tail + tid; i < d; i += THREADS)
    orow[i] = from_f<T>(to_f(xr[i]) * inv * to_f(scale[i]));
  auto write = [&](int j, const uint4& v) {
    const S* sp = scale + rs.head + j * V;
    float sc[V];
#pragma unroll
    for (int q = 0; q < V; ++q) sc[q] = to_f(sp[q]);
    ov[j] = scaled<T>(v, inv, sc);
  };
#pragma unroll
  for (int k = 0; k < MAXV; ++k) {
    const int j = tid + k * THREADS;
    if (j < rs.nv) write(j, keep[k]);
  }
  for (int j = tid + MAXV * THREADS; j < rs.nv; j += THREADS) write(j, xv[j]);
}

constexpr int MAX_DEVICES = 64;     // cards whose grid size is cached

// The warp path with KEEP vectors a lane: a persistent grid of as many
// blocks as fit the current card at once (never more than the rows need).
template <typename T, typename S, int KEEP>
int launch_warp(const T* x, const S* scale, T* out, int rows, int d,
                float eps, int vec, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)d;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  static int fits[MAX_DEVICES];      // blocks at once a card, at the largest smem
  if (fits[dev] == 0) {
    const size_t most = sizeof(float) * 32 * KEEP * vec_len<T>();
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rmsnorm_fwd_warp<T, S, KEEP>, THREADS, most);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    fits[dev] = (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  }
  const long long need = ((long long)rows + WARPS - 1) / WARPS;
  const long long fit = fits[dev];
  const int grid = (int)(need < fit ? need : fit);
  rmsnorm_fwd_warp<T, S, KEEP><<<grid, THREADS, smem, stream>>>(x, scale, out, rows,
                                                                d, eps, vec);
  return (int)cudaGetLastError();
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* out, int rows, int d,
           float eps, cudaStream_t stream) {
  const int vec = (reinterpret_cast<uintptr_t>(x) & 15) ==
                  (reinterpret_cast<uintptr_t>(out) & 15);
  const T* xt = static_cast<const T*>(x);
  const S* st = static_cast<const S*>(scale);
  T* ot = static_cast<T*>(out);
  // vectors a lane holds when a warp takes a row (an upper bound)
  const int per_lane = (d + 32 * vec_len<T>() - 1) / (32 * vec_len<T>());
  if (per_lane <= 8) return launch_warp<T, S, 8>(xt, st, ot, rows, d, eps, vec, stream);
  if (per_lane <= 16) return launch_warp<T, S, 16>(xt, st, ot, rows, d, eps, vec, stream);
  if (per_lane <= WARP_KEEP)
    return launch_warp<T, S, WARP_KEEP>(xt, st, ot, rows, d, eps, vec, stream);
  rmsnorm_fwd_block<T, S><<<rows, THREADS, 0, stream>>>(xt, st, ot, rows, d, eps, vec);
  return (int)cudaGetLastError();
}

// The scale's type, for an x of type T.
template <typename T>
int launch_x(const void* x, const void* scale, void* out, int rows, int d,
             float eps, int scale_dtype, cudaStream_t stream) {
  switch (scale_dtype) {
    case 0: return launch<T, float>(x, scale, out, rows, d, eps, stream);
    case 1: return launch<T, __nv_bfloat16>(x, scale, out, rows, d, eps, stream);
    case 2: return launch<T, __half>(x, scale, out, rows, d, eps, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, out: (rows, d) contiguous, of x_dtype; scale: (d,) of scale_dtype.
// dtypes: 0 = float32, 1 = bfloat16, 2 = float16.  Returns a cudaError_t
// (0 = launched).
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* out,
                             int rows, int d, float eps, int x_dtype,
                             int scale_dtype, void* stream) {
  if (rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0: return launch_x<float>(x, scale, out, rows, d, eps, scale_dtype, s);
    case 1: return launch_x<__nv_bfloat16>(x, scale, out, rows, d, eps, scale_dtype, s);
    case 2: return launch_x<__half>(x, scale, out, rows, d, eps, scale_dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
