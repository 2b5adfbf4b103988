// Fused RMSNorm for Hopper: y = x * rsqrt(mean(x^2) + eps) * scale per row.
//
// Replaces repro/kernels/rmsnorm.py::_rmsnorm_kernel (the Pallas TPU kernel
// behind repro.kernels.ops.rmsnorm).  Same contract: x viewed as (rows, d),
// scale (d,), statistics and products in fp32, output in x's type.  x is
// float32 or bfloat16; scale may be either, independently of x (in the model
// a norm's scale is fp32 while its input is bf16).
//
// Design (a simple kernel that is right first): one group of G threads per
// row, G = 32 (one warp, eight rows to a block) for d <= 1024 and G = 256
// (the whole block) above.  Each row's body is read with 16-byte vector
// loads from its first 16-byte-aligned element on; the unaligned head and
// the tail shorter than a vector are read one element at a time, so any d
// works.  A thread keeps up to MAXV of its vectors in registers between the
// sum of squares and the write (16384 bf16 or 8192 fp32 elements a row at
// G = 256); a longer row reads the rest again, from cache.  The sum of
// squares is reduced with warp shuffles, and across the warps of a block
// through shared memory.  The TPU kernel's BLOCK_ROWS = 256 tiling and its
// search for a row count that divides the rows are not needed: each group
// takes one row, and the rows need no multiple of anything.
//
// What bounds it on the card: memory.  It must read x once and write y once,
// 2 * rows * d * sizeof(x) bytes (the scale is d elements): at 4096 x 4096
// bf16, 67.1 MB, or 0.020 ms at 3.35 TB/s.  With one row of 4096 to a block
// of 256 threads, each thread moves two 16-byte vectors in and two out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAXV = 8;              // vectors a thread keeps in registers
constexpr int NARROW_D = 1024;       // d up to this: one warp a row

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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

template <typename T, typename S>
__device__ __forceinline__ uint4 normed(const uint4& v, float inv,
                                        const S* __restrict__ scale) {
  const T* e = reinterpret_cast<const T*>(&v);
  uint4 o;
  T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
  for (int i = 0; i < vec_len<T>(); ++i)
    oe[i] = from_f<T>(to_f(e[i]) * inv * to_f(scale[i]));
  return o;
}

// the sum over the G threads of a row group; every thread gets it
template <int G>
__device__ __forceinline__ float group_sum(float s, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (G == 32) return s;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = s;
  __syncthreads();
  s = lane < G / 32 ? red[lane] : 0.f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// vec: the host found x and out with the same offset from a 16-byte
// boundary, so a row's aligned body lines up in both
template <typename T, typename S, int G>
__global__ void __launch_bounds__(THREADS)
rmsnorm_fwd(const T* __restrict__ x, const S* __restrict__ scale,
            T* __restrict__ out, int rows, int d, float eps, int vec) {
  __shared__ float red[THREADS / 32];
  constexpr int V = vec_len<T>();
  const long long row = (long long)blockIdx.x * (THREADS / G) + threadIdx.x / G;
  const int lane = threadIdx.x % G;
  if (row >= rows) return;           // G = 32 only: no block barrier below
  const T* xr = x + row * d;
  T* orow = out + row * d;

  int head = d, nv = 0;              // scalar head, then nv vectors, then tail
  if (vec) {
    const int mis = (int)(reinterpret_cast<uintptr_t>(xr) & 15);
    head = mis ? min(d, (16 - mis) / (int)sizeof(T)) : 0;
    nv = (d - head) / V;
  }
  const int tail = head + nv * V;
  const uint4* xv = reinterpret_cast<const uint4*>(xr + head);
  uint4* ov = reinterpret_cast<uint4*>(orow + head);

  float ss = 0.f;
  for (int i = lane; i < head; i += G) { const float f = to_f(xr[i]); ss += f * f; }
  for (int i = tail + lane; i < d; i += G) { const float f = to_f(xr[i]); ss += f * f; }
  uint4 keep[MAXV];
#pragma unroll
  for (int k = 0; k < MAXV; ++k) {
    const int j = lane + k * G;
    if (j < nv) { keep[k] = xv[j]; ss += sum_sq<T>(keep[k]); }
  }
  for (int j = lane + MAXV * G; j < nv; j += G) ss += sum_sq<T>(xv[j]);

  const float inv = rsqrtf(group_sum<G>(ss, red) / (float)d + eps);

  for (int i = lane; i < head; i += G)
    orow[i] = from_f<T>(to_f(xr[i]) * inv * to_f(scale[i]));
  for (int i = tail + lane; i < d; i += G)
    orow[i] = from_f<T>(to_f(xr[i]) * inv * to_f(scale[i]));
#pragma unroll
  for (int k = 0; k < MAXV; ++k) {
    const int j = lane + k * G;
    if (j < nv) ov[j] = normed<T>(keep[k], inv, scale + head + j * V);
  }
  for (int j = lane + MAXV * G; j < nv; j += G)
    ov[j] = normed<T>(xv[j], inv, scale + head + j * V);
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* out, int rows, int d,
           float eps, cudaStream_t stream) {
  const int vec = (reinterpret_cast<uintptr_t>(x) & 15) ==
                  (reinterpret_cast<uintptr_t>(out) & 15);
  const T* xt = static_cast<const T*>(x);
  const S* st = static_cast<const S*>(scale);
  T* ot = static_cast<T*>(out);
  if (d <= NARROW_D) {
    const int per_block = THREADS / 32;
    rmsnorm_fwd<T, S, 32><<<(rows + per_block - 1) / per_block, THREADS, 0, stream>>>(
        xt, st, ot, rows, d, eps, vec);
  } else {
    rmsnorm_fwd<T, S, THREADS><<<rows, THREADS, 0, stream>>>(xt, st, ot, rows, d, eps, vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (rows, d) contiguous, of x_dtype; scale: (d,) of scale_dtype.
// dtypes: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* out,
                             int rows, int d, float eps, int x_dtype,
                             int scale_dtype, void* stream) {
  if (rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && scale_dtype == 0)
    return launch<float, float>(x, scale, out, rows, d, eps, s);
  if (x_dtype == 0 && scale_dtype == 1)
    return launch<float, __nv_bfloat16>(x, scale, out, rows, d, eps, s);
  if (x_dtype == 1 && scale_dtype == 0)
    return launch<__nv_bfloat16, float>(x, scale, out, rows, d, eps, s);
  if (x_dtype == 1 && scale_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
}
