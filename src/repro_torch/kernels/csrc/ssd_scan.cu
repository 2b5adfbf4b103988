// Mamba2 SSD chunk scan forward (state-space duality, arXiv:2405.21060)
// for Hopper.
//
// Replaces repro/kernels/ssd_scan.py::_ssd_kernel (the Pallas TPU kernel
// behind repro.kernels.ops.ssd_scan).  Same contract as
// repro_torch/kernels/ref.py::ssd_ref from a zero initial state:
//
//   per head, per position t:  state = state * exp(A dt_t) + (x_t dt_t) B_t^T
//                              y_t   = state C_t
//
// computed chunk by chunk: with cum = cumsum(A dt) inside a chunk,
//   y     = (C B^T o L) (x dt) + (C o exp(cum)) state^T,  L[i,j] = exp(cum_i - cum_j), j <= i
//   state = state exp(cum_last) + (x dt)^T (B o exp(cum_last - cum)).
//
// Layout: x (b, S, h, p), dt (b, S, h) fp32, A (h,) fp32, B/C (b, S, g, n)
// with g groups shared by h / g heads each.  x, B and C are read in place
// with a row stride (elements between sequence positions) given by the
// caller, so B and C may be column slices of one (b, S, 2 g n) tensor; the
// group of head hh is read by index (hh / (h / g)), so the repeat to heads
// that the TPU wrapper materialises never exists.  y (b, S, h, p) and the
// final state (b, h, p, n) are written in fp32.
//
// Design (a simple kernel that is right first):
//   * one block of 256 threads per (batch row, head) walks the chunks in
//     order and carries the (p, n) fp32 state in shared memory, as the TPU
//     kernel's grid carries it in VMEM scratch;
//   * cum by a segmented scan in one warp;
//   * the chunk's rows are processed in 64-row query tiles against 32-row
//     key tiles at or below them: a full chunk x chunk L tile (256 KB at
//     chunk 256) never exists, and L's exponent is taken only where
//     j <= i, so a large dt above the diagonal cannot overflow into inf * 0;
//   * every product on CUDA cores in fp32, each thread a 4 x 4 (outputs),
//     4 x 2 (scores) or 4 x 8 (state) register micro-tile; shared tiles
//     have odd row strides where threads read down a column;
//   * about 98 KB of shared memory, so two blocks fit on an SM and the
//     192 blocks of the training shape (b 4 x h 48) run in one wave.
//
// What bounds it on the card: at the training shape (b 4, S 2048, h 48,
// p 64, g 1, n 128, chunk 256) it must move about 163 MB (x bf16, y fp32,
// B/C, dt, state: 49 us at 3.35 TB/s) and does about 51.5 GFLOP with full
// L tiles (52 us at the 989 TFLOP/s bf16 tensor-core peak).  This design
// does its arithmetic in fp32 on CUDA cores (67 TFLOP/s peak, 0.77 ms for
// the same work), reading its operands from shared memory, so that rate
// is its real limit; wgmma tiles and TMA are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int TQ = 64;               // query rows per tile
constexpr int TK = 32;               // key rows per tile
constexpr int MAX_P = 64;            // head dim: rows of the state tile
constexpr int MAX_N = 128;           // state dim
constexpr int MAX_CHUNK = 256;
constexpr int LDS = TK + 1;          // row stride of the score tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

size_t smem_floats(int N, int chunk) {
  const int ld = N + 1;
  return (size_t)MAX_P * ld          // state
       + (size_t)TQ * ld             // C tile
       + (size_t)TK * ld             // B tile
       + (size_t)TK * MAX_P          // (x dt) tile
       + (size_t)TQ * LDS            // masked scores
       + (size_t)chunk;              // cum
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
ssd_fwd(const T* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ A, const T* __restrict__ Bm,
        const T* __restrict__ Cm, float* __restrict__ y,
        float* __restrict__ fin, int S, int H, int G, int P, int N, int chunk,
        long long x_rs, long long b_rs, long long c_rs) {
  extern __shared__ float smem[];
  const int ld = N + 1;
  float* st_s = smem;                // MAX_P x ld, rows >= P stay zero
  float* c_s = st_s + MAX_P * ld;    // TQ x ld
  float* b_s = c_s + TQ * ld;        // TK x ld
  float* x_s = b_s + TK * ld;        // TK x MAX_P, columns >= P zero
  float* s_s = x_s + TK * MAX_P;     // TQ x LDS
  float* cum_s = s_s + TQ * LDS;     // chunk

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int g = h / (H / G);
  const T* xb = x + (long long)b * S * x_rs + (long long)h * P;
  const float* dtb = dt + (long long)b * S * H + h;
  const T* Bb = Bm + (long long)b * S * b_rs + (long long)g * N;
  const T* Cb = Cm + (long long)b * S * c_rs + (long long)g * N;
  const long long y_rs = (long long)H * P;
  float* yb = y + (long long)b * S * y_rs + (long long)h * P;
  const float a_h = A[h];

  for (int i = tid; i < MAX_P * ld; i += THREADS) st_s[i] = 0.f;

  // the (x dt) rows j0 .. j0 + TK - 1 of the chunk at c0, zero past the chunk
  auto load_x = [&](int c0, int j0, int len) {
    for (int i = tid; i < TK * MAX_P; i += THREADS) {
      const int r = i / MAX_P, pc = i % MAX_P;
      float v = 0.f;
      if (j0 + r < len && pc < P) {
        const long long t = c0 + j0 + r;
        v = to_f(xb[t * x_rs + pc]) * dtb[t * H];
      }
      x_s[i] = v;
    }
  };

  for (int c0 = 0; c0 < S; c0 += chunk) {
    const int len = chunk;           // S % chunk == 0 (checked by the caller)
    __syncthreads();                 // last chunk's readers of cum_s are done

    // ---- cum = inclusive cumsum of A dt over the chunk (one warp) ----
    if (tid < 32) {
      const int per = (len + 31) / 32;
      const int lo = min(tid * per, len), hi = min(lo + per, len);
      float run = 0.f;
      for (int t = lo; t < hi; ++t) {
        run += a_h * dtb[(long long)(c0 + t) * H];
        cum_s[t] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      const float excl = incl - run;
      for (int t = lo; t < hi; ++t) cum_s[t] += excl;
    }
    __syncthreads();
    const float total = cum_s[len - 1];

    // ---- outputs, one TQ-row query tile at a time ----
    for (int i0 = 0; i0 < len; i0 += TQ) {
      for (int i = tid; i < TQ * N; i += THREADS) {
        const int r = i / N, nn = i % N;
        c_s[r * ld + nn] =
            i0 + r < len ? to_f(Cb[(long long)(c0 + i0 + r) * c_rs + nn]) : 0.f;
      }
      __syncthreads();

      // carried state: acc[i][j] = exp(cum_r) sum_n C[r, n] state[pc, n]
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
      for (int nn = 0; nn < N; ++nn) {
        float cv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = c_s[(ty + 16 * i) * ld + nn];
#pragma unroll
        for (int j = 0; j < 4; ++j) sv[j] = st_s[(tx + 16 * j) * ld + nn];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], sv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = i0 + ty + 16 * i;
        const float e = qi < len ? expf(cum_s[qi]) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
      }

      // intra-chunk: key tiles that hold a key j <= some row of this tile
      const int i_end = min(i0 + TQ, len);
      for (int j0 = 0; j0 < i_end; j0 += TK) {
        __syncthreads();             // last key tile's readers are done
        for (int i = tid; i < TK * N; i += THREADS) {
          const int r = i / N, nn = i % N;
          b_s[r * ld + nn] =
              j0 + r < len ? to_f(Bb[(long long)(c0 + j0 + r) * b_rs + nn]) : 0.f;
        }
        load_x(c0, j0, len);
        __syncthreads();

        // scores for rows ty + 16 i, key columns tx + 16 j, masked by L
        float s[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 4
        for (int nn = 0; nn < N; ++nn) {
          float cv[4], bv[2];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = c_s[(ty + 16 * i) * ld + nn];
#pragma unroll
          for (int j = 0; j < 2; ++j) bv[j] = b_s[(tx + 16 * j) * ld + nn];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty + 16 * i, qi = i0 + r;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = tx + 16 * j, kj = j0 + col;
            // the exponent only where j <= i < len: never above the diagonal
            s_s[r * LDS + col] =
                (kj <= qi && qi < len) ? s[i][j] * expf(cum_s[qi] - cum_s[kj]) : 0.f;
          }
        }
        __syncthreads();

#pragma unroll 8
        for (int kk = 0; kk < TK; ++kk) {
          float sv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) sv[i] = s_s[(ty + 16 * i) * LDS + kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = x_s[kk * MAX_P + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(sv[i], xv[j], acc[i][j]);
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = i0 + ty + 16 * i;
        if (qi >= len) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int pc = tx + 16 * j;
          if (pc < P) yb[(long long)(c0 + qi) * y_rs + pc] = acc[i][j];
        }
      }
      __syncthreads();               // c_s is reloaded for the next tile
    }

    // ---- state update: state exp(total) + (x dt)^T (B o exp(total - cum)) ----
    float upd[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) upd[i][j] = 0.f;
    for (int j0 = 0; j0 < len; j0 += TK) {
      __syncthreads();
      for (int i = tid; i < TK * N; i += THREADS) {
        const int r = i / N, nn = i % N;
        float v = 0.f;
        if (j0 + r < len)
          v = to_f(Bb[(long long)(c0 + j0 + r) * b_rs + nn]) *
              expf(total - cum_s[j0 + r]);
        b_s[r * ld + nn] = v;
      }
      load_x(c0, j0, len);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < TK; ++kk) {
        float xv[4], bv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = x_s[kk * MAX_P + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int nc = tx + 16 * j;
          bv[j] = nc < N ? b_s[kk * ld + nc] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) upd[i][j] = fmaf(xv[i], bv[j], upd[i][j]);
      }
    }
    // every reader of the old state (the carried term above) has passed a
    // barrier since; each thread rewrites only the elements it owns
    const float et = expf(total);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pr = ty + 16 * i;
      if (pr >= P) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int nc = tx + 16 * j;
        if (nc < N) st_s[pr * ld + nc] = st_s[pr * ld + nc] * et + upd[i][j];
      }
    }
  }
  __syncthreads();

  float* fb = fin + (long long)blockIdx.x * P * N;
  for (int i = tid; i < P * N; i += THREADS) fb[i] = st_s[(i / N) * ld + i % N];
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* fin, int Bsz, int S, int H, int G,
           int P, int N, int chunk, long long x_rs, long long b_rs,
           long long c_rs, cudaStream_t stream) {
  const size_t smem = smem_floats(N, chunk) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_fwd<T><<<Bsz * H, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<float*>(y),
      static_cast<float*>(fin), S, H, G, P, N, chunk, x_rs, b_rs, c_rs);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype of x, B and C: 0 = float32, 1 = bfloat16 (dt and A are float32).
// x_rs / b_rs / c_rs: elements between sequence positions of x, B and C;
// their batch stride is S times that.  Returns a cudaError_t (0 = launched).
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, void* y,
                              void* fin, int Bsz, int S, int H, int G, int P,
                              int N, int chunk, long long x_rs,
                              long long b_rs, long long c_rs, int dtype,
                              void* stream) {
  if (Bsz <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 ||
      P > MAX_P || N <= 0 || N > MAX_N || chunk <= 0 || chunk > MAX_CHUNK ||
      S % chunk != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, y, fin, Bsz, S, H, G, P, N, chunk,
                         x_rs, b_rs, c_rs, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, fin, Bsz, S, H, G, P, N,
                                 chunk, x_rs, b_rs, c_rs, s);
  return (int)cudaErrorInvalidValue;
}
