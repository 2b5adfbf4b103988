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
// What bounds it on the card: at the training shape (b 4, S 2048, h 48,
// p 64, g 1, n 128, chunk 256) a call must move about 163 MB (x bf16,
// y fp32, B/C, dt, final state: 49 us at 3.35 TB/s) and needs about 19.6
// GFLOP over the lower triangle of each chunk (20 us at the 989 TFLOP/s
// bf16 tensor-core peak): bytes.  At the prefill shape (S 512) it is a
// quarter of both.
//
// * bfloat16 x/B/C -> three kernels on the tensor cores, the chunk-parallel
//   decomposition of models/ssm.py::ssd_chunked:
//   1. ssd_fwd_state, a block per (batch row x head, chunk): cum of the
//      chunk (written out for pass 3), then the chunk's own state
//      (x o w)^T B, w_t = dt_t exp(cum_last - cum_t), as wgmma m64n128k16
//      with (x o w)^T from registers and B from shared memory (N-major).
//      The states go to an fp32 scratch (b, h, chunks, p, n).
//   2. ssd_fwd_pass, over (batch row x head, a 64 x 128 tile in float4s):
//      the state entering each chunk, prev_c = prev_{c-1} exp(cum_last) +
//      state_{c-1}, a short walk over the chunks with eight chunks' loads
//      in flight, written as hi and lo bf16 tiles already in the swizzled
//      layout pass 3 reads; and the final state.
//   3. ssd_fwd_out, a block per (batch row x head, chunk, 64-row query
//      tile), longest tiles first: o = exp(cum_i) C prev^T (wgmma, both
//      from shared memory), then for each 64-key tile at or below the
//      diagonal S = C B^T (wgmma), M = S o L o dt_j on the accumulator
//      fragments (L's exponent only where j <= i, so a large dt above the
//      diagonal cannot overflow into inf * 0), and o += M x (wgmma, M from
//      registers, x N-major from shared memory).  C, prev and the key
//      tiles come by cp.async straight into the 128-byte swizzle that
//      wgmma reads, key tiles two stages deep, the second stage in prev's
//      place once the carried term is done: 75 KB, three blocks an SM.
//   The passes are bound by latency, not by bytes or tensor work: pass 3
//   got faster with each block an SM it gained and with prev arriving by
//   cp.async instead of through registers (PERF.md).
//   Numerics: the reference computes in fp32 from bf16 inputs.  Products
//   of two inputs (C B^T, and x against anything) are exact in bf16 with
//   fp32 accumulation.  Each fp32 intermediate that becomes a wgmma
//   operand (x o w in pass 1, prev and M in pass 3) is split into
//   hi + lo bf16 (about 16 significant bits) and multiplied twice, so the
//   result keeps the fp32 tolerance; one bf16 rounding would not (the CPU
//   rehearsals in tests/test_torch_ssm.py show both).
//   Shapes: p <= 64 and n <= 128, both multiples of 8, chunk <= 256;
//   x, B and C 16-byte aligned with row strides that keep them so (the
//   wrapper refuses anything else).  Ragged edges (p < 64, n < 128, chunk
//   not a multiple of 64) are zero-filled by the copies and masked.
// * float32 x/B/C -> ssd_fwd, the CUDA-core design of the first port: one
//   block of 256 threads per (batch row, head) walks the chunks in order
//   and carries the (p, n) fp32 state in shared memory; every product in
//   fp32 FMAs from shared memory.  fp32 inputs need fp32 arithmetic (the
//   checks hold them to 1e-4), which the tensor cores do not do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_P = 64;            // head dim
constexpr int MAX_N = 128;           // state dim
constexpr int MAX_CHUNK = 256;

__device__ __forceinline__ float to_f(float x) { return x; }

// ---------------------------------------------------------------- float32

namespace cuda_core {


constexpr int THREADS = 256;
constexpr int TQ = 64;               // query rows per tile
constexpr int TK = 32;               // key rows per tile
constexpr int LDS = TK + 1;          // row stride of the score tile

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

}  // namespace cuda_core

// --------------------------------------------------------------- bfloat16

namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int WG = 128;              // threads a block: one warpgroup
constexpr int TILE = 64;             // rows of a time, query or key tile
constexpr uint32_t ROW = 128;        // bytes of a swizzled tile row: 64 bf16
constexpr uint32_t TILE_N = 2 * TILE * ROW;   // 64 rows x 128 bf16 (B, C, prev)
constexpr uint32_t TILE_P = TILE * ROW;       // 64 rows x 64 bf16 (x)

// Shared memory from a 1024-byte aligned base.  Pass 1: two stages of
// (B, x) time tiles, then dt and w of the chunk.
constexpr uint32_t S1_B = 0, S1_X = 2 * TILE_N, S1_DT = S1_X + 2 * TILE_P;
constexpr uint32_t S1_BYTES = S1_DT + 2 * MAX_CHUNK * 4 + 1024;
// Pass 3: the query tile's C rows; region R1, which holds prev as hi and
// lo tiles for the carried term and then key stage 1; key stage 0; cum and
// dt of the chunk.  A stage is a B tile and an x tile.  75 KB: three
// blocks an SM.
constexpr uint32_t S3_C = 0, S3_R1 = TILE_N, S3_R0 = 3 * TILE_N,
                   S3_CUM = S3_R0 + TILE_N + TILE_P;
constexpr uint32_t S3_BYTES = S3_CUM + 2 * MAX_CHUNK * 4 + 1024;
constexpr uint32_t PREV_BYTES = 2 * TILE_N;   // prev hi and lo of one chunk
static_assert(MAX_CHUNK <= 2 * WG, "pass 1 keeps two positions a thread");

// Byte offset of element (r, col) in a tile of TILE rows stored as
// 64-column panels of 128-byte rows in the 128-byte swizzle (16-byte
// chunk k of row r at chunk k ^ (r % 8)), the layout wgmma reads.
__device__ __forceinline__ uint32_t sw_off(int r, int col) {
  return (col >> 6) * TILE * ROW + r * ROW +
         ((((col & 63) >> 3) ^ (r & 7)) << 4) + (col & 7) * 2;
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}
// this thread's shared-memory writes, visible to the wgmma (async) proxy
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Rows [0, 64) of a bf16 matrix with row stride rs into a swizzled tile of
// W columns (64 or 128), by 16-byte cp.async; rows >= nrows and columns
// >= ncols (a multiple of 8) are zero-filled.
template <int W>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long rs, int nrows, int ncols) {
  constexpr int CH = W / 8;          // 16-byte chunks a row
#pragma unroll 4
  for (int i = threadIdx.x; i < TILE * CH; i += WG) {
    const int r = i / CH, col = (i % CH) * 8;
    const bool ok = r < nrows && col < ncols;
    cp16(dst + sw_off(r, col), ok ? src + r * rs + col : src, ok);
  }
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle.  lbo / sbo in
// bytes: for a K-major operand sbo is the step between 8-row groups and
// lbo is unused; for an N-major one lbo is the step between 64-column
// panels and sbo the step between 8-row groups of K.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// D[64 x 64] += A[64 x 16] * B[16 x 64]: A and B from shared memory, both
// K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64]: A from registers (the
// accumulator layout of a 64 x 16 slice), B from shared memory N-major
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128]: A from registers, B from
// shared memory N-major (two 64-column panels)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// (a, b) ~= hi + lo, each a pair of bf16 (a in the low half, the A
// fragment's order): about 16 significant bits of each value
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - f.x, b - f.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// cum[t] = sum_{u <= t} a dt_u over one chunk (dt_u at dtc[u * stride],
// kept in dts[u]), by the 32 lanes of one warp: a run per lane, then a
// shuffle scan
__device__ __forceinline__ void chunk_cumsum(float* cum, float* dts,
                                             const float* dtc, int stride,
                                             int len, float a, int lane) {
  constexpr int PER = MAX_CHUNK / 32;
  const int per = (len + 31) / 32;
  const int lo = min(lane * per, len), hi = min(lo + per, len);
  float v[PER];                      // every load in flight before the sums
#pragma unroll
  for (int k = 0; k < PER; ++k)
    v[k] = lo + k < hi ? dtc[(long long)(lo + k) * stride] : 0.f;
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    run += a * v[k];
    if (lo + k < hi) {
      cum[lo + k] = run;
      dts[lo + k] = v[k];
    }
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  const float excl = incl - run;
  for (int t = lo; t < hi; ++t) cum[t] += excl;
}

struct Smem {
  uint32_t base;                     // shared-window address, 1024-aligned
  uint8_t* gen;                      // the same bytes, generic pointer
  __device__ __forceinline__ explicit Smem(uint8_t* raw) {
    const uint32_t r = (uint32_t)__cvta_generic_to_shared(raw);
    base = (r + 1023u) & ~1023u;
    gen = raw + (base - r);
  }
};

// Pass 1.  The accumulator of a wgmma m64nN: thread t of the warpgroup
// holds, for each 8-column group j, (row 16 w + t%32/4, cols 8 j +
// 2 (t%4) + {0, 1}) in d[4j], d[4j+1] and the same columns of row + 8 in
// d[4j+2], d[4j+3] (w = t / 32); an A fragment of a 64 x 16 slice holds
// (row, k 2 (t%4) + {0, 1}), (row + 8, same), (row, k + 8), (row + 8, k + 8).
// The (x o w)^T fragments of one 16-row slice of time are built right
// before their two wgmmas, so few registers hold them.
__global__ void __launch_bounds__(WG)
ssd_fwd_state(const bf16* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const bf16* __restrict__ Bm,
              float* __restrict__ cum_g, float* __restrict__ states, int S,
              int H, int G, int P, int N, int chunk, long long x_rs,
              long long b_rs) {
  extern __shared__ uint8_t smem_raw[];
  const Smem sm(smem_raw);
  float* dt_s = reinterpret_cast<float*>(sm.gen + S1_DT);
  float* w_s = dt_s + MAX_CHUNK;     // cum first, then w

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, c = blockIdx.y, nc = gridDim.y;
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int c0 = c * chunk, len = chunk;
  const float* dtc = dt + ((long long)b * S + c0) * H + h;
  const bf16* xc = x + ((long long)b * S + c0) * x_rs + (long long)h * P;
  const bf16* Bc = Bm + ((long long)b * S + c0) * b_rs + (long long)g * N;
  const int n_t = (len + TILE - 1) / TILE;

  auto load = [&](int t) {           // time tile t into stage t % 2
    const int r0 = t * TILE, st = t & 1;
    load_tile<128>(sm.base + S1_B + st * TILE_N, Bc + r0 * b_rs, b_rs, len - r0, N);
    load_tile<64>(sm.base + S1_X + st * TILE_P, xc + r0 * x_rs, x_rs, len - r0, P);
    cp_commit();
  };
  load(0);
  if (warp == 0) chunk_cumsum(w_s, dt_s, dtc, H, len, A[h], lane);
  __syncthreads();
  const float last = w_s[len - 1];
  float cum[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {      // the chunk's cum, before w replaces it
    const int t = tid + k * WG;
    cum[k] = t < len ? w_s[t] : 0.f;
    if (t < len) cum_g[(long long)bh * S + c0 + t] = cum[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 2; ++k) {      // w over whole time tiles, zero past len
    const int t = tid + k * WG;
    if (t < n_t * TILE) w_s[t] = t < len ? dt_s[t] * expf(last - cum[k]) : 0.f;
  }

  const int row = 16 * warp + (lane >> 2), kc = 2 * (lane & 3);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int t = 0; t < n_t; ++t) {
    if (t + 1 < n_t) {
      load(t + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    fence_async_smem();
    __syncthreads();                 // stage t % 2 and w_s are in place
    const int st = t & 1;
    const uint8_t* xs = sm.gen + S1_X + st * TILE_P;
    const float* ws = w_s + t * TILE;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 time rows a slice
      // (x o w)^T: rows p, k = time; hi and lo fragments
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pp = row + ((e & 1) ? 8 : 0);
        const int k = 16 * kk + kc + ((e & 2) ? 8 : 0);
        const float v0 = __bfloat162float(
            *reinterpret_cast<const bf16*>(xs + sw_off(k, pp))) * ws[k];
        const float v1 = __bfloat162float(
            *reinterpret_cast<const bf16*>(xs + sw_off(k + 1, pp))) * ws[k + 1];
        split_pair(v0, v1, ah[e], al[e]);
      }
      fence_regs(acc);
      wgmma_fence();
      const uint64_t db = sw128_desc(sm.base + S1_B + st * TILE_N + kk * 16 * ROW,
                                     TILE * ROW, 1024);
      wgmma_rs_n128(acc, ah, db);
      wgmma_rs_n128(acc, al, db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncthreads();                 // every warp is done with this stage
  }

  float* sb = states + ((long long)bh * nc + c) * P * N;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int nn = 8 * j + kc;
    if (nn >= N) continue;
    if (row < P)
      *reinterpret_cast<float2*>(sb + (long long)row * N + nn) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (row + 8 < P)
      *reinterpret_cast<float2*>(sb + (long long)(row + 8) * N + nn) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// Pass 2: the state entering each chunk c >= 1, prev_c, as hi and lo bf16
// tiles of 64 rows (p) x 128 columns (n) in the swizzled layout that pass 3
// copies as it is (zero outside (p, n)), and the final state.  A thread
// walks one float4 of the tile through the chunks of one (batch row,
// head), eight chunks' loads in flight at a time.
__global__ void __launch_bounds__(256)
ssd_fwd_pass(const float* __restrict__ states, const float* __restrict__ cum_g,
             uint8_t* __restrict__ prev, float* __restrict__ fin, int S,
             int nc, int chunk, int P, int N) {
  constexpr int AHEAD = 8;
  const int bh = blockIdx.x;
  const int i = blockIdx.y * blockDim.x + threadIdx.x;   // < 64 x 32
  const int pp = i >> 5, nn = (i & 31) * 4;
  const bool valid = pp < P && nn < N;
  const long long pn = (long long)P * N;
  const float* st = states + (long long)bh * nc * pn + (valid ? pp * N + nn : 0);
  const float* cb = cum_g + (long long)bh * S + chunk - 1;
  uint8_t* pb = prev + (long long)bh * nc * PREV_BYTES + sw_off(pp, nn);
  float4 run = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += AHEAD) {
    float4 v[AHEAD];
    float e[AHEAD];
#pragma unroll
    for (int k = 0; k < AHEAD; ++k)
      if (c0 + k < nc) {
        v[k] = valid ? *reinterpret_cast<const float4*>(st + (c0 + k) * pn)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
        e[k] = expf(cb[(long long)(c0 + k) * chunk]);
      }
#pragma unroll
    for (int k = 0; k < AHEAD; ++k)
      if (c0 + k < nc) {
        if (c0 + k > 0) {
          uint32_t h0, l0, h1, l1;
          split_pair(run.x, run.y, h0, l0);
          split_pair(run.z, run.w, h1, l1);
          uint8_t* t = pb + (long long)(c0 + k) * PREV_BYTES;
          *reinterpret_cast<uint2*>(t) = make_uint2(h0, h1);
          *reinterpret_cast<uint2*>(t + TILE_N) = make_uint2(l0, l1);
        }
        run = make_float4(fmaf(run.x, e[k], v[k].x), fmaf(run.y, e[k], v[k].y),
                          fmaf(run.z, e[k], v[k].z), fmaf(run.w, e[k], v[k].w));
      }
  }
  if (valid)
    *reinterpret_cast<float4*>(fin + (long long)bh * pn + pp * N + nn) = run;
}

// Pass 3 (fragment layouts as in pass 1).  The carried term comes first,
// so that prev's region can take key stage 1 afterwards.
__global__ void __launch_bounds__(WG)
ssd_fwd_out(const bf16* __restrict__ x, const float* __restrict__ dt,
            const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
            const float* __restrict__ cum_g, const uint8_t* __restrict__ prev,
            float* __restrict__ y, int S, int H, int G, int P, int N,
            int chunk, long long x_rs, long long b_rs, long long c_rs) {
  extern __shared__ uint8_t smem_raw[];
  const Smem sm(smem_raw);
  float* cum_s = reinterpret_cast<float*>(sm.gen + S3_CUM);
  float* dt_s = cum_s + MAX_CHUNK;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, c = blockIdx.y, nc = gridDim.y;
  const int qt = gridDim.z - 1 - blockIdx.z;   // the longest query tiles first
  const int b = bh / H, h = bh % H, g = h / (H / G);
  const int c0 = c * chunk, len = chunk, i0 = qt * TILE;
  const float* dtc = dt + ((long long)b * S + c0) * H + h;
  const bf16* xc = x + ((long long)b * S + c0) * x_rs + (long long)h * P;
  const bf16* Bc = Bm + ((long long)b * S + c0) * b_rs + (long long)g * N;
  const bf16* Cc = Cm + ((long long)b * S + c0) * c_rs + (long long)g * N;
  const int n_kt = qt + 1;                      // key tiles at or below the diagonal
  const int n_pos = min(len, i0 + TILE);        // positions the tile reads
  const uint32_t stage0 = sm.base + S3_R0, stage1 = sm.base + S3_R1;

  auto load_kv = [&](int kt) {       // key tile kt into stage kt % 2
    const int r0 = kt * TILE;
    const uint32_t st = (kt & 1) ? stage1 : stage0;
    load_tile<128>(st, Bc + r0 * b_rs, b_rs, len - r0, N);
    load_tile<64>(st + TILE_N, xc + r0 * x_rs, x_rs, len - r0, P);
    cp_commit();
  };
  // one group: the C rows, prev (hi, lo; none for the first chunk) and key tile 0
  load_tile<128>(sm.base + S3_C, Cc + (long long)i0 * c_rs, c_rs, len - i0, N);
  const bool carried = c > 0;
  if (carried) {
    const uint8_t* pv = prev + ((long long)bh * nc + c) * PREV_BYTES;
    for (int k = tid; k < (int)PREV_BYTES / 16; k += WG)
      cp16(stage1 + 16 * k, pv + 16 * k, true);
  }
  load_kv(0);
  for (int t = tid; t < n_pos; t += WG) {
    cum_s[t] = cum_g[(long long)bh * S + c0 + t];
    dt_s[t] = dtc[(long long)t * H];
  }

  const int row = 16 * warp + (lane >> 2), kc = 2 * (lane & 3);
  const int n_k = (N + 15) / 16;                // k16 steps over n
  float o[32], s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  cp_wait<0>();
  fence_async_smem();
  __syncthreads();                   // C, prev, key tile 0, cum and dt in place
  // this thread's rows' cum (rows past the chunk are never stored)
  const float ci0 = cum_s[min(i0 + row, n_pos - 1)];
  const float ci1 = cum_s[min(i0 + row + 8, n_pos - 1)];
  if (carried) {
    // o = exp(cum_i) C prev^T, prev as hi + lo
    fence_regs(o);
    wgmma_fence();
    for (int kk = 0; kk < n_k; ++kk) {
      const uint32_t kcol = (kk >> 2) * TILE * ROW + (kk & 3) * 32;
      const uint64_t da = sw128_desc(sm.base + S3_C + kcol, 16, 1024);
      wgmma_ss_n64(o, da, sw128_desc(stage1 + kcol, 16, 1024));
      wgmma_ss_n64(o, da, sw128_desc(stage1 + TILE_N + kcol, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    const float e0 = expf(ci0), e1 = expf(ci1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[4 * j] *= e0;
      o[4 * j + 1] *= e0;
      o[4 * j + 2] *= e1;
      o[4 * j + 3] *= e1;
    }
    __syncthreads();                 // prev's region is free for key stage 1
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      load_kv(kt + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    fence_async_smem();
    __syncthreads();                 // this key tile's stage is in place
    const uint32_t st = (kt & 1) ? stage1 : stage0;

    // S = C B^T over the key tile
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
    for (int kk = 0; kk < n_k; ++kk) {
      const uint32_t kcol = (kk >> 2) * TILE * ROW + (kk & 3) * 32;
      wgmma_ss_n64(s, sw128_desc(sm.base + S3_C + kcol, 16, 1024),
                   sw128_desc(st + kcol, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // M = S o L o dt_j, with L's exponent only where j <= i < len
    const int k0 = kt * TILE;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = i0 + row + ((e & 2) ? 8 : 0);
        const int kj = k0 + 8 * j + kc + (e & 1);
        float m = 0.f;
        if (kj <= qi && qi < len)
          m = s[4 * j + e] * expf(((e & 2) ? ci1 : ci0) - cum_s[kj]) * dt_s[kj];
        s[4 * j + e] = m;
      }
    // the accumulator's columns [16 kk, 16 kk + 16) are the A fragment of
    // a 64 x 16 slice
    uint32_t mh[4][4], ml[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_pair(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1], mh[kk][e], ml[kk][e]);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 keys of x: two 8-row groups
      const uint64_t db = sw128_desc(st + TILE_N + kk * 16 * ROW, TILE * ROW, 1024);
      wgmma_rs_n64(o, mh[kk], db);
      wgmma_rs_n64(o, ml[kk], db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncthreads();                 // every warp is done with this stage
  }

  const long long y_rs = (long long)H * P;
  float* yb = y + ((long long)b * S + c0 + i0) * y_rs + (long long)h * P;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row + 8 * r;
    if (i0 + i >= len) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int pp = 8 * j + kc;
      if (pp < P)
        *reinterpret_cast<float2*>(yb + i * y_rs + pp) =
            make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
    }
  }
}

int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* fin, void* cum, void* states,
           void* prev, int Bsz, int S, int H, int G, int P, int N, int chunk,
           long long x_rs, long long b_rs, long long c_rs,
           cudaStream_t stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(Bm) |
                         reinterpret_cast<uintptr_t>(Cm) |
                         reinterpret_cast<uintptr_t>(prev);
  if (addr % 16 || (x_rs | b_rs | c_rs) % 8 || P % 8 || N % 8)
    return (int)cudaErrorMisalignedAddress;   // 16-byte copies
  if (!cum || !states || !prev) return (int)cudaErrorInvalidValue;
  // on every call: the opt-in belongs to the current card
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_state, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S1_BYTES);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      ssd_fwd_out, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S3_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int nc = S / chunk;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* Bb = static_cast<const bf16*>(Bm);
  const float* dtf = static_cast<const float*>(dt);
  float* cumf = static_cast<float*>(cum);
  float* stf = static_cast<float*>(states);
  uint8_t* pv = static_cast<uint8_t*>(prev);
  ssd_fwd_state<<<dim3(Bsz * H, nc), WG, S1_BYTES, stream>>>(
      xb, dtf, static_cast<const float*>(A), Bb, cumf, stf, S, H, G, P, N,
      chunk, x_rs, b_rs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_fwd_pass<<<dim3(Bsz * H, TILE * 32 / 256), 256, 0, stream>>>(
      stf, cumf, pv, static_cast<float*>(fin), S, nc, chunk, P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_fwd_out<<<dim3(Bsz * H, nc, (chunk + TILE - 1) / TILE), WG, S3_BYTES,
                stream>>>(xb, dtf, Bb, static_cast<const bf16*>(Cm), cumf, pv,
                          static_cast<float*>(y), S, H, G, P, N, chunk, x_rs,
                          b_rs, c_rs);
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace

// dtype of x, B and C: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor
// cores; dt and A are float32 either way).  x_rs / b_rs / c_rs: elements
// between sequence positions of x, B and C; their batch stride is S times
// that.  cum (b, h, S) and states (b, h, S / chunk, p, n), both fp32, and
// prev (b, h, S / chunk, 2, 64, 128) bf16 are the bfloat16 path's scratch
// (null for float32).  Returns a cudaError_t (0 = launched).
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, void* y,
                              void* fin, void* cum, void* states, void* prev,
                              int Bsz,
                              int S, int H, int G, int P, int N, int chunk,
                              long long x_rs, long long b_rs, long long c_rs,
                              int dtype, void* stream) {
  if (Bsz <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 ||
      P > MAX_P || N <= 0 || N > MAX_N || chunk <= 0 || chunk > MAX_CHUNK ||
      S % chunk != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return cuda_core::launch<float>(x, dt, A, Bm, Cm, y, fin, Bsz, S, H, G, P,
                                    N, chunk, x_rs, b_rs, c_rs, s);
  if (dtype == 1)
    return tc::launch(x, dt, A, Bm, Cm, y, fin, cum, states, prev, Bsz, S, H,
                      G, P, N, chunk, x_rs, b_rs, c_rs, s);
  return (int)cudaErrorInvalidValue;
}
