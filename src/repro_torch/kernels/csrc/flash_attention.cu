// Blockwise online-softmax attention forward (prefill) for Hopper.
//
// Replaces src/repro/kernels/flash_attention.py:31 (_attn_kernel, the
// Pallas TPU kernel behind repro.kernels.ops.flash_attention).  Same
// contract as repro_torch/kernels/ref.py::attention_ref: scale 1/sqrt(hd),
// a key visible under causal when k <= q + q_offset or k < prefix_len (a
// bidirectional prefix, paligemma's image tokens: the mask of
// repro/models/attention.py::_mask_bias, which the Pallas kernel lacks and
// the JAX package computes on its jnp paths), and under window also when
// k > q + q_offset - window; masked scores set to -1e30 before the
// softmax, fp32 (m, l, acc) statistics, output divided by max(l, 1e-20)
// and written in the input type.  hd is 64, 80, 128 or 256.
//
// Layout: q (B, Sq, H, hd), k/v (B, Sk, KV, hd), out (B, Sq, H, hd), all
// contiguous.  GQA is read by index (q head h uses kv head h / (H / KV)),
// so the repeat the TPU wrapper materialises never exists here.  K tiles
// that are fully masked for a whole 64-row q tile are never visited, as
// _attn_kernel skips them; the ragged edges (k >= Sk, q >= Sq) are masked
// here, so the TPU wrapper's padding and shrink_block_k are not needed.
//
// What bounds it on the card: at the serving shape (B=4, S=512, H=32,
// KV=8, hd=128, causal) a call needs about 8.6 GFLOP (8.7 us at the 989
// TFLOP/s bf16 tensor-core peak) and moves about 42 MB (12.5 us at 3.35
// TB/s): bytes by a little, operations close behind.  At the profiler's
// shape (1, 4096, 32, 128) it is 137 GFLOP (0.139 ms) against 134 MB
// (0.040 ms): operations; at paligemma's prefill (4, 768, 8 over 1, 256)
// with its 256-key prefix, 55.6% of the (q, k) pairs are visible: 10.7
// GFLOP (0.0109 ms) against 28.3 MB (0.0085 ms), operations.  Either way the tensor cores set the pace, so
// each dtype takes the design that its arithmetic allows:
//
// * bfloat16 -> attn_fwd_tc, on the tensor cores.  A block of two
//   warpgroups (256 threads) takes 128 q rows of one head, 64 rows a
//   warpgroup, so each K/V tile in shared memory serves both.  TMA copies
//   the Q rows once and each 64-key K/V tile into 128-byte-swizzled shared
//   memory, two stages deep on mbarriers, so the next tile's copy overlaps
//   this tile's math.  S = Q K^T is a wgmma m64n64k16 chain with both
//   operands in shared memory and the fp32 accumulator in registers; the
//   mask and the online softmax run on those fragments (a row's max and
//   sum are shuffles over the 4 lanes that hold it); P is rounded to bf16
//   in registers and P V is a second wgmma chain (m64n{hd}k16) with P from
//   registers and V from shared memory (N-major).  hd 80 (zamba2) is held
//   as two 64-column panels that TMA zero-fills past column 80: five k16
//   steps of Q K^T, and P V as m64n128k16, the last 48 columns computed on
//   zeros and never stored.  hd 256 (paligemma) is four panels: sixteen
//   k16 steps of Q K^T, and P V as two m64n128k16 chains, one over panels
//   0-1 and one over panels 2-3, into the two halves of a 128-register
//   accumulator a thread.  A warpgroup skips the
//   tiles fully masked for its own 64 rows.  Rounding P to bf16 is the one
//   departure from the fp32 reference (which keeps P in fp32): rehearsed
//   on the CPU against the JAX reference (tests/test_torch_kernels.py) it
//   stays inside the bf16 tolerance the card checks hold it to.  Blocks of
//   the longest causal rows run first.  A software-pipelined variant
//   (the next tile's Q K^T and this tile's P V in flight during the
//   softmax) measured slower on an H100 and is not kept (PERF.md).
// * float32 -> attn_fwd, the CUDA-core design of the first port: Q and
//   each 64-row K/V tile staged as fp32 in shared memory (row stride
//   hd + 1), S and P V as 4x4 fp32 FMA micro-tiles.  fp32 inputs need fp32
//   arithmetic (the checks hold them to 1e-4), which the tensor cores do
//   not do, so this path is capped near the 67 TFLOP/s fp32 rate.

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;               // q rows per tile (a block of the fp32 kernel)
constexpr int BK = 64;               // keys per tile
constexpr float NEG_INF = -1e30f;    // the reference's mask value

// The k tiles [begin, end) that hold an unmasked key for some row of the
// `rows` q rows from q0 (the same run condition as _attn_kernel); under
// causal the prefix's tiles are visible to every row.
__device__ __forceinline__ void k_tile_range(int q0, int rows, int Sk,
                                             int causal, int window,
                                             int q_offset, int prefix_len,
                                             int& begin, int& end) {
  const int q_lo = q0 + q_offset, q_hi = q0 + rows - 1 + q_offset;
  end = (Sk + BK - 1) / BK;
  if (causal)
    end = min(end, max(q_hi < 0 ? 0 : q_hi / BK + 1, (prefix_len + BK - 1) / BK));
  begin = 0;
  if (window > 0) {
    const int lo = q_lo - window + 1;
    begin = lo > 0 ? lo / BK : 0;
  }
}

// ---------------------------------------------------------------- float32

namespace cuda_core {


constexpr int THREADS = 256;
constexpr int LDP = BK + 1;          // row stride of the score tile

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (3 * BQ * (HD + 1) + BQ * LDP + 3 * BQ);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
attn_fwd(const float* __restrict__ q, const float* __restrict__ k,
         const float* __restrict__ v, float* __restrict__ out,
         int Sq, int Sk, int H, int KV, int causal, int window, int q_offset,
         int prefix_len, float scale) {
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
  const float* qb = q + ((long)b * Sq * H + h) * HD;
  const float* kb = k + ((long)b * Sk * KV + kvh) * HD;
  const float* vb = v + ((long)b * Sk * KV + kvh) * HD;
  float* ob = out + ((long)b * Sq * H + h) * HD;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    q_s[r * LD + d] = (q0 + r < Sq) ? qb[(q0 + r) * q_row + d] : 0.f;
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

  int kt_begin, kt_end;
  k_tile_range(q0, BQ, Sk, causal, window, q_offset, prefix_len, kt_begin,
               kt_end);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                 // last tile's readers are done
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int r = i / HD, d = i % HD;
      const bool in = k0 + r < Sk;
      k_s[r * LD + d] = in ? kb[(k0 + r) * kv_row + d] : 0.f;
      v_s[r * LD + d] = in ? vb[(k0 + r) * kv_row + d] : 0.f;
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
        if (causal) ok = kp <= qp || kp < prefix_len;
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
      ob[(q0 + r) * q_row + cg + 16 * c] = acc[i][c] / l;
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int KV, int causal, int window,
           int q_offset, int prefix_len, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  attn_fwd<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, H, KV,
      causal, window, q_offset, prefix_len, 1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

}  // namespace cuda_core

// --------------------------------------------------------------- bfloat16

namespace tc {

constexpr int WGS = 2;               // warpgroups a block, 64 q rows each
constexpr int BQB = WGS * BQ;        // q rows a block
constexpr int THREADS = 128 * WGS;
constexpr int PANEL = 64;            // bf16 columns in one 128-byte swizzle row
constexpr uint32_t ROW_BYTES = 128;

// Shared memory, from a 1024-byte aligned base: the block's Q rows, then
// two stages of K and of V.  Each tile is stored as ceil(hd / 64) panels
// of (rows x 64 columns), one 128-byte row per tile row, in the 128-byte
// swizzle that TMA writes and wgmma reads.  At hd 80 the second panel
// holds columns 64-79 and TMA's zero fill past hd: Q K^T reads 5 k16 steps
// and never the zeros; P V runs n128 over V's zero columns (37.5% of its
// work), whose outputs are never stored.  At hd 256 (four panels) Q, two
// K stages and two V stages take 64 KiB each: 197,656 bytes with the
// barriers and the slack, inside the 227 KB opt-in.
template <int HD>
struct Smem {
  static_assert(HD % 16 == 0, "Q K^T takes k16 steps");
  static constexpr int NP = (HD + PANEL - 1) / PANEL;
  static constexpr int ON = NP * PANEL;        // output columns P V computes
  static constexpr uint32_t Q = 0;
  static constexpr uint32_t K = Q + NP * BQB * ROW_BYTES;
  static constexpr uint32_t V = K + 2 * NP * BK * ROW_BYTES;
  static constexpr uint32_t BARS = V + 2 * NP * BK * ROW_BYTES;
  static constexpr uint32_t BYTES = BARS + 3 * 8 + 1024;   // + alignment slack
  // the bytes TMA counts for a stage or for Q: whole boxes, the zero
  // fill of columns past hd included
  static constexpr uint32_t TILE = NP * BK * ROW_BYTES;      // one K or V stage
  static constexpr uint32_t Q_TX = NP * BQB * ROW_BYTES;
};

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Waits for the phase with the given parity to complete.  A copy that
// never lands (a wrong byte count) traps after ~10 s instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > 20000000000ll) __trap();
  }
}

// One box of a 4-d tensor map (coordinates innermost first) into shared
// memory; completion is counted on `bar` in bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
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

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64]: A and B from shared memory,
// both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                               int accumulate) {
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
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64]: A from registers (the
// accumulator layout of a 64 x 16 slice), B from shared memory N-major
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128]: A from registers (the
// accumulator layout of a 64 x 16 slice), B from shared memory N-major; D
// is d[OFF, OFF + 64), so that two calls fill the halves of an m64n256
// accumulator with every element named by a constant index (a cast to a
// sub-array could put the accumulator in local memory, which the
// asynchronous wgmma must not write through)
template <int OFF = 0, int N>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[N], const uint32_t (&a)[4],
                                               uint64_t db, int accumulate) {
  static_assert(OFF % 64 == 0 && OFF + 64 <= N, "a 64-register slice of d");
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
      : "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]),
        "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
        "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]),
        "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
        "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]),
        "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
        "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]),
        "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31]),
        "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]),
        "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]),
        "+f"(d[OFF + 40]), "+f"(d[OFF + 41]), "+f"(d[OFF + 42]), "+f"(d[OFF + 43]),
        "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
        "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]),
        "+f"(d[OFF + 52]), "+f"(d[OFF + 53]), "+f"(d[OFF + 54]), "+f"(d[OFF + 55]),
        "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]),
        "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// What one warpgroup needs to issue its wgmmas and mask its scores.
template <int HD>
struct Tile {
  uint32_t q;                        // this warpgroup's Q rows in shared memory
  uint32_t k, v;                     // stage 0 of K and V
  int q0, Sk, causal, window, q_offset, prefix_len;
  float scale_log2;

  // S = Q K^T for the tile in `stage`, issued and committed, not awaited
  __device__ __forceinline__ void issue_qk(float (&s)[32], int stage) const {
#pragma unroll
    for (int j = 0; j < 32; ++j) s[j] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t col = (kk / 4) * BQB * ROW_BYTES + (kk % 4) * 32;
      wgmma_ss_n64(s, sw128_desc(q + col, 16, 1024),
                   sw128_desc(k + stage * Smem<HD>::TILE +
                                  (kk / 4) * BK * ROW_BYTES + (kk % 4) * 32,
                              16, 1024),
                   kk > 0);
    }
    wgmma_commit();
  }

  // o += P V for the tile in `stage`, issued and committed, not awaited
  // (the caller fences o before the first wgmma of the stage).  At ON 256
  // two n128 chains: columns 0-127 from panels 0-1 into o[0, 64), columns
  // 128-255 from panels 2-3 into o[64, 128), the accumulator layout of one
  // m64n256 (8-column group j in o[4 j, 4 j + 4)).
  __device__ __forceinline__ void issue_pv(float (&o)[Smem<HD>::ON / 2],
                                           const uint32_t (&pa)[BK / 16][4],
                                           int stage) const {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {   // 16 keys: two 8-row groups of V
      const uint32_t at = v + stage * Smem<HD>::TILE + kk * 16 * ROW_BYTES;
      const uint64_t db = sw128_desc(at, BK * ROW_BYTES, 1024);
      if constexpr (Smem<HD>::ON == 64) {
        wgmma_rs_n64(o, pa[kk], db, 1);
      } else if constexpr (Smem<HD>::ON == 128) {
        wgmma_rs_n128(o, pa[kk], db, 1);
      } else {
        static_assert(Smem<HD>::ON == 256, "P V covers 64, 128 or 256 columns");
        wgmma_rs_n128<0>(o, pa[kk], db, 1);
        wgmma_rs_n128<64>(o, pa[kk], sw128_desc(at + 2 * BK * ROW_BYTES, BK * ROW_BYTES,
                                                1024), 1);
      }
    }
    wgmma_commit();
  }

  // Scores of the tile at key k0 -> bf16 P in pa (the A fragment of P V),
  // with the online-softmax update of (m, l) and the factor alpha that
  // rescales the output so far.  Rows row0 (r = 0) and row0 + 8 (r = 1).
  __device__ __forceinline__ void softmax(float (&s)[32], int k0, int row0,
                                          int col0, float (&m)[2],
                                          float (&l)[2], float (&alpha)[2],
                                          uint32_t (&pa)[BK / 16][4]) const {
    // scale into the log2 domain and mask; a tile inside every row's
    // causal bound (or inside the prefix) and window bound, and inside Sk,
    // needs no mask
    const bool unmasked =
        k0 + BK <= Sk &&
        (!causal || k0 + BK - 1 <= q0 + q_offset || k0 + BK <= prefix_len) &&
        (window <= 0 || k0 > q0 + BQ - 1 + q_offset - window);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float x = s[j] * scale_log2;
      if (!unmasked) {
        const int qp = q0 + row0 + ((j & 2) ? 8 : 0) + q_offset;
        const int kp = k0 + 8 * (j >> 2) + col0 + (j & 1);
        bool ok = true;
        if (causal) ok = kp <= qp || kp < prefix_len;
        if (window > 0) ok = ok && kp > qp - window;
        // keys past Sk do not exist in the reference: -inf gives them
        // exactly zero weight; masked keys that do exist get -1e30 as there
        x = kp >= Sk ? -INFINITY : (ok ? x : NEG_INF);
      }
      s[j] = x;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {    // a row's max and sum: 4 lanes
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p0 = exp2f(s[4 * j + 2 * r] - m_new);
        const float p1 = exp2f(s[4 * j + 2 * r + 1] - m_new);
        s[4 * j + 2 * r] = p0;
        s[4 * j + 2 * r + 1] = p1;
        sum += p0 + p1;
      }
      l[r] = l[r] * alpha[r] + sum;  // this thread's share of the row sum
    }
    // the accumulator's columns [16 kk, 16 kk + 16) are exactly the
    // register fragment of a 64 x 16 A slice
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
  }
};

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

// The accumulator of a wgmma m64nN: thread t of the warpgroup holds, for
// each 8-column group j, (row 16 w + t%32/4, cols 8 j + 2 (t%4) + {0, 1})
// in d[4j], d[4j+1] and the same columns of row + 8 in d[4j+2], d[4j+3]
// (w = t / 32).
template <int HD>
__global__ void __launch_bounds__(THREADS)
attn_fwd_tc(const __grid_constant__ CUtensorMap q_map,
            const __grid_constant__ CUtensorMap k_map,
            const __grid_constant__ CUtensorMap v_map,
            __nv_bfloat16* __restrict__ out, int Sq, int Sk, int H, int KV,
            int causal, int window, int q_offset, int prefix_len,
            float scale_log2) {
  using L = Smem<HD>;
  constexpr int NP = L::NP;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::BARS;
  const uint32_t bar_kv = bar_q + 8;            // + 8 * stage
  const CUtensorMap* kmap = &k_map;
  const CUtensorMap* vmap = &v_map;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int qb = (gridDim.z - 1 - blockIdx.z) * BQB;  // longest blocks first
  const int q0 = qb + wg * BQ;                         // this warpgroup's rows
  const int kvh = h / (H / KV);
  int kt_begin, kt_end, wg_begin, wg_end;   // the block's tiles, and this warpgroup's
  k_tile_range(qb, BQB, Sk, causal, window, q_offset, prefix_len, kt_begin, kt_end);
  k_tile_range(q0, BQ, Sk, causal, window, q_offset, prefix_len, wg_begin, wg_end);
  if (q0 >= Sq) wg_end = wg_begin;          // rows past Sq: nothing to compute
  const int n_tiles = max(kt_end - kt_begin, 0);
  // does this warpgroup compute tile i of the block's run?  (uniform over it)
  auto mine = [=](int i) {
    return i < n_tiles && kt_begin + i >= wg_begin && kt_begin + i < wg_end;
  };

  auto load_kv = [=](int i) {        // tile i of the run into stage i % 2
    const int stage = i & 1, k0 = (kt_begin + i) * BK;
    const uint32_t bar = bar_kv + 8 * stage;
    mbar_expect_tx(bar, 2 * L::TILE);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const uint32_t off = stage * L::TILE + p * BK * ROW_BYTES;
      tma_load(base + L::K + off, kmap, bar, p * PANEL, kvh, k0, b);
      tma_load(base + L::V + off, vmap, bar, p * PANEL, kvh, k0, b);
    }
  };
  if (tid == 0) {
    mbar_init(bar_q);
    mbar_init(bar_kv);
    mbar_init(bar_kv + 8);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, L::Q_TX);
#pragma unroll
    for (int p = 0; p < NP; ++p)
      tma_load(base + L::Q + p * BQB * ROW_BYTES, &q_map, bar_q, p * PANEL, h,
               qb, b);
    for (int i = 0; i < 2 && i < n_tiles; ++i) load_kv(i);
  }

  const Tile<HD> tile{base + L::Q + wg * BQ * ROW_BYTES, base + L::K, base + L::V,
                      q0, Sk, causal, window, q_offset, prefix_len, scale_log2};
  const int row0 = 16 * warp + (lane >> 2);   // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (lane & 3);
  float o[L::ON / 2];
#pragma unroll
  for (int i = 0; i < L::ON / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
  float s[32];
  uint32_t pa[BK / 16][4];
  mbar_wait(bar_q, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i & 1;
    mbar_wait(bar_kv + 8 * stage, (i >> 1) & 1);
    if (mine(i)) {
      tile.issue_qk(s, stage);
      wgmma_wait_all();
      fence_regs(s);
      tile.softmax(s, (kt_begin + i) * BK, row0, col0, m, l, alpha, pa);
      rescale(o, alpha);
      fence_regs(o);
      tile.issue_pv(o, pa, stage);
      wgmma_wait_all();
      fence_regs(o);
    }
    __syncthreads();                 // every warp is done with this stage
    if (tid == 0 && i + 2 < n_tiles) load_kv(i + 2);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int q = q0 + row0 + 8 * r;
    if (q >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-20f);
    __nv_bfloat16* ob = out + (((long)b * Sq + q) * H + h) * HD + col0;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)     // the first hd of the ON columns
      *reinterpret_cast<__nv_bfloat162*>(ob + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime so that
// the library needs no link against libcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// (B, S, heads, hd) bf16 as a 4-d map, boxes of (rows x 64 columns) of one
// head, 128-byte swizzle; rows past S read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
              int hd, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {PANEL, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encoder()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                   const_cast<void*>(ptr), dims, strides, box, unit,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int KV, int causal, int window,
           int q_offset, int prefix_len, cudaStream_t stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  if (addr % 16) return (int)cudaErrorMisalignedAddress;  // TMA needs 16 B
  if (!encoder()) return (int)cudaErrorNotSupported;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, q, B, Sq, H, HD, BQB) || !make_map(&km, k, B, Sk, KV, HD, BK) ||
      !make_map(&vm, v, B, Sk, KV, HD, BK))
    return (int)cudaErrorInvalidValue;
  const uint32_t smem = Smem<HD>::BYTES;
  const cudaError_t attr = cudaFuncSetAttribute(   // the current card's opt-in
      attn_fwd_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(H, B, (Sq + BQB - 1) / BQB);
  attn_fwd_tc<HD><<<grid, THREADS, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), Sq, Sk, H, KV, causal,
      window, q_offset, prefix_len, 1.4426950408889634f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  hd 64,
// 80, 128 or 256; prefix_len >= 0 (0: none).  Returns a cudaError_t (0 =
// launched).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int Sq,
                                     int Sk, int H, int KV, int hd, int causal,
                                     int window, int q_offset, int prefix_len,
                                     int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 || prefix_len < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64)
    return cuda_core::launch<64>(q, k, v, out, B, Sq, Sk, H, KV, causal, window,
                                 q_offset, prefix_len, s);
  if (dtype == 0 && hd == 80)
    return cuda_core::launch<80>(q, k, v, out, B, Sq, Sk, H, KV, causal, window,
                                 q_offset, prefix_len, s);
  if (dtype == 0 && hd == 128)
    return cuda_core::launch<128>(q, k, v, out, B, Sq, Sk, H, KV, causal, window,
                                  q_offset, prefix_len, s);
  if (dtype == 0 && hd == 256)
    return cuda_core::launch<256>(q, k, v, out, B, Sq, Sk, H, KV, causal, window,
                                  q_offset, prefix_len, s);
  if (dtype == 1 && hd == 64)
    return tc::launch<64>(q, k, v, out, B, Sq, Sk, H, KV, causal, window,
                          q_offset, prefix_len, s);
  if (dtype == 1 && hd == 80)
    return tc::launch<80>(q, k, v, out, B, Sq, Sk, H, KV, causal, window,
                          q_offset, prefix_len, s);
  if (dtype == 1 && hd == 128)
    return tc::launch<128>(q, k, v, out, B, Sq, Sk, H, KV, causal, window,
                           q_offset, prefix_len, s);
  if (dtype == 1 && hd == 256)
    return tc::launch<256>(q, k, v, out, B, Sq, Sk, H, KV, causal, window,
                           q_offset, prefix_len, s);
  return (int)cudaErrorInvalidValue;
}
