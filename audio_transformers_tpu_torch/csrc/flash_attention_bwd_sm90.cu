// K4b/K4c for bfloat16 on Hopper's tensor cores (sm_90a): the backward of
// flash attention, with every product a warpgroup `wgmma` on bf16 tiles
// in shared memory, accumulating in float32.
//
// Replaces the TPU kernels of audio_transformers_tpu/ops/attention.py:
//   flash_attention_bwd_dq   <- _bwd_dq_kernel  (attention.py:147)
//   flash_attention_bwd_dkv  <- _bwd_dkv_kernel (attention.py:187)
// for bfloat16 operands, the training path's dtype. float32 keeps the FMA
// kernels of flash_attention.cu, its parity route; ops/attention.py picks
// the source by dtype. The C signatures are those of flash_attention.cu.
//
// Layout: q and dO (BH, Tq, d), k and v (BH, Tk, d), row-major bf16; lse
// and delta (BH, Tq) float32; the softmax scale is already folded into q.
//
// Shared tiles. A tile of R rows and DP (padded head dim) columns is kept
// in wgmma's no-swizzle "core matrix" order: 16-byte chunk i holds the 8
// columns 8 * ((i / 8) % (DP / 8)) of row 8 * (i / DP) + i % 8, so each
// 8 x 8 block is 128 contiguous bytes, row groups lie DP * 16 bytes apart
// and column groups 128 bytes apart. The same bytes then serve as a
// K-major operand (rows are M or N, the head dim is the contraction) and,
// with the descriptor's two strides swapped, as an MN-major B operand
// (the rows are the contraction): no transposed copy is made. Chunks are
// filled with 16-byte cp.async copies (zero-filled past the sequence's
// end, so the ragged edge needs no padded input), through a ring of
// kStages tiles so that the next tile loads while this one computes.
//
// Numbers: a bf16 x bf16 product is exact in float32, and p and ds are
// rounded to bf16 exactly where the reference rounds them (p before dV,
// ds before dQ and dK), so only the order of the float32 sums differs.
// Every output tile belongs to one block: no atomics, and two launches
// give equal bits.

#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kStages = 3;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, of which the first `bytes` are read and the
// rest zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's shared-memory writes visible to the async proxy
// (wgmma reads its operands through it).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// After a wait: the registers a wgmma wrote or read stay where they are
// until here (the compiler does not know the product was asynchronous).
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <int M, int N>
__device__ __forceinline__ void fence_regs(float (&x)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) fence_regs(x[i]);
}
template <int M>
__device__ __forceinline__ void fence_regs(uint32_t (&x)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(x[i][j])::"memory");
}

// ---------------------------------------------------------------------------
// wgmma, bf16 in, f32 accumulate, 64 rows per warpgroup. In a 64 x N
// accumulator, thread t of the warpgroup holds value i at row
// 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2) and column
// 8 * (i / 4) + 2 * (t % 4) + i % 2.
// ---------------------------------------------------------------------------

// d (64 x 32) = A (64 x 16, K-major) . B (32 x 16, K-major)^T, plus d
// when `acc` is 1 (0 ignores d's old value)
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 64) = A (64 x 16, K-major) . B (64 x 16, K-major)^T, plus d
// when `acc` is 1
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 32) += A (64 x 16, registers) . B (16 x 32, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64) += A (64 x 16, registers) . B (16 x 64, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a,
                                       uint64_t b, int acc);
template <>
__device__ __forceinline__ void mma_ss<32>(float (&d)[16], uint64_t a,
                                           uint64_t b, int acc) {
  wgmma_ss_n32(d, a, b, acc);
}
template <>
__device__ __forceinline__ void mma_ss<64>(float (&d)[32], uint64_t a,
                                           uint64_t b, int acc) {
  wgmma_ss_n64(d, a, b, acc);
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void mma_rs<32>(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  wgmma_rs_n32(d, a, b);
}
template <>
__device__ __forceinline__ void mma_rs<64>(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  wgmma_rs_n64(d, a, b);
}

// ---------------------------------------------------------------------------
// shared tiles and their descriptors
// ---------------------------------------------------------------------------

// A no-swizzle wgmma descriptor: start address, leading-dimension byte
// offset (the stride between core matrices along the contraction), and
// stride byte offset (along M or N), each in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(const bf16* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// The tile as a K-major operand: its rows are M (or N), contraction over
// the head-dim columns [16 kk, 16 kk + 16).
template <int DP>
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int kk) {
  return make_desc(tile + kk * 128, 128, DP * 16);
}

// The tile as an MN-major B operand: contraction over its rows
// [16 kk, 16 kk + 16), N over the head-dim columns [n0, n0 + N).
template <int DP>
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int kk,
                                            int n0) {
  return make_desc(tile + kk * 16 * DP + n0 * 8, DP * 16, 128);
}

// Rows [r0, r0 + R) of a row-major (n, d) matrix into a shared R x DP
// tile in core-matrix order. vec: d % 8 == 0 and the matrix 16-byte
// aligned, so each chunk is one cp.async (zero-filled outside the n rows);
// otherwise element loads with plain shared stores.
template <int R, int DP, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int n, int d, bool vec) {
  constexpr int CH = DP / 8;
  static_assert((R * CH) % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int i = threadIdx.x; i < R * CH; i += NT) {
    const int r = r0 + (i / (8 * CH)) * 8 + (i & 7);
    const int c = ((i >> 3) % CH) * 8;
    if (vec) {
      const bool in = r < n && c < d;
      cp_async16(dst + i * 8, in ? src + (size_t)r * d + c : src,
                 in ? 16 : 0);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c0 = c + 2 * e;
        const bool in = r < n;
        const bf16 zero = __float2bfloat16_rn(0.f);
        __nv_bfloat162 pair;
        pair.x = in && c0 < d ? src[(size_t)r * d + c0] : zero;
        pair.y = in && c0 + 1 < d ? src[(size_t)r * d + c0 + 1] : zero;
        w[e] = *reinterpret_cast<uint32_t*>(&pair);
      }
      *reinterpret_cast<uint4*>(dst + i * 8) = make_uint4(w[0], w[1], w[2],
                                                          w[3]);
    }
  }
}

// n floats at src[r0..] into dst[0..n), zero past `limit`.
template <int N, int NT>
__device__ __forceinline__ void load_row(float* dst, const float* src,
                                         int r0, int limit) {
  for (int i = threadIdx.x; i < N; i += NT) {
    const bool in = r0 + i < limit;
    cp_async4(dst + i, in ? src + r0 + i : src, in ? 4 : 0);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 64 x N float accumulator rounded to bf16 A-operand fragments of N / 16
// contraction steps (the accumulator's columns become the contraction).
template <int N>
__device__ __forceinline__ void to_frags(uint32_t (&f)[N / 16][4],
                                         const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[kk][j] = pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
}

// A 64 x DP output accumulator, as NH column halves of NW columns (one
// wgmma covers at most 64 columns here).
template <int DP>
struct Out {
  static constexpr int NH = DP > 64 ? 2 : 1;
  static constexpr int NW = DP > 64 ? 64 : DP;
  using Acc = float[NH][NW / 2];
};

// d (64 x N) = A (64 rows, K-major) . B (N rows, K-major)^T over DP. The
// first step overwrites d, so d needs no zeroing (a zeroing the compiler
// could move between the fence and the product, where ptxas would then
// serialise the products).
template <int N, int DP>
__device__ __forceinline__ void gemm_ss(float (&d)[N / 2], const bf16* a,
                                        const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    mma_ss<N>(d, desc_k<DP>(a, kk), desc_k<DP>(b, kk), kk > 0);
}

// d (64 x DP) += A (64 x K, fragments) . B (a K x DP tile, MN-major).
template <int K, int DP>
__device__ __forceinline__ void gemm_rs(typename Out<DP>::Acc& d,
                                        const uint32_t (&a)[K / 16][4],
                                        const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int h = 0; h < Out<DP>::NH; ++h)
      mma_rs<Out<DP>::NW>(d[h], a[kk], desc_mn<DP>(b, kk, h * 64));
}

// Rows [r0, r0 + 64) of a warpgroup's 64 x DP accumulator, as bf16, into
// a row-major (n, d) matrix; rows >= n and columns >= d are not written.
template <int DP>
__device__ __forceinline__ void store_out(bf16* dst,
                                          const typename Out<DP>::Acc& acc,
                                          int r0, int n, int d, bool vec) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x & 127) >> 5;
#pragma unroll
  for (int h = 0; h < Out<DP>::NH; ++h)
#pragma unroll
    for (int i = 0; i < Out<DP>::NW / 2; i += 2) {
      const int r = r0 + 16 * w + (lane >> 2) + 8 * ((i >> 1) & 1);
      const int c = 64 * h + 8 * (i >> 2) + 2 * (lane & 3);
      if (r >= n) continue;
      bf16* p = dst + (size_t)r * d + c;
      if (vec && c + 1 < d) {
        *reinterpret_cast<__nv_bfloat162*>(p) =
            __floats2bfloat162_rn(acc[h][i], acc[h][i + 1]);
      } else {
        if (c < d) p[0] = __float2bfloat16_rn(acc[h][i]);
        if (c + 1 < d) p[1] = __float2bfloat16_rn(acc[h][i + 1]);
      }
    }
}

template <int DP>
__device__ __forceinline__ void zero_acc(typename Out<DP>::Acc& acc) {
#pragma unroll
  for (int h = 0; h < Out<DP>::NH; ++h)
#pragma unroll
    for (int i = 0; i < Out<DP>::NW / 2; ++i) acc[h][i] = 0.f;
}

// Both kernels run two warpgroups (of 64 rows each) per block, so that
// each streamed tile feeds two warpgroups' products. On the H100 both ran
// faster so than with one warpgroup per block.
constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// K4c: dk and dv. Replaces _bwd_dkv_kernel (attention.py:187).
//
// Bound on the H100: the tensor cores. Four products of 2 * Tq * Tk * d
// flops each (S^T, dP^T, dV, dK): 110.6 GFLOP at the whisper-tiny encoder
// shape (BH = 96, T = 1500, d = 64), 0.112 ms at 989 TFLOP/s, against
// about 1.2 MB of q, k, v, dO per head.
//
// Design: one block per (128-key tile, bh), two warpgroups of 64 key rows.
// K and V are loaded into shared memory once; the block loops over 64-row
// query tiles of q and dO (32 rows for DP = 128, to keep the registers)
// with their lse and delta, three tiles in flight. Per tile
// each warpgroup computes S^T = K Q^T and dP^T = V dO^T by wgmma from
// shared memory, then in registers P^T = exp(S^T - lse) and
// dS^T = P^T (dP^T - delta) (masked only on edge and diagonal tiles),
// rounds both to bf16 as A fragments, and accumulates dV += P^T dO and
// dK += dS^T Q with A taken from registers and B the very tiles of dO and
// q, read MN-major. dK and dV stay in registers until the one store at
// the end. Under causality the query tiles wholly before the key tile are
// skipped.
// ---------------------------------------------------------------------------

template <int DP>
struct Dkv {
  static constexpr int BQ = DP > 64 ? 32 : 64;  // query rows per stage
  static constexpr int BK = 128;                // key rows per block
  static constexpr int NT = kThreads;
  static constexpr size_t smem =
      sizeof(bf16) * (2 * BK * DP + kStages * 2 * BQ * DP) +
      sizeof(float) * kStages * 2 * BQ;
};

template <int DP>
__global__ void __launch_bounds__(kThreads)
    dkv_sm90(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dk, bf16* __restrict__ dv, int t_q, int t_k,
             int d, int causal, int vec) {
  using C = Dkv<DP>;
  constexpr int BQ = C::BQ;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // [BK][DP]
  bf16* vs = ks + C::BK * DP;                // [BK][DP]
  bf16* qs = vs + C::BK * DP;                // [kStages][BQ][DP]
  bf16* os = qs + kStages * BQ * DP;         // [kStages][BQ][DP]: dO
  float* ls = reinterpret_cast<float*>(os + kStages * BQ * DP);  // lse
  float* dl = ls + kStages * BQ;                                 // delta
  const int wg = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * C::BK;
  const size_t bh = blockIdx.y;
  q += bh * t_q * d;
  dout += bh * t_q * d;
  k += bh * t_k * d;
  v += bh * t_k * d;
  lse += bh * t_q;
  delta += bh * t_q;

  load_tile<C::BK, DP, C::NT>(ks, k, k0, t_k, d, vec);
  load_tile<C::BK, DP, C::NT>(vs, v, k0, t_k, d, vec);
  // under causality, query rows before this key tile see none of it
  const int q_begin = causal ? k0 : 0;
  const int n_tiles = q_begin < t_q ? (t_q - q_begin + BQ - 1) / BQ : 0;
  auto load_stage = [&](int t) {
    const int s = t % kStages, q0 = q_begin + t * BQ;
    load_tile<BQ, DP, C::NT>(qs + s * BQ * DP, q, q0, t_q, d, vec);
    load_tile<BQ, DP, C::NT>(os + s * BQ * DP, dout, q0, t_q, d, vec);
    load_row<BQ, C::NT>(ls + s * BQ, lse, q0, t_q);
    load_row<BQ, C::NT>(dl + s * BQ, delta, q0, t_q);
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_stage(t);
    cp_async_commit();
  }

  typename Out<DP>::Acc dk_acc, dv_acc;
  zero_acc<DP>(dk_acc);
  zero_acc<DP>(dv_acc);
  const int kw0 = k0 + wg * 64;        // this warpgroup's 64 key rows
  const bf16* kw = ks + wg * 64 * DP;
  const bf16* vw = vs + wg * 64 * DP;
  const int key = kw0 + 16 * w + (lane >> 2);  // + 8 for odd pairs
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    fence_async_shared();
    __syncthreads();  // tile t is in; every warp is done with tile t - 1
    if (t + kStages - 1 < n_tiles) load_stage(t + kStages - 1);
    cp_async_commit();
    const int s = t % kStages, q0 = q_begin + t * BQ;
    const bf16* qt = qs + s * BQ * DP;
    const bf16* ot = os + s * BQ * DP;
    const float* lt = ls + s * BQ;
    const float* dt = dl + s * BQ;

    float st[BQ / 2], pt[BQ / 2];  // S^T, then P^T; dP^T, then dS^T
    wgmma_fence();
    gemm_ss<BQ, DP>(st, kw, qt);
    gemm_ss<BQ, DP>(pt, vw, ot);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(pt);
    // every (key, query) pair of the tile counts: no mask to evaluate
    const bool inner = kw0 + 64 <= t_k && q0 + BQ <= t_q &&
                       !(causal && kw0 + 63 > q0);
    auto grads = [&](auto masked) {
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) {
        const int col = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        bool ok = true;
        if constexpr (decltype(masked)::value) {
          const int kpos = key + 8 * ((i >> 1) & 1), qpos = q0 + col;
          ok = kpos < t_k && qpos < t_q && !(causal && kpos > qpos);
        }
        const float p = ok ? exp2f((st[i] - lt[col]) * kLog2e) : 0.f;
        pt[i] = p * (pt[i] - dt[col]);
        st[i] = p;
      }
    };
    if (inner)
      grads(std::false_type{});
    else
      grads(std::true_type{});
    uint32_t pf[BQ / 16][4], sf[BQ / 16][4];
    to_frags<BQ>(pf, st);
    to_frags<BQ>(sf, pt);
    wgmma_fence();
    gemm_rs<BQ, DP>(dv_acc, pf, ot);
    gemm_rs<BQ, DP>(dk_acc, sf, qt);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(pf);
    fence_regs(sf);
  }
  cp_async_wait<0>();
  store_out<DP>(dk + bh * t_k * d, dk_acc, kw0, t_k, d, vec);
  store_out<DP>(dv + bh * t_k * d, dv_acc, kw0, t_k, d, vec);
}

// ---------------------------------------------------------------------------
// K4b: dq. Replaces _bwd_dq_kernel (attention.py:147).
//
// Bound on the H100: the tensor cores. Three products (S, dP, dQ) of
// 2 * Tq * Tk * d flops: 82.9 GFLOP at the encoder shape, 0.084 ms at 989
// TFLOP/s.
//
// Design: one block per (128-query tile, bh), two warpgroups of 64 query
// rows. q and dO stay in shared memory; the block loops over 64-row
// key tiles of K and V, three in flight: S = Q K^T and dP = dO V^T by
// wgmma from shared memory, then in registers P = exp(S - lse) and
// dS = P (dP - delta) (masked only on edge and diagonal tiles), rounded to
// bf16 as A fragments, and dQ += dS K with B the K tile read MN-major.
// Under causality the key tiles wholly after the query tile are skipped.
// ---------------------------------------------------------------------------

template <int DP>
struct Dq {
  static constexpr int BQ = 128;  // query rows per block
  static constexpr int BK = 64;   // key rows per stage
  static constexpr int NT = kThreads;
  static constexpr size_t smem =
      sizeof(bf16) * (2 * BQ * DP + kStages * 2 * BK * DP);
};

template <int DP>
__global__ void __launch_bounds__(kThreads)
    dq_sm90(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dq, int t_q, int t_k, int d, int causal,
            int vec) {
  using C = Dq<DP>;
  constexpr int BK = C::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [BQ][DP]
  bf16* os = qs + C::BQ * DP;                // [BQ][DP]: dO
  bf16* kst = os + C::BQ * DP;               // [kStages][BK][DP]
  bf16* vst = kst + kStages * BK * DP;       // [kStages][BK][DP]
  const int wg = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * C::BQ;
  const size_t bh = blockIdx.y;
  q += bh * t_q * d;
  dout += bh * t_q * d;
  k += bh * t_k * d;
  v += bh * t_k * d;
  lse += bh * t_q;
  delta += bh * t_q;

  load_tile<C::BQ, DP, C::NT>(qs, q, q0, t_q, d, vec);
  load_tile<C::BQ, DP, C::NT>(os, dout, q0, t_q, d, vec);
  const int k_end = causal ? min(t_k, q0 + C::BQ) : t_k;
  const int n_tiles = (k_end + BK - 1) / BK;
  auto load_stage = [&](int t) {
    const int s = t % kStages;
    load_tile<BK, DP, C::NT>(kst + s * BK * DP, k, t * BK, t_k, d, vec);
    load_tile<BK, DP, C::NT>(vst + s * BK * DP, v, t * BK, t_k, d, vec);
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_stage(t);
    cp_async_commit();
  }

  const int qw0 = q0 + wg * 64;  // this warpgroup's 64 query rows
  const bf16* qw = qs + wg * 64 * DP;
  const bf16* ow = os + wg * 64 * DP;
  const int row = qw0 + 16 * w + (lane >> 2);  // and row + 8
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    lse_r[h] = r < t_q ? lse[r] : 0.f;
    delta_r[h] = r < t_q ? delta[r] : 0.f;
  }
  typename Out<DP>::Acc dq_acc;
  zero_acc<DP>(dq_acc);
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    fence_async_shared();
    __syncthreads();
    if (t + kStages - 1 < n_tiles) load_stage(t + kStages - 1);
    cp_async_commit();
    const int s = t % kStages, k0 = t * BK;
    const bf16* kt = kst + s * BK * DP;
    const bf16* vt = vst + s * BK * DP;

    float sc[BK / 2], dp[BK / 2];  // S, then P; dP, then dS
    wgmma_fence();
    gemm_ss<BK, DP>(sc, qw, kt);
    gemm_ss<BK, DP>(dp, ow, vt);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);
    const bool inner = qw0 + 64 <= t_q && k0 + BK <= t_k &&
                       !(causal && k0 + BK - 1 > qw0);
    auto grads = [&](auto masked) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int h = (i >> 1) & 1;
        bool ok = true;
        if constexpr (decltype(masked)::value) {
          const int qpos = row + 8 * h;
          const int kpos = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          ok = qpos < t_q && kpos < t_k && !(causal && kpos > qpos);
        }
        const float p = ok ? exp2f((sc[i] - lse_r[h]) * kLog2e) : 0.f;
        dp[i] = p * (dp[i] - delta_r[h]);
      }
    };
    if (inner)
      grads(std::false_type{});
    else
      grads(std::true_type{});
    uint32_t sf[BK / 16][4];
    to_frags<BK>(sf, dp);
    wgmma_fence();
    gemm_rs<BK, DP>(dq_acc, sf, kt);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq_acc);
    fence_regs(sf);
  }
  cp_async_wait<0>();
  store_out<DP>(dq + bh * t_q * d, dq_acc, qw0, t_q, d, vec);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
int prepare(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <int DP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int t_q,
              int t_k, int d, int causal, cudaStream_t stream) {
  using C = Dq<DP>;
  auto kernel = dq_sm90<DP>;
  if (int e = prepare(kernel, C::smem)) return e;
  const int vec = d % 8 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(dout) && aligned16(dq);
  const dim3 grid((t_q + C::BQ - 1) / C::BQ, bh);
  kernel<<<grid, C::NT, C::smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, t_q, t_k, d, causal,
      vec);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               int bh, int t_q, int t_k, int d, int causal,
               cudaStream_t stream) {
  using C = Dkv<DP>;
  auto kernel = dkv_sm90<DP>;
  if (int e = prepare(kernel, C::smem)) return e;
  const int vec = d % 8 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(dout) && aligned16(dk) &&
                  aligned16(dv);
  const dim3 grid((t_k + C::BK - 1) / C::BK, bh);
  kernel<<<grid, C::NT, C::smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, t_q, t_k,
      d, causal, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 only; the head dim d (<= 128) picks the padded width DP in
// {32, 64, 128}.
#define SM90_DISPATCH(FN, ...)                                     \
  do {                                                             \
    if (d < 1 || d > 128 || dtype != kBF16)                        \
      return (int)cudaErrorInvalidValue;                           \
    if (d <= 32) return FN<32>(__VA_ARGS__);                       \
    if (d <= 64) return FN<64>(__VA_ARGS__);                       \
    return FN<128>(__VA_ARGS__);                                   \
  } while (0)

// The signatures of flash_attention.cu's entry points; each returns
// cudaGetLastError() after its launch.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int bh, int t_q, int t_k,
                                      int d, int causal, int dtype,
                                      void* stream) {
  SM90_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, bh, t_q, t_k, d,
                causal, (cudaStream_t)stream);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int bh, int t_q,
                                       int t_k, int d, int causal, int dtype,
                                       void* stream) {
  SM90_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk, dv, bh, t_q, t_k,
                d, causal, (cudaStream_t)stream);
}
