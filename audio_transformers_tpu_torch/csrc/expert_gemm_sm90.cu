// K6: the grouped SwiGLU expert GEMM of a mixture of experts, in bfloat16
// on Hopper's tensor cores (sm_90a), accumulating in float32.
//
// Replaces no TPU kernel: the JAX package has no mixture of experts. It
// was added for Uni-MoE-2.0-Omni's dynamic-capacity MoE FFN
// (models/unimoe/model.py), whose routed experts take 91% of a layer's
// bytes. Two launches a call:
//   k6_gate_up_sm90: h[r] = silu(x[r] Wg[e]^T) * (x[r] Wu[e]^T)
//   k6_down_sm90:    y[r] = h[r] Wd[e]^T
// for every row r of expert e's run [off[e], off[e + 1]) of rows sorted
// by expert. The E + 1 offsets are read from device memory by each
// block, so routing never syncs the host; rows at or past off[E] (slots
// routed to the null expert or not kept) take no work and are not
// written.
//
// Layout: x (M, D) and y (M, D), h (M, F) row-major bf16; Wg, Wu (E, F,
// D) and Wd (E, D, F) bf16, each expert's matrix (out, in) row-major as
// a linear layer stores it, so both operands of every product are
// K-major. D and F are multiples of 128.
//
// Bound on the H100: at prefill (thousands of rows an expert) the tensor
// cores, 6 M D F flops a call against the weights read once; at decode
// (tens of rows an expert) device memory, the E expert weights of 3 D F
// bf16 each read once a call.
//
// Design: one block per (128-row tile of one expert, column tile), two
// warpgroups of 64 rows each. A block finds its expert and rows by
// walking the offsets (the grid holds ceil(M / 128) + E row-tile slots;
// the slots no expert needs return at once). The contraction runs in
// chunks of 64 columns through a ring of kStages shared tiles filled by
// 16-byte cp.async copies (rows past the expert's end zero-filled); each
// chunk is four k16 steps of wgmma m64n64k16 per 64 output columns, A
// and B from shared memory in the no-swizzle core-matrix order of
// flash_attention_sm90.cu. Blocks are ordered in groups of kGroupM
// row-tile slots per column tile, so that the blocks resident at once
// share their A and B tiles in L2. gate/up keeps both 64 x 128
// accumulators and writes silu(g) * u rounded to bf16; down writes y
// rounded to bf16. Every output tile belongs to one block: no atomics,
// and two launches give equal bits.

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kStages = 4;
constexpr int kThreads = 256;  // two warpgroups
constexpr int kBM = 128;       // rows per block
constexpr int kBK = 64;        // contraction columns per chunk
constexpr int kGroupM = 8;     // row-tile slots per group of the order

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
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

template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

// d (64 x 64) = A (64 x 16, K-major) . B (64 x 16, K-major)^T, plus d
// when `acc` is 1. Thread t of the warpgroup holds value i at row
// 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2) and column
// 8 * (i / 4) + 2 * (t % 4) + i % 2.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a,
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

// A no-swizzle descriptor: start address, the byte offset between core
// matrices along the contraction and along M (or N), in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(const bf16* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// A tile of R rows x kBK columns in core-matrix order: 16-byte chunk i
// holds columns 8 * ((i / 8) % 8) of row 8 * (i / 64) + i % 8. As a
// K-major operand its k16 step kk starts 2 core matrices (256 bytes) on;
// core matrices lie 128 bytes apart along K and 1024 along the rows.
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int kk) {
  return make_desc(tile + kk * 128, 128, kBK * 16);
}

// Rows [r0, r0 + R) (those below r_end; the rest zero) and columns
// [k0, k0 + kBK) of a row-major matrix with row stride ld into a tile.
template <int R>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          size_t ld, int r0, int r_end,
                                          int k0) {
  constexpr int CH = kBK / 8;
#pragma unroll
  for (int i = threadIdx.x; i < R * CH; i += kThreads) {
    const int r = r0 + (i / (8 * CH)) * 8 + (i & 7);
    const int c = k0 + ((i >> 3) % CH) * 8;
    const bool in = r < r_end;
    cp_async16(dst + i * 8, in ? src + (size_t)r * ld + c : src,
               in ? 16 : 0);
  }
}

// The block's (expert, first row, end of the expert's rows, column tile)
// from its index: row-tile slots in groups of kGroupM per column tile.
// False for a slot no expert needs.
__device__ __forceinline__ bool find_tile(const int* __restrict__ off,
                                          int n_exp, int m_slots,
                                          int n_tiles, int& e, int& r0,
                                          int& r_end, int& nt) {
  const int pid = blockIdx.x;
  const int in_group = kGroupM * n_tiles;
  const int first = (pid / in_group) * kGroupM;
  const int size = min(m_slots - first, kGroupM);
  int slot = first + (pid % in_group) % size;
  nt = (pid % in_group) / size;
  for (e = 0; e < n_exp; ++e) {
    const int s = off[e], n = off[e + 1] - s;
    const int tiles = (n + kBM - 1) / kBM;
    if (slot < tiles) {
      r0 = s + slot * kBM;
      r_end = off[e + 1];
      return true;
    }
    slot -= tiles;
  }
  return false;
}

__device__ __forceinline__ float silu(float g) { return g / (1.f + __expf(-g)); }

// Stores a warpgroup's 64 x 64 accumulator half `h` (columns c0 + 64 h)
// as bf16 at rows [r0, r0 + 64) below r_end of a row-major matrix.
__device__ __forceinline__ void store_half(bf16* dst, size_t ld,
                                           const float (&v)[32], int r0,
                                           int r_end, int c0) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x & 127) >> 5;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = r0 + 16 * w + (lane >> 2) + 8 * ((i >> 1) & 1);
    const int c = c0 + 8 * (i >> 2) + 2 * (lane & 3);
    if (r < r_end)
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r * ld + c) =
          __floats2bfloat162_rn(v[i], v[i + 1]);
  }
}

// ---------------------------------------------------------------------------
// gate/up: 128 rows x 128 intermediate columns a block, contraction D
// ---------------------------------------------------------------------------

constexpr int kUpBN = 128;
constexpr size_t kUpSmem =
    sizeof(bf16) * kStages * (kBM + 2 * kUpBN) * kBK;  // 192 KB

__global__ void __launch_bounds__(kThreads)
    k6_gate_up_sm90(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                    const bf16* __restrict__ wu, const int* __restrict__ off,
                    bf16* __restrict__ h, int m_slots, int d, int f,
                    int n_exp) {
  int e, r0, r_end, nt;
  if (!find_tile(off, n_exp, m_slots, f / kUpBN, e, r0, r_end, nt)) return;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* as = reinterpret_cast<bf16*>(smem);      // [kStages][kBM][kBK]
  bf16* gs = as + kStages * kBM * kBK;           // [kStages][kUpBN][kBK]
  bf16* us = gs + kStages * kUpBN * kBK;         // [kStages][kUpBN][kBK]
  const int n0 = nt * kUpBN;
  const bf16* wge = wg + (size_t)e * f * d;
  const bf16* wue = wu + (size_t)e * f * d;
  const int n_chunks = d / kBK;
  auto load_stage = [&](int t) {
    const int s = t % kStages, k0 = t * kBK;
    load_tile<kBM>(as + s * kBM * kBK, x, d, r0, r_end, k0);
    load_tile<kUpBN>(gs + s * kUpBN * kBK, wge, d, n0, f, k0);
    load_tile<kUpBN>(us + s * kUpBN * kBK, wue, d, n0, f, k0);
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_chunks) load_stage(t);
    cp_async_commit();
  }
  const int wg_i = threadIdx.x >> 7;
  const int rw0 = r0 + 64 * wg_i;  // this warpgroup's rows
  float g[2][32], u[2][32];
  for (int t = 0; t < n_chunks; ++t) {
    cp_async_wait<kStages - 2>();
    fence_async_shared();
    __syncthreads();  // chunk t is in; every warp is done with chunk t - 1
    if (t + kStages - 1 < n_chunks) load_stage(t + kStages - 1);
    cp_async_commit();
    const int s = t % kStages;
    const bf16* at = as + s * kBM * kBK + wg_i * 64 * kBK;
    const bf16* gt = gs + s * kUpBN * kBK;
    const bf16* ut = us + s * kUpBN * kBK;
    if (rw0 >= r_end) continue;  // uniform over the warpgroup
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const int acc = t > 0 || kk > 0;
      const uint64_t a = desc_k(at, kk);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        wgmma_n64(g[hh], a, desc_k(gt + hh * 64 * kBK, kk), acc);
        wgmma_n64(u[hh], a, desc_k(ut + hh * 64 * kBK, kk), acc);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      fence_regs(g[hh]);
      fence_regs(u[hh]);
    }
  }
  cp_async_wait<0>();
  if (rw0 >= r_end) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
    for (int i = 0; i < 32; ++i) g[hh][i] = silu(g[hh][i]) * u[hh][i];
    store_half(h, f, g[hh], rw0, r_end, n0 + 64 * hh);
  }
}

// ---------------------------------------------------------------------------
// down: 128 rows x BN output columns a block, contraction F
// ---------------------------------------------------------------------------

template <int BN>
struct Down {
  static constexpr size_t smem = sizeof(bf16) * kStages * (kBM + BN) * kBK;
};

template <int BN>
__global__ void __launch_bounds__(kThreads)
    k6_down_sm90(const bf16* __restrict__ h, const bf16* __restrict__ wd,
                 const int* __restrict__ off, bf16* __restrict__ y,
                 int m_slots, int d, int f, int n_exp) {
  constexpr int NH = BN / 64;
  int e, r0, r_end, nt;
  if (!find_tile(off, n_exp, m_slots, d / BN, e, r0, r_end, nt)) return;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* as = reinterpret_cast<bf16*>(smem);  // [kStages][kBM][kBK]
  bf16* bs = as + kStages * kBM * kBK;       // [kStages][BN][kBK]
  const int n0 = nt * BN;
  const bf16* wde = wd + (size_t)e * d * f;
  const int n_chunks = f / kBK;
  auto load_stage = [&](int t) {
    const int s = t % kStages, k0 = t * kBK;
    load_tile<kBM>(as + s * kBM * kBK, h, f, r0, r_end, k0);
    load_tile<BN>(bs + s * BN * kBK, wde, f, n0, d, k0);
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_chunks) load_stage(t);
    cp_async_commit();
  }
  const int wg_i = threadIdx.x >> 7;
  const int rw0 = r0 + 64 * wg_i;
  float o[NH][32];
  for (int t = 0; t < n_chunks; ++t) {
    cp_async_wait<kStages - 2>();
    fence_async_shared();
    __syncthreads();
    if (t + kStages - 1 < n_chunks) load_stage(t + kStages - 1);
    cp_async_commit();
    const int s = t % kStages;
    const bf16* at = as + s * kBM * kBK + wg_i * 64 * kBK;
    const bf16* bt = bs + s * BN * kBK;
    if (rw0 >= r_end) continue;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const int acc = t > 0 || kk > 0;
      const uint64_t a = desc_k(at, kk);
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
        wgmma_n64(o[hh], a, desc_k(bt + hh * 64 * kBK, kk), acc);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) fence_regs(o[hh]);
  }
  cp_async_wait<0>();
  if (rw0 >= r_end) return;
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) store_half(y, d, o[hh], rw0, r_end, n0 + 64 * hh);
}

template <typename K>
int prepare(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The grid: row-tile slots (every expert's partial tile included) times
// column tiles.
int grid_blocks(int m, int n_exp, int n_tiles, int& m_slots) {
  m_slots = (m + kBM - 1) / kBM + n_exp;
  return m_slots * n_tiles;
}

bool shapes_ok(int m, int d, int f, int n_exp) {
  return m > 0 && n_exp > 0 && d > 0 && f > 0 && d % 128 == 0 &&
         f % 128 == 0;
}

}  // namespace

// h (m, f) = silu(x Wg^T) * (x Wu^T) over each expert's rows; returns
// cudaGetLastError() after the launch.
extern "C" int expert_gate_up(const void* x, const void* wg, const void* wu,
                              const void* off, void* h, int m, int d, int f,
                              int n_exp, void* stream) {
  if (!shapes_ok(m, d, f, n_exp)) return (int)cudaErrorInvalidValue;
  static const int attr = prepare(k6_gate_up_sm90, kUpSmem);  // once
  if (attr != 0) return attr;
  int m_slots;
  const int blocks = grid_blocks(m, n_exp, f / kUpBN, m_slots);
  k6_gate_up_sm90<<<blocks, kThreads, kUpSmem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)wg, (const bf16*)wu, (const int*)off,
      (bf16*)h, m_slots, d, f, n_exp);
  return (int)cudaGetLastError();
}

// y (m, d) = h Wd^T over each expert's rows, in output tiles of `bn`
// (64 or 128) columns; returns cudaGetLastError() after the launch.
extern "C" int expert_down(const void* h, const void* wd, const void* off,
                           void* y, int m, int d, int f, int n_exp, int bn,
                           void* stream) {
  if (!shapes_ok(m, d, f, n_exp) || (bn != 64 && bn != 128))
    return (int)cudaErrorInvalidValue;
  int m_slots;
  if (bn == 64) {
    static const int attr = prepare(k6_down_sm90<64>, Down<64>::smem);
    if (attr != 0) return attr;
    const int blocks = grid_blocks(m, n_exp, d / 64, m_slots);
    k6_down_sm90<64><<<blocks, kThreads, Down<64>::smem,
                       (cudaStream_t)stream>>>(
        (const bf16*)h, (const bf16*)wd, (const int*)off, (bf16*)y, m_slots,
        d, f, n_exp);
  } else {
    static const int attr = prepare(k6_down_sm90<128>, Down<128>::smem);
    if (attr != 0) return attr;
    const int blocks = grid_blocks(m, n_exp, d / 128, m_slots);
    k6_down_sm90<128><<<blocks, kThreads, Down<128>::smem,
                        (cudaStream_t)stream>>>(
        (const bf16*)h, (const bf16*)wd, (const int*)off, (bf16*)y, m_slots,
        d, f, n_exp);
  }
  return (int)cudaGetLastError();
}
