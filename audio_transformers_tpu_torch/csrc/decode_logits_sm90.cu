// K2 for bfloat16 on Hopper (sm_90a): the fused greedy decode step, the
// tied-vocab projection on the tensor cores, in one launch.
//
// Replaces the TPU kernel `_kernel` of audio_transformers_tpu/ops/
// decode_logits.py (`fused_greedy_step`) for bfloat16 operands, the
// serving path's dtype; float32 keeps the FMA kernel of decode_logits.cu,
// its parity route, and ops/decode_logits.py picks the source by dtype.
// Semantics, per row b and padded vocab id v:
//   l = sum_d hidden[b, d] * table_t[d, v] + add[v]          (float32)
//   seen[b, v]: l = l > 0 ? l / penalty : l * penalty
//   ban[b, v]:  l = NEG_INF
//   ts mode:    l = NEG_INF where v < tlo[b] | tb <= v < thi[b] | v > tcap[b]
//   token = argmax_v l (lowest index on ties); in ts mode, if
//   logsumexp(l[tb:]) > max(l[:tb]) the token is tb + argmax(l[tb:]).
//
// Bound on the H100: device memory. A call must read the (D, V_pad) table
// once (40.1 MB at whisper-tiny) plus B * V_pad bytes of each mask; the
// projection is 2 * B * D FLOPs per vocab id, far below the tensor cores'
// rate up to B = 128. So the design is about keeping bytes in flight:
//
// - A persistent grid, one block per SM: block i of n owns the vocab units
//   [i * U / n, (i + 1) * U / n) of U = V_pad / 16 units of 16 ids, and
//   walks them in tiles of near-equal size, each warp owning up to UPW
//   units of a tile (4 for groups of up to 32 rows: at B <= 32 a block's
//   ~25 units are one tile, so the stream never stops for an epilogue).
// - The table streams through a ring of 4 stages in shared memory, each
//   stage 32 table rows (d) of a tile, one bulk copy (the copy engine,
//   TMA) per row. A ninth warp only produces: its lanes start a stage's
//   32 row copies, counted on the slot's "full" mbarrier, as soon as the
//   8 consumer warps have arrived on the slot's "empty" one. Up to ~100 KB
//   per SM are in flight, and no block-wide barrier stands between a
//   stage and the next.
// - Every table byte is read once per group of R = 8 * NT rows (R is the
//   smallest of 8 .. 128 that holds the batch and fits shared memory), and
//   a group's rows are all kept in registers, so at B <= 16 (every preset
//   D) and B <= 128 (D = 384) the table is read once per call.
// - The projection is mma.sync.m16n8k16 (bf16 in, float32 accumulate),
//   "swap AB": vocab is the M side (a unit's 16 ids, from the staged
//   vocab-contiguous rows by ldmatrix.trans) and the hidden rows the N
//   side (8 rows a product, from the group's rows in shared memory by
//   ldmatrix, loaded once per k-step for all of a warp's units). A bf16 x
//   bf16 product is exact in float32, so only the order of the float32
//   sums differs from the plain version.
// - Each tile's accumulators go to a float32 logits tile in shared memory;
//   a thread per (row, unit) applies the processors to 16 ids (the bias
//   and the masks fetched in 16-byte loads when the tile's stream starts,
//   so their latency hides behind it) and the lanes of a row fold the tile
//   into its running max and argmax (and, in ts mode, the timestamp max,
//   argmax and sum of exp relative to that max, and the text max).
// - The block writes its per-row partials; the last block of the row group
//   to finish (a counter per group, which it resets) merges them in a
//   fixed order, applies the force rule and writes the tokens, in the same
//   launch. Ties keep the lower index everywhere, and the merge order does
//   not depend on timing, so two launches give equal bits.
// - Vocab-shard mode (tensor parallelism): with `parts` set, the table and
//   the masks are a shard whose first column is id `voff`; every id the
//   kernel compares or reports is global (voff + column), and the merging
//   block writes each row's merged partials to `parts` instead of a token
//   (float32 (B, 2), or (B, 6) in ts mode: m, mi, mts, its, sts, mtx, the
//   ids as floats, INT_MAX for an empty region). The ranks merge the
//   shards' partials (ops/decode_logits.py `merge_partials`).

#include <float.h>
#include <limits.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnit = 16;                  // vocab ids per unit: one mma's M
constexpr int kStageRows = 32;             // table rows (d) per ring stage
constexpr int kStages = 4;                 // ring slots
// dynamic shared memory a block may use: the H100's 232448 bytes less 1 KB
// for the kernel's static shared memory
constexpr int kMaxSmem = 232448 - 1024;

// The shape of a block for row groups of 8 * NT rows: each warp owns UPW
// units of a tile (a tile is up to 8 * UPW units, 128 * UPW ids). Fewer
// rows leave registers and shared memory for wider tiles.
template <int NT>
struct Shape {
  static constexpr int UPW = NT <= 4 ? 4 : NT == 8 ? 2 : 1;
  static constexpr int TILE_U = kWarps * UPW;        // units per tile
  static constexpr int TILE = TILE_U * kUnit;        // ids per tile
  // a staged table row: the tile's ids in bf16 plus 16 bytes, so that the
  // 8 rows an ldmatrix reads fall in distinct banks
  static constexpr int PITCH = TILE * 2 + 16;
  static constexpr int SLOT = kStageRows * PITCH;
  static constexpr int LG_PITCH = TILE + 4;          // floats, logits tile
};

// D padded to the stage depth
__host__ __device__ inline int pad_dim(int dim) {
  return (dim + kStageRows - 1) / kStageRows * kStageRows;
}

// bytes per row of the group's hidden vectors in shared memory: D padded,
// plus 16 bytes (distinct banks for ldmatrix again)
__host__ __device__ inline int hs_pitch(int dim) {
  return 2 * pad_dim(dim) + 16;
}

// the ring, the group's hidden rows and the float32 logits tile
template <int NT>
size_t smem_bytes(int dim) {
  using S = Shape<NT>;
  return (size_t)kStages * S::SLOT + (size_t)8 * NT * hs_pitch(dim) +
         (size_t)8 * NT * S::LG_PITCH * sizeof(float);
}

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; with bytes == 0 the destination is zeroed and
// nothing is read
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

// Makes this thread's shared-memory writes visible to the async proxy
// (the bulk copies write through it).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// one arrival that also expects `bytes` more from bulk copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// a barrier of the kThreads consumer threads only (barrier 1; the producer
// warp goes its own way)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// waits until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) global -> shared
// by the copy engine, counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col). In d,
// lane t holds rows t / 4 (d[0], d[1]) and t / 4 + 8 (d[2], d[3]), columns
// 2 * (t % 4) and 2 * (t % 4) + 1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// merges
// ---------------------------------------------------------------------------

// (m, i) <- the larger of (m, i) and (m2, i2), the lower index on ties
__device__ __forceinline__ void arg_merge(float& m, int& i, float m2, int i2) {
  if (m2 > m || (m2 == m && i2 < i)) {
    m = m2;
    i = i2;
  }
}

// the same for a max that carries a sum of exp relative to it
__device__ __forceinline__ void lse_merge(float& m, int& i, float& s,
                                          float m2, int i2, float s2) {
  const float mn = fmaxf(m, m2);
  s = mn == -INFINITY ? 0.f : s * expf(m - mn) + s2 * expf(m2 - mn);
  arg_merge(m, i, m2, i2);
}

// byte e of a 16-byte mask chunk is not zero (e is a constant once unrolled)
__device__ __forceinline__ bool byte_set(const uint4& v, int e) {
  const uint32_t w = e < 4 ? v.x : e < 8 ? v.y : e < 12 ? v.z : v.w;
  return ((w >> (8 * (e & 3))) & 0xffu) != 0;
}

// any byte of a 16-byte mask chunk is not zero
__device__ __forceinline__ bool any_set(const uint4& v) {
  return (v.x | v.y | v.z | v.w) != 0;
}

// (m, i) <- the max of x[0..16) and its lowest index (offset by v0);
// entries with ok[e] false count as (-inf, INT_MAX). A tree, so the
// compares of a chunk do not form one chain.
__device__ __forceinline__ void tree_argmax(const float (&x)[16],
                                            const bool (&ok)[16], int v0,
                                            float& m, int& i) {
  float mv[16];
  int iv[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    mv[e] = ok[e] ? x[e] : -INFINITY;
    iv[e] = ok[e] ? v0 + e : INT_MAX;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) arg_merge(mv[e], iv[e], mv[e + 8], iv[e + 8]);
#pragma unroll
  for (int e = 0; e < 4; ++e) arg_merge(mv[e], iv[e], mv[e + 4], iv[e + 4]);
#pragma unroll
  for (int e = 0; e < 2; ++e) arg_merge(mv[e], iv[e], mv[e + 2], iv[e + 2]);
  arg_merge(mv[0], iv[0], mv[1], iv[1]);
  m = mv[0];
  i = iv[0];
}

// the partials of one row: max and argmax; in ts mode also the timestamp
// max, argmax and sum of exp relative to that max, and the text max
struct RowPart {
  float m = -INFINITY, mts = -INFINITY, sts = 0.f, mtx = -INFINITY;
  int mi = INT_MAX, its = INT_MAX;

  template <bool TS>
  __device__ __forceinline__ void merge(const RowPart& o) {
    arg_merge(m, mi, o.m, o.mi);
    if (TS) {
      lse_merge(mts, its, sts, o.mts, o.its, o.sts);
      mtx = fmaxf(mtx, o.mtx);
    }
  }

  // merged with lane ^ o for o = 1 .. width / 2
  template <bool TS, int WIDTH>
  __device__ __forceinline__ void merge_lanes() {
#pragma unroll
    for (int o = 1; o < WIDTH; o <<= 1) {
      RowPart p;
      p.m = __shfl_xor_sync(0xffffffffu, m, o);
      p.mi = __shfl_xor_sync(0xffffffffu, mi, o);
      if (TS) {
        p.mts = __shfl_xor_sync(0xffffffffu, mts, o);
        p.its = __shfl_xor_sync(0xffffffffu, its, o);
        p.sts = __shfl_xor_sync(0xffffffffu, sts, o);
        p.mtx = __shfl_xor_sync(0xffffffffu, mtx, o);
      }
      merge<TS>(p);
    }
  }
};

// ---------------------------------------------------------------------------
// the kernel: grid (blocks, row groups), kThreads threads, smem_bytes()
// ---------------------------------------------------------------------------

// partials: pf (4, B, blocks) = max, ts max, ts sum, text max;
//           pi (2, B, blocks) = argmax, ts argmax
template <int NT, bool TS>
__global__ void __launch_bounds__(kThreads + 32, 1)
greedy_step_sm90(const bf16* __restrict__ h, const bf16* __restrict__ table_t,
                 const float* __restrict__ add,
                 const int8_t* __restrict__ seen,
                 const int8_t* __restrict__ ban, float penalty,
                 const int* __restrict__ tlo, const int* __restrict__ thi,
                 const int* __restrict__ tcap, int tb, int batch, int dim,
                 int vocab, float* __restrict__ pf, int* __restrict__ pi,
                 int* __restrict__ count, int* __restrict__ out, int voff,
                 float* __restrict__ parts) {
  using S = Shape<NT>;
  constexpr int R = 8 * NT;                   // rows of a group
  constexpr int RPP = kThreads / S::TILE_U;   // rows of one epilogue pass
  constexpr int RPT = (R + RPP - 1) / RPP;    // rows a thread reduces
  extern __shared__ __align__(16) unsigned char smem[];
  // per ring slot: filled (the producer's bytes landed) and emptied (every
  // consumer warp is done with it)
  __shared__ uint64_t full[kStages], empty[kStages];
  __shared__ int is_last;
  const int dp = pad_dim(dim), hp = hs_pitch(dim);
  unsigned char* ring = smem;
  unsigned char* hs = smem + kStages * S::SLOT;
  float* lg = reinterpret_cast<float*>(hs + R * hp);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nb = gridDim.x, blk = blockIdx.x;
  const int n_units = vocab / kUnit;
  const int u0 = (int)((long long)blk * n_units / nb);
  const int units = (int)((long long)(blk + 1) * n_units / nb) - u0;
  // the block's units in n_tiles tiles of near-equal size (<= TILE_U)
  const int n_tiles = (units + S::TILE_U - 1) / S::TILE_U;
  const int row0 = blockIdx.y * R;
  const int rows = min(R, batch - row0);
  const int slices = dp / kStageRows;         // ring stages per tile
  const int total = n_tiles * slices;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // rows past D are never copied: where D is not a multiple of 32, zero
  // the ring once, so that those rows hold zeros or earlier (finite)
  // table rows, which meet the hidden rows' zeros past D
  if (dim % kStageRows != 0) {
    for (int i = tid; i < kStages * S::SLOT / 16; i += blockDim.x)
      reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
    fence_async_shared();
  }
  __syncthreads();

  RowPart run[RPT];
  // the epilogue's share of a consumer thread: 16 ids (unit q of a tile)
  // of rows rr, rr + RPP, ...
  const int q = tid % S::TILE_U, rr = tid / S::TILE_U;
  if (warp == kWarps) {
    // the producer: stage j holds rows [s * 32, s * 32 + 32) (those below
    // D) of the units [tu, tu + nu) of a tile, one bulk copy per row (lane
    // r copies row r), completing on the slot's full barrier, once the
    // consumers have emptied the slot's previous stage
    int s = 0, tile = 0, tu = u0, nu = units / n_tiles;
    for (int j = 0; j < total; ++j) {
      const int slot = j % kStages;
      if (j >= kStages) mbar_wait(&empty[slot], (j / kStages - 1) & 1);
      const int d0 = s * kStageRows, n_rows = min(kStageRows, dim - d0);
      const uint32_t bytes = nu * kUnit * 2;
      if (lane == 0) mbar_expect_tx(&full[slot], bytes * n_rows);
      __syncwarp();
      if (lane < n_rows)
        bulk_load(ring + slot * S::SLOT + lane * S::PITCH,
                  table_t + (size_t)(d0 + lane) * vocab + (size_t)tu * kUnit,
                  bytes, &full[slot]);
      if (++s == slices) {
        s = 0;
        ++tile;
        tu = u0 + tile * units / n_tiles;
        nu = u0 + (tile + 1) * units / n_tiles - tu;
      }
    }
  } else {
    // the group's hidden rows, zero past D and past the batch (D % 8 ==
    // 0), while the producer's first stages are on their way
    for (int c = tid; c < R * (dp / 8); c += kThreads) {
      const int r = c / (dp / 8), k8 = (c - r * (dp / 8)) * 8;
      const bool in = r < rows && k8 < dim;
      cp_async16(hs + r * hp + 2 * k8,
                 in ? h + (size_t)(row0 + r) * dim + k8 : h, in ? 16 : 0);
    }
    cp_async_commit();
    int lo[RPT], hi[RPT], cap[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rr + RPP * i;
      lo[i] = hi[i] = cap[i] = 0;
      if (TS && r < rows) {
        lo[i] = tlo[row0 + r];
        hi[i] = thi[row0 + r];
        cap[i] = tcap[row0 + r];
      }
    }
    float acc[S::UPW][NT][4];
    float4 av[4];
    uint4 sv[RPT], bv[RPT];
    cp_async_wait<0>();
    consumer_sync();
    int j = 0;
#pragma unroll 1
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int tu = u0 + tile * units / n_tiles;
      const int nu = u0 + (tile + 1) * units / n_tiles - tu;
#pragma unroll
      for (int u = 0; u < S::UPW; ++u)
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[u][t][e] = 0.f;
      // the tile's bias and masks, for its epilogue
      if (q < nu) {
        const size_t v0 = (size_t)(tu + q) * kUnit;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          av[e] = __ldg(reinterpret_cast<const float4*>(add + v0) + e);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = rr + RPP * i;
          const size_t at = (size_t)(row0 + r) * vocab + v0;
          sv[i] = bv[i] = make_uint4(0, 0, 0, 0);
          if (r < rows && seen != nullptr)
            sv[i] = __ldcs(reinterpret_cast<const uint4*>(seen + at));
          if (r < rows && ban != nullptr)
            bv[i] = __ldcs(reinterpret_cast<const uint4*>(ban + at));
        }
      }

#pragma unroll 1
      for (int s = 0; s < slices; ++s, ++j) {
        const int slot = j % kStages;
        mbar_wait(&full[slot], (j / kStages) & 1);
        if (warp < nu) {
          const unsigned char* sl = ring + slot * S::SLOT;
#pragma unroll
          for (int kk = 0; kk < kStageRows / 16; ++kk) {
            const int k0 = s * kStageRows + kk * 16 + ((lane >> 3) & 1) * 8;
            // A: row kk * 16 + (lane & 7) + 8 * (lane / 16) of the slot, at
            // the unit's 16 ids (8 more for lanes 8-15 and 24-31); B: the
            // group's rows, 8 columns further for those lanes
            const unsigned char* a_row =
                sl + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * S::PITCH +
                ((lane >> 3) & 1) * 16;
            const unsigned char* b_row =
                hs + ((lane & 7) + ((lane >> 4) << 3)) * hp + 2 * k0;
            if constexpr (S::UPW == 1) {
              // one unit a warp (the widest groups): each pair of B
              // fragments serves two products, so load them as they go
              uint32_t a[4];
              ldsm_x4_trans(a, a_row + warp * 32);
#pragma unroll
              for (int p = 0; p < NT / 2; ++p) {
                uint32_t b[4];
                ldsm_x4(b, b_row + p * 16 * hp);
                mma_bf16(acc[0][2 * p], a, b[0], b[1]);
                mma_bf16(acc[0][2 * p + 1], a, b[2], b[3]);
              }
            } else {
              // B fragments of the k-step, shared by the warp's units
              uint32_t bf[NT][2];
              if constexpr (NT == 1) {
                ldsm_x2(bf[0], b_row);
              } else {
#pragma unroll
                for (int p = 0; p < NT / 2; ++p) {
                  uint32_t b[4];
                  ldsm_x4(b, b_row + p * 16 * hp);
                  bf[2 * p][0] = b[0];
                  bf[2 * p][1] = b[1];
                  bf[2 * p + 1][0] = b[2];
                  bf[2 * p + 1][1] = b[3];
                }
              }
#pragma unroll
              for (int u = 0; u < S::UPW; ++u) {
                if (warp + kWarps * u >= nu) break;
                uint32_t a[4];
                ldsm_x4_trans(a, a_row + (warp + kWarps * u) * 32);
#pragma unroll
                for (int t = 0; t < NT; ++t)
                  mma_bf16(acc[u][t], a, bf[t][0], bf[t][1]);
              }
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[slot]);
      }

      // the tile is done: its logits to shared memory (lg[row][id]), once
      // the previous tile's epilogue has read them ...
      consumer_sync();
      {
        const int g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
        for (int u = 0; u < S::UPW; ++u) {
          if (warp + kWarps * u >= nu) break;
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            float* p = lg + (t * 8 + c2) * S::LG_PITCH +
                       (warp + kWarps * u) * kUnit + g;
            p[0] = acc[u][t][0];
            p[S::LG_PITCH] = acc[u][t][1];
            p[8] = acc[u][t][2];
            p[S::LG_PITCH + 8] = acc[u][t][3];
          }
        }
      }
      consumer_sync();
      // ... then the processors, 16 ids a thread, and the fold per row
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = rr + RPP * i;
        RowPart part;
        if (r < rows && q < nu) {
          const int v0 = voff + (tu + q) * kUnit;   // global id
          float x[16];
          const float4* lp = reinterpret_cast<const float4*>(
              lg + r * S::LG_PITCH + q * kUnit);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 l4 = lp[e];
            x[4 * e] = l4.x + av[e].x;
            x[4 * e + 1] = l4.y + av[e].y;
            x[4 * e + 2] = l4.z + av[e].z;
            x[4 * e + 3] = l4.w + av[e].w;
          }
          // the masks are sparse: most chunks skip them
          if (any_set(sv[i])) {
#pragma unroll
            for (int e = 0; e < 16; ++e)
              if (byte_set(sv[i], e))
                x[e] = x[e] > 0.f ? x[e] / penalty : x[e] * penalty;
          }
          if (any_set(bv[i])) {
#pragma unroll
            for (int e = 0; e < 16; ++e)
              if (byte_set(bv[i], e)) x[e] = -FLT_MAX;
          }
          bool all[16];
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            all[e] = true;
            if (TS) {
              const int v = v0 + e;
              if (v < lo[i] || (v >= tb && v < hi[i]) || v > cap[i])
                x[e] = -FLT_MAX;
            }
          }
          tree_argmax(x, all, v0, part.m, part.mi);
          if (TS) {
            bool ts[16], text[16];
#pragma unroll
            for (int e = 0; e < 16; ++e) {
              ts[e] = v0 + e >= tb;
              text[e] = !ts[e];
            }
            int unused;
            tree_argmax(x, ts, v0, part.mts, part.its);
            tree_argmax(x, text, v0, part.mtx, unused);
            if (part.mts != -INFINITY) {
#pragma unroll
              for (int e = 0; e < 16; ++e)
                if (ts[e]) part.sts += expf(x[e] - part.mts);
            }
          }
        }
        // the TILE_U lanes of row r hold the tile's units
        part.merge_lanes<TS, S::TILE_U>();
        run[i].merge<TS>(part);
      }
    }
  }

  // this block's partials, then the last block of the group merges them
  const size_t plane = (size_t)batch * nb;
  if (warp < kWarps && q == 0) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rr + RPP * i;
      if (r >= rows) continue;
      const size_t at = (size_t)(row0 + r) * nb + blk;
      pf[at] = run[i].m;
      pi[at] = run[i].mi;
      if (TS) {
        pf[plane + at] = run[i].mts;
        pf[2 * plane + at] = run[i].sts;
        pf[3 * plane + at] = run[i].mtx;
        pi[plane + at] = run[i].its;
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(count + blockIdx.y, 1) == nb - 1;
  __syncthreads();
  if (!is_last || warp == kWarps) return;
  __threadfence();
  // TPR consumer threads per row; thread l of a row folds blocks l,
  // l + TPR, ... in order (loads in batches of 8, in flight together),
  // then the row's threads fold in a fixed tree: the same bits every run
  constexpr int TPR = kThreads / R < 32 ? kThreads / R : 32;
  for (int rb = 0; rb < rows; rb += kThreads / TPR) {
    const int r = rb + tid / TPR;
    const size_t base = (size_t)(row0 + r) * nb;
    RowPart part;
    for (int i0 = tid % TPR; r < rows && i0 < nb; i0 += 8 * TPR) {
      RowPart p[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int i = i0 + k * TPR;
        if (i >= nb) continue;
        p[k].m = __ldcg(pf + base + i);
        p[k].mi = __ldcg(pi + base + i);
        if (TS) {
          p[k].mts = __ldcg(pf + plane + base + i);
          p[k].sts = __ldcg(pf + 2 * plane + base + i);
          p[k].mtx = __ldcg(pf + 3 * plane + base + i);
          p[k].its = __ldcg(pi + plane + base + i);
        }
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) part.merge<TS>(p[k]);
    }
    part.merge_lanes<TS, TPR>();
    if (r < rows && tid % TPR == 0 && parts != nullptr) {
      float* o = parts + (size_t)(row0 + r) * (TS ? 6 : 2);
      o[0] = part.m;
      o[1] = (float)part.mi;
      if (TS) {
        o[2] = part.mts;
        o[3] = (float)part.its;
        o[4] = part.sts;
        o[5] = part.mtx;
      }
    } else if (r < rows && tid % TPR == 0) {
      int tok = part.mi;
      if (TS) {
        const float lse =
            part.mts == -INFINITY ? -INFINITY : part.mts + logf(part.sts);
        if (lse > part.mtx) tok = part.its;
      }
      out[row0 + r] = tok;
    }
  }
  if (tid == 0) count[blockIdx.y] = 0;  // ready for the next launch
}

template <int NT, bool TS>
int launch(const void* h, const void* table_t, const void* add,
           const void* seen, const void* ban, float penalty, const void* tlo,
           const void* thi, const void* tcap, int tb, int batch, int dim,
           int vocab, int n_blocks, void* pf, void* pi, void* count,
           void* out, int voff, void* parts, cudaStream_t stream) {
  const size_t smem = smem_bytes<NT>(dim);
  const int groups = (batch + 8 * NT - 1) / (8 * NT);
  if (smem > (size_t)kMaxSmem || groups > 65535)
    return (int)cudaErrorInvalidValue;
  auto kernel = greedy_step_sm90<NT, TS>;
  static const int attr = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != 0) return attr;
  kernel<<<dim3(n_blocks, groups), kThreads + 32, smem, stream>>>(
      (const bf16*)h, (const bf16*)table_t, (const float*)add,
      (const int8_t*)seen, (const int8_t*)ban, penalty, (const int*)tlo,
      (const int*)thi, (const int*)tcap, tb, batch, dim, vocab, (float*)pf,
      (int*)pi, (int*)count, (int*)out, voff, (float*)parts);
  return (int)cudaGetLastError();
}

// the instantiation for `rows` rows a group (8, 16, 32, 64 or 128)
template <bool TS>
int launch_rows(int rows, const void* h, const void* table_t,
                const void* add, const void* seen, const void* ban,
                float penalty, const void* tlo, const void* thi,
                const void* tcap, int tb, int batch, int dim, int vocab,
                int n_blocks, void* pf, void* pi, void* count, void* out,
                int voff, void* parts, cudaStream_t s) {
#define K2_ROWS(NT)                                                        \
  case 8 * NT:                                                             \
    return launch<NT, TS>(h, table_t, add, seen, ban, penalty, tlo, thi,   \
                          tcap, tb, batch, dim, vocab, n_blocks, pf, pi,   \
                          count, out, voff, parts, s);
  switch (rows) {
    K2_ROWS(1)
    K2_ROWS(2)
    K2_ROWS(4)
    K2_ROWS(8)
    K2_ROWS(16)
  }
#undef K2_ROWS
  return (int)cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// bf16 hidden (B, D) and table_t (D, vocab); float32 add (vocab); int8 seen
// and ban (B, vocab) or null; int32 tlo/thi/tcap (B) or null (ts mode is on
// when tlo is not null). `rows` is the row group (8, 16, 32, 64 or 128),
// `n_blocks` the blocks the vocab is split over; pf and pi hold 4 and 2
// planes of B * n_blocks partials, count at least ceil(B / rows) int32
// zeros (left zero); out B int32 tokens. With `parts` set (the vocab-shard
// mode) out is unused and parts receives B rows of 2 (6 in ts mode) float32
// partials; the arrays are a shard whose first column is id voff, and tb
// and the bounds are global ids. D must be a multiple of 8, vocab of 16,
// and every array 16-byte aligned. Returns cudaGetLastError() after the
// launch.
extern "C" int fused_greedy_step_sm90(
    const void* h, const void* table_t, const void* add, const void* seen,
    const void* ban, float penalty, const void* tlo, const void* thi,
    const void* tcap, int tb, int batch, int dim, int vocab, int rows,
    int n_blocks, void* pf, void* pi, void* count, void* out, int voff,
    void* parts, void* stream) {
  if (batch < 1 || dim < 8 || dim % 8 != 0 || vocab < kUnit ||
      vocab % kUnit != 0 || n_blocks < 1 || n_blocks > vocab / kUnit ||
      !aligned16(h) ||
      !aligned16(table_t) || !aligned16(add) || !aligned16(seen) ||
      !aligned16(ban))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return tlo != nullptr
             ? launch_rows<true>(rows, h, table_t, add, seen, ban, penalty,
                                 tlo, thi, tcap, tb, batch, dim, vocab,
                                 n_blocks, pf, pi, count, out, voff, parts,
                                 s)
             : launch_rows<false>(rows, h, table_t, add, seen, ban, penalty,
                                  tlo, thi, tcap, tb, batch, dim, vocab,
                                  n_blocks, pf, pi, count, out, voff, parts,
                                  s);
}
