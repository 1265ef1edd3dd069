// Fused greedy decode step in float32 (sm_90a): tied-vocab projection,
// logit processors and argmax, without writing the (B, V) logits.
//
// Replaces the TPU kernel `_kernel` of audio_transformers_tpu/ops/
// decode_logits.py (`fused_greedy_step`) for float32 operands, its parity
// route; bfloat16, the serving path's dtype, runs the tensor-core kernel of
// decode_logits_sm90.cu, and ops/decode_logits.py picks the source by
// dtype. Semantics, per row b and padded vocab id v:
//   l = sum_d hidden[b, d] * table_t[d, v] + add[v]          (float32)
//   seen[b, v]: l = l > 0 ? l / penalty : l * penalty
//   ban[b, v]:  l = NEG_INF
//   ts mode:    l = NEG_INF where v < tlo[b] | tb <= v < thi[b] | v > tcap[b]
//   token = argmax_v l (lowest index on ties); in ts mode, if
//   logsumexp(l[tb:]) > max(l[:tb]) the token is tb + argmax(l[tb:]).
//
// Pass 1: one block per (256-id vocab tile, group of 8 rows). The rows'
// hidden vectors sit in shared memory; each thread owns one vocab id and
// accumulates its 8 dot products in registers while it walks d, so every
// table element is read once per row group, coalesced along v. The tile's
// processed logits go to shared memory and warp r reduces row r to the
// tile's partials: max and argmax, and in ts mode the timestamp max,
// argmax and sum of exp relative to that max, and the text max.
// Pass 2: one warp per row merges the tiles' partials (ties keep the
// lower index; the sums merge as M + log sum_i s_i exp(m_i - M)) and
// applies the timestamp force rule.
// Vocab-shard mode (tensor parallelism): with `parts` set, the table and
// masks are a shard whose first column is id `voff`; ids are compared and
// reported global, and pass 2 writes each row's merged partials (float32
// (B, 2), or (B, 6) in ts mode: m, mi, mts, its, sts, mtx, the ids as
// floats) instead of a token, for the ranks to merge.

#include <float.h>
#include <limits.h>

#include "common.cuh"

#define TILE 256  // vocab ids per block = threads per block
#define RB 8      // rows per block = warps per block

// partial buffers: pf (4, B, n_tiles) = max, ts max, ts sum, text max;
//                  pi (2, B, n_tiles) = argmax, ts argmax

__device__ __forceinline__ void arg_merge(float& m, int& i, float m2, int i2) {
  if (m2 > m || (m2 == m && i2 < i)) {
    m = m2;
    i = i2;
  }
}

__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) {
    m = mn;
    s = 0.f;
    return;
  }
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

template <bool TS>
__global__ void __launch_bounds__(TILE)
greedy_pass1(const float* __restrict__ h, const float* __restrict__ table_t,
             const float* __restrict__ add, const int8_t* __restrict__ seen,
             const int8_t* __restrict__ ban, float penalty,
             const int* __restrict__ tlo, const int* __restrict__ thi,
             const int* __restrict__ tcap, int tb, int batch, int dim,
             int vocab, int voff, float* __restrict__ pf,
             int* __restrict__ pi) {
  extern __shared__ float sm[];
  float* hs = sm;              // RB * dim
  float* lg = sm + RB * dim;   // RB * TILE

  const int tile = blockIdx.x, n_tiles = gridDim.x;
  const int r0 = blockIdx.y * RB;
  const int rows = min(RB, batch - r0);
  for (int i = threadIdx.x; i < RB * dim; i += TILE) {
    const int r = i / dim;
    hs[i] = r < rows ? h[(size_t)(r0 + r) * dim + (i - r * dim)] : 0.f;
  }
  __syncthreads();

  const int v = tile * TILE + threadIdx.x;
  float acc[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r] = 0.f;
#pragma unroll 4
  for (int d = 0; d < dim; ++d) {
    const float w = table_t[(size_t)d * vocab + v];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = fmaf(hs[r * dim + d], w, acc[r]);
  }
  const float a = add[v];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (r >= rows) break;
    const size_t at = (size_t)(r0 + r) * vocab + v;
    float l = acc[r] + a;
    if (seen != nullptr && seen[at] != 0) l = l > 0.f ? l / penalty : l * penalty;
    if (ban != nullptr && ban[at] != 0) l = -FLT_MAX;
    if (TS) {
      const int b = r0 + r, g = voff + v;
      if (g < tlo[b] || (g >= tb && g < thi[b]) || g > tcap[b]) l = -FLT_MAX;
    }
    lg[r * TILE + threadIdx.x] = l;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= rows) return;
  const float* row = lg + warp * TILE;
  float m = -INFINITY, mts = -INFINITY, mtx = -INFINITY;
  int mi = INT_MAX, its = INT_MAX;
  for (int j = lane; j < TILE; j += 32) {
    const float x = row[j];
    const int g = voff + tile * TILE + j;
    arg_merge(m, mi, x, g);
    if (TS) {
      if (g >= tb)
        arg_merge(mts, its, x, g);
      else
        mtx = fmaxf(mtx, x);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    arg_merge(m, mi, __shfl_xor_sync(0xffffffffu, m, o),
              __shfl_xor_sync(0xffffffffu, mi, o));
    if (TS) {
      arg_merge(mts, its, __shfl_xor_sync(0xffffffffu, mts, o),
                __shfl_xor_sync(0xffffffffu, its, o));
      mtx = fmaxf(mtx, __shfl_xor_sync(0xffffffffu, mtx, o));
    }
  }
  float sts = 0.f;
  if (TS && mts != -INFINITY) {
    for (int j = lane; j < TILE; j += 32)
      if (voff + tile * TILE + j >= tb) sts += expf(row[j] - mts);
    sts = warp_sum(sts);
  }
  if (lane == 0) {
    const size_t at = (size_t)(r0 + warp) * n_tiles + tile;
    const size_t plane = (size_t)batch * n_tiles;
    pf[at] = m;
    pi[at] = mi;
    if (TS) {
      pf[plane + at] = mts;
      pf[2 * plane + at] = sts;
      pf[3 * plane + at] = mtx;
      pi[plane + at] = its;
    }
  }
}

template <bool TS>
__global__ void greedy_pass2(const float* __restrict__ pf,
                             const int* __restrict__ pi, int batch,
                             int n_tiles, int* __restrict__ out,
                             float* __restrict__ parts) {
  const int b = blockIdx.x, lane = threadIdx.x;
  const size_t plane = (size_t)batch * n_tiles;
  const size_t base = (size_t)b * n_tiles;
  float m = -INFINITY, mts = -INFINITY, mtx = -INFINITY, lm = -INFINITY;
  float ls = 0.f;
  int mi = INT_MAX, its = INT_MAX;
  for (int i = lane; i < n_tiles; i += 32) {
    arg_merge(m, mi, pf[base + i], pi[base + i]);
    if (TS) {
      const float tm = pf[plane + base + i];
      arg_merge(mts, its, tm, pi[plane + base + i]);
      lse_merge(lm, ls, tm, pf[2 * plane + base + i]);
      mtx = fmaxf(mtx, pf[3 * plane + base + i]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    arg_merge(m, mi, __shfl_xor_sync(0xffffffffu, m, o),
              __shfl_xor_sync(0xffffffffu, mi, o));
    if (TS) {
      arg_merge(mts, its, __shfl_xor_sync(0xffffffffu, mts, o),
                __shfl_xor_sync(0xffffffffu, its, o));
      lse_merge(lm, ls, __shfl_xor_sync(0xffffffffu, lm, o),
                __shfl_xor_sync(0xffffffffu, ls, o));
      mtx = fmaxf(mtx, __shfl_xor_sync(0xffffffffu, mtx, o));
    }
  }
  if (lane == 0 && parts != nullptr) {
    float* o = parts + (size_t)b * (TS ? 6 : 2);
    o[0] = m;
    o[1] = (float)mi;
    if (TS) {
      o[2] = mts;
      o[3] = (float)its;
      o[4] = ls;
      o[5] = mtx;
    }
  } else if (lane == 0) {
    int tok = mi;
    if (TS) {
      const float lse = lm == -INFINITY ? -INFINITY : lm + logf(ls);
      if (lse > mtx) tok = its;
    }
    out[b] = tok;
  }
}

template <bool TS>
static int launch(const void* h, const void* table_t, const void* add,
                  const void* seen, const void* ban, float penalty,
                  const void* tlo, const void* thi, const void* tcap, int tb,
                  int batch, int dim, int vocab, void* pf, void* pi,
                  void* out, int voff, void* parts, cudaStream_t stream) {
  const int n_tiles = vocab / TILE;
  const size_t smem = sizeof(float) * (RB * dim + RB * TILE);
  dim3 grid(n_tiles, (batch + RB - 1) / RB);
  greedy_pass1<TS><<<grid, TILE, smem, stream>>>(
      (const float*)h, (const float*)table_t, (const float*)add,
      (const int8_t*)seen, (const int8_t*)ban, penalty, (const int*)tlo,
      (const int*)thi, (const int*)tcap, tb, batch, dim, vocab, voff,
      (float*)pf, (int*)pi);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  greedy_pass2<TS><<<batch, 32, 0, stream>>>((const float*)pf,
                                              (const int*)pi, batch,
                                              n_tiles, (int*)out,
                                              (float*)parts);
  return (int)cudaGetLastError();
}

// float32 operands only (dtype kF32); seen, ban and the three ts bound
// vectors may be null; ts mode is on when tlo is not null. vocab must be a
// multiple of 256. With `parts` set (the vocab-shard mode) out is unused
// and parts receives B rows of 2 (6 in ts mode) float32 partials of the
// shard whose first column is id voff. Returns cudaGetLastError() after
// the launches.
extern "C" int fused_greedy_step(const void* h, const void* table_t,
                                 const void* add, const void* seen,
                                 const void* ban, float penalty,
                                 const void* tlo, const void* thi,
                                 const void* tcap, int tb, int batch,
                                 int dim, int vocab, int dtype, void* pf,
                                 void* pi, void* out, int voff, void* parts,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype != kF32) return (int)cudaErrorInvalidValue;
  return tlo != nullptr
             ? launch<true>(h, table_t, add, seen, ban, penalty, tlo,
                             thi, tcap, tb, batch, dim, vocab, pf, pi, out,
                             voff, parts, s)
             : launch<false>(h, table_t, add, seen, ban, penalty, tlo, thi,
                             tcap, tb, batch, dim, vocab, pf, pi, out, voff,
                             parts, s);
}
