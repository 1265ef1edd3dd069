// Single-query cross-attention for one decode step, Hopper (sm_90a), as
// flash-decoding: the keys of each (b, h) are split across blocks, and
// the last block of a (b, h) to finish merges the partial softmaxes.
//
// Replaces the TPU kernel `_kernel` of audio_transformers_tpu/ops/
// decode_attention.py (`decode_cross_attention`, :100). q (BH, hd); k and
// v in the time-minor layout (BH, hd, T); out (BH, hd). Modes:
//   none: k, v float32 or bf16
//   int8: k, v int8 with k_scale (BH, T) folded into the logit row and
//         v_scale (BH, hd) into the output row; q and p stay float32.
//   int4: k, v int8 (BH, hd, T/2), two 4-bit keys a byte (key 2t in the
//         low nibble of byte t, 2t+1 in the high one), k_scale split
//         even/odd as (BH, 2, T/2), v_scale (BH, hd); q and p as int8.
//
// Bound on the H100: device memory. A call reads all of K and V once
// (whisper-tiny, T = 1500, bf16: 384 KB per (b, h)) for 4 * hd flops per
// key. One block per (b, h), as before, left most of the 132 SMs idle at
// the path's batch sizes (6 blocks at B = 1), and a load that waits for
// the one before it leaves the memory idle, so:
//
// Grid (splits, BH): block (c, bh) takes keys [c * chunk, (c + 1) * chunk)
// of every channel; ops/decode_attention.split_plan picks the chunk so
// that the grid holds about two blocks per SM where T allows. The block
// streams its chunk through a ring of two sub-tiles of TK keys (128 bf16,
// 256 int8 or 64 float32: 16 lanes x 16 bytes per channel row) of K and
// of V, copied into shared memory by 16-byte cp.async copies, so that the
// next sub-tile is in flight while one is used. Rows of the time-minor
// layout start wherever T puts them (T = 1500 puts bf16 rows 8 bytes off
// the 16-byte grid), so a row's copy is the 17 aligned segments around
// its keys, and a lane takes its 16 bytes at the row's offset from two of
// them; segments past the chunk's last key are zero-filled, not read. Per
// sub-tile, lane g of a row's 16 lanes forms the partial scores of keys
// [k0 + g * VEC, +VEC) over its channels (2 rows per warp, 16 per pass),
// summed over the warp's rows by shuffles and over the warps in shared
// memory in a fixed order; one thread per key then applies k_scale, the
// scale and the mask, and an online softmax follows: every thread takes
// the same running max m from the warps' maxima, the key's thread forms
// p = exp(s - m) once, and each lane adds its share of acc[d] = alpha
// acc[d] + p . v (summed over the row's lanes by shuffles once, at the
// end). The split's (m, l, acc) go to float32 scratch; a counter per
// (b, h), which the wrapper allocates once and the merging block resets,
// finds the last block, which loads the partials into its ring in one
// round (split_plan keeps the splits to what the ring holds, merge_cap)
// and folds them in split order (so two launches give the same bits),
// divides by
// max(l, 1e-30) and applies v_scale. One launch per call; no score row is
// held for all of T, so T is not bounded by shared memory (hd is: at most
// 128). The copies' byte offsets are 32-bit, and K and V must share their
// offset from the 16-byte grid (both hold for the path's tensors).
//
// int4 runs the same loop over packed columns (bytes): the chunk, the
// sub-tile (256 bytes of a channel row, 512 keys), the copies and the
// funnel shift of misaligned rows (T = 1500 puts a 750-byte row 14 bytes
// off the grid) are int8's. A lane's 16 bytes hold 16 even and 16 odd
// keys; the block takes the even (low-nibble) half and then the odd one,
// 16 values at a time as int8 does, each half updating the one (m, l,
// acc) as the reference's even/odd half-blocks do, so the registers stay
// int8's. Key 2i takes k_scale[bh, 0, i], key 2i + 1 k_scale[bh, 1, i],
// and the mask tests the true position (2i or 2i + 1 against t_valid), so
// an odd t_valid masks the high nibble of the last byte. The split plan
// counts whole bytes: at T = 1500 a (b, h) has 750 of them, 3 splits.

#include <limits.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// a byte of two int4 keys: the storage unit (column) of the int4 mode
struct int4x2 {
  int8_t b;
};

// columns of the key layout in 16 bytes (int4: 16 bytes, 32 keys)
template <typename KT>
__host__ __device__ constexpr int vec_keys() {
  return 16 / (int)sizeof(KT);
}

// 16 bytes global -> shared (a shared-window address) if `in`, else 16
// zero bytes (nothing read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes as floats, by key type.
__device__ __forceinline__ void unpack(float (&f)[4], uint4 x) {
  f[0] = __uint_as_float(x.x);
  f[1] = __uint_as_float(x.y);
  f[2] = __uint_as_float(x.z);
  f[3] = __uint_as_float(x.w);
}
__device__ __forceinline__ void unpack(float (&f)[8], uint4 x) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 is the top half of a float32
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(float (&f)[16], uint4 x) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] = (float)(int8_t)(uint8_t)(w[i] >> (8 * j));
}

// 16 bytes of int4 pairs as the 16 floats of one half: the low nibbles
// (even keys) for h = 0, the high ones (odd keys) for h = 1,
// sign-extended from 4 bits.
__device__ __forceinline__ void unpack_half(float (&f)[16], uint4 x, int h) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
  const int sh = 4 * h;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] = (float)((int)(((w[i] >> (8 * j + sh)) & 0xFu) ^ 8u) - 8);
}

// Lane g's 16 bytes of keys [k0 + g * VEC, +VEC) of a row copied into a
// sub-tile: bytes [mis, mis + 16) of segments g and g + 1, mis being the
// row's offset from the 16-byte grid.
__device__ __forceinline__ uint4 keys_at(const uint4* row, int g, int mis) {
  const uint4 a = row[g];
  if (mis == 0) return a;
  const uint4 b = row[g + 1];
  switch (mis) {  // whole 32-bit words: moves only
    case 4:
      return make_uint4(a.y, a.z, a.w, b.x);
    case 8:
      return make_uint4(a.z, a.w, b.x, b.y);
    case 12:
      return make_uint4(a.w, b.x, b.y, b.z);
  }
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int ws = mis >> 2, sh = (mis & 3) * 8;
  uint32_t x[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {  // x[i] = w[i + ws], by selects
    uint32_t y = w[i];
    y = ws == 1 ? w[i + 1] : y;
    y = ws == 2 ? w[i + 2] : y;
    y = ws == 3 ? w[i + 3] : y;
    x[i] = y;
  }
  return make_uint4(__funnelshift_r(x[0], x[1], sh),
                    __funnelshift_r(x[1], x[2], sh),
                    __funnelshift_r(x[2], x[3], sh),
                    __funnelshift_r(x[3], x[4], sh));
}

constexpr int kLanes = 16;      // lanes per channel row
constexpr int kSeg = kLanes + 1;  // 16-byte segments per row copy
constexpr int kStages = 2;      // sub-tiles in the ring
constexpr int kCopyTpr = 4;     // threads per row in a copy
constexpr int kCopyRows = 128 / (kThreads / kCopyTpr);  // row passes
constexpr int kCopySegs = (kSeg + kCopyTpr - 1) / kCopyTpr;

// The most splits of a (b, h): the merge stages every split's partial
// (hd + 2 floats) in the ring at once.
__host__ __device__ constexpr int merge_cap(int hd) {
  return kStages * 2 * hd * kSeg * 4 / (hd + 2);
}

// Shared memory of a block, in bytes: the ring of K and V sub-tiles
// (16-byte aligned) first.
template <typename KT>
__host__ __device__ constexpr size_t smem_bytes(int hd) {
  return sizeof(uint4) * kStages * 2 * hd * kSeg +
         sizeof(float) * (hd + (kWarps + 1) * vec_keys<KT>() * kLanes + 64);
}

// Three blocks per SM, as many as the ring of hd = 64 lets share one (so
// that the path's 288-block grids run in one wave): at most 80 registers.
// t_len and chunk count columns of the layout (int4: bytes), t_valid keys.
template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads, 3)
    dca_split(const QT* __restrict__ q, const KT* __restrict__ k,
              const KT* __restrict__ v, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale, QT* __restrict__ out,
              float* __restrict__ part, int* __restrict__ count, int hd,
              int t_len, int t_valid, int chunk, float scale) {
  constexpr bool kInt4 = std::is_same<KT, int4x2>::value;
  constexpr int kHalves = kInt4 ? 2 : 1;  // int4: even keys, then odd
  constexpr int VEC = vec_keys<KT>();
  constexpr int TK = VEC * kLanes;       // columns per sub-tile
  constexpr int kRowsW = 32 / kLanes;    // channel rows per warp
  constexpr int kRowsB = kWarps * kRowsW;  // channel rows per pass
  constexpr int kMaxPasses = 128 / kRowsB;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem);  // [kStages][2][hd][kSeg]
  float* qs = reinterpret_cast<float*>(ring + kStages * 2 * hd * kSeg);
  float* red = qs + hd;        // [kWarps][TK]: scores per warp
  float* ps = red + kWarps * TK;  // [TK]: the sub-tile's p
  float* wmax = ps + TK;       // [32]: maxima of the scores per warp
  float* wsum = wmax + 32;     // [32]: sums of p per warp
  __shared__ int is_last;

  const int split = blockIdx.x, n_split = gridDim.x;
  const size_t bh = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane & (kLanes - 1), r = lane / kLanes;
  const int passes = (hd + kRowsB - 1) / kRowsB;
  const int c_begin = split * chunk;  // columns
  const int c_end =
      min(c_begin + chunk, kInt4 ? (t_valid + 1) / 2 : t_valid);
  const int n_sub = (c_end - c_begin + TK - 1) / TK;
  const char* kb = reinterpret_cast<const char*>(k + bh * hd * t_len);
  const char* vb = reinterpret_cast<const char*>(v + bh * hd * t_len);
  const int row_bytes = t_len * (int)sizeof(KT);

  // this thread's copies: rows d = tid / kCopyTpr + cr * (kThreads /
  // kCopyTpr), segments s = tid % kCopyTpr + kCopyTpr * j, as byte offsets
  // from the (b, h)'s first key (the same for K and V, which the launcher
  // requires to share their offset from the 16-byte grid); seg0 is the
  // row's segment 0 at the first sub-tile, and a segment is copied only
  // while it holds a key below c_end: 16 s + step < lim
  int seg0[kCopyRows], lim[kCopyRows];
#pragma unroll
  for (int cr = 0; cr < kCopyRows; ++cr) {
    const int d = min(tid / kCopyTpr + cr * (kThreads / kCopyTpr), hd - 1);
    const int first = d * row_bytes + c_begin * (int)sizeof(KT);
    const int mis = (int)((reinterpret_cast<uintptr_t>(kb) + first) & 15);
    seg0[cr] = first - mis;
    lim[cr] = (c_end - c_begin) * (int)sizeof(KT) + mis;
  }
  const uint32_t ring_s = (uint32_t)__cvta_generic_to_shared(ring);
  auto load_stage = [&](int it) {
    const uint32_t st = ring_s + (it % kStages) * 2 * hd * kSeg * 16;
    const int step = it * TK * (int)sizeof(KT);
#pragma unroll
    for (int cr = 0; cr < kCopyRows; ++cr) {
      const int d = tid / kCopyTpr + cr * (kThreads / kCopyTpr);
      if (d >= hd) break;
#pragma unroll
      for (int j = 0; j < kCopySegs; ++j) {
        const int sg = tid % kCopyTpr + kCopyTpr * j;
        if (sg >= kSeg) break;
        const int rel = 16 * sg + step, off = seg0[cr] + rel;
        const bool in = rel < lim[cr];
        const uint32_t dst = st + 16 * (d * kSeg + sg);
        cp_async16(dst, in ? kb + off : kb, in);
        cp_async16(dst + 16 * hd * kSeg, in ? vb + off : vb, in);
      }
    }
  };
#pragma unroll
  for (int it = 0; it < kStages - 1; ++it) {
    if (it < n_sub) load_stage(it);
    cp_async_commit();
  }
  for (int d = tid; d < hd; d += kThreads) qs[d] = to_f(q[bh * hd + d]);
  __syncthreads();
  // pass p's rows: warp w takes rows p * kRowsB + w + kWarps * r, r <
  // kRowsW, which lie kWarps rows apart, so that they share their offset
  // from the 16-byte grid (a uniform branch in keys_at) whenever a row's
  // length in bytes is even; that offset and q[d] stay in registers
  float qd[kMaxPasses];
  int mis[kMaxPasses];
#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p) {
    const int d = min(p * kRowsB + warp + kWarps * r, hd - 1);
    qd[p] = p * kRowsB + warp + kWarps * r < hd ? qs[d] : 0.f;
    mis[p] = (int)((reinterpret_cast<uintptr_t>(kb) + d * row_bytes +
                    c_begin * (int)sizeof(KT)) & 15);
  }

  float m_run = -INFINITY;  // the running max and sum of p: block-uniform
  float l_run = 0.f;
  float acc[kMaxPasses];    // this lane's share of acc[d] of its rows
#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p) acc[p] = 0.f;
  for (int it = 0; it < n_sub; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // sub-tile it is in; everyone is done with it - 1
    if (it + kStages - 1 < n_sub) load_stage(it + kStages - 1);
    cp_async_commit();
    const uint4* kt = ring + (it % kStages) * 2 * hd * kSeg;
    const uint4* vt = kt + hd * kSeg;
    const int k0 = c_begin + it * TK, t0 = k0 + g * VEC;
    const bool full = k0 + TK <= c_end;  // no column of the sub-tile masked

    // int4: the even keys of the sub-tile, then the odd ones, each half
    // one online-softmax update; else one pass
#pragma unroll 1
    for (int h = 0; h < kHalves; ++h) {
      // scores of columns [t0, t0 + VEC) over this lane's channels
      float sc[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) sc[j] = 0.f;
#pragma unroll
      for (int p = 0; p < kMaxPasses; ++p) {
        const int d = p * kRowsB + warp + kWarps * r;
        if (p >= passes || d >= hd) break;
        float kf[VEC];
        if constexpr (kInt4)
          unpack_half(kf, keys_at(kt + d * kSeg, g, mis[p]), h);
        else
          unpack(kf, keys_at(kt + d * kSeg, g, mis[p]));
#pragma unroll
        for (int j = 0; j < VEC; ++j) sc[j] = fmaf(qd[p], kf[j], sc[j]);
      }
#pragma unroll
      for (int o = 16; o >= kLanes; o >>= 1)  // over the warp's rows
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          sc[j] += __shfl_xor_sync(0xffffffffu, sc[j], o);
      if (r == 0) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) red[warp * TK + g * VEC + j] = sc[j];
      }
      __syncthreads();
      // one thread per column (whole warps: TK is a multiple of 32): the
      // sum over the warps, k_scale, the scale, the mask at the key's true
      // position; then p against the new running max, which every thread
      // takes from the warps' maxima
      float s = -INFINITY;
      if (tid < TK) {
        const int t = k0 + tid;
        if (t < c_end && (!kInt4 || 2 * t + h < t_valid)) {
          s = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) s += red[w * TK + tid];
          if (k_scale != nullptr)
            s *= k_scale[(bh * kHalves + h) * t_len + t];
          s *= scale;
        }
        const float wm = warp_max(s);
        if (lane == 0) wmax[warp] = wm;
      }
      __syncthreads();
      float m_new = m_run;
#pragma unroll
      for (int w = 0; w < TK / 32; ++w) m_new = fmaxf(m_new, wmax[w]);
      const float alpha = expf(m_run - m_new);  // 0 on the first update
      m_run = m_new;
      if (tid < TK) {
        const float pt = expf(s - m_new);
        ps[tid] = pt;
        const float wsm = warp_sum(pt);
        if (lane == 0) wsum[warp] = wsm;
      }
      __syncthreads();
      float l_tile = 0.f;
#pragma unroll
      for (int w = 0; w < TK / 32; ++w) l_tile += wsum[w];
      l_run = l_run * alpha + l_tile;

      // this lane's share of acc[d] = alpha acc[d] + p . v over the
      // sub-tile (summed over the row's lanes once, at the end); columns
      // at or past c_end may hold anything (a copied segment runs past
      // them)
      float pj[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) pj[j] = ps[g * VEC + j];
#pragma unroll
      for (int p = 0; p < kMaxPasses; ++p) {
        const int d = p * kRowsB + warp + kWarps * r;
        if (p >= passes || d >= hd) break;
        float vf[VEC];
        if constexpr (kInt4)
          unpack_half(vf, keys_at(vt + d * kSeg, g, mis[p]), h);
        else
          unpack(vf, keys_at(vt + d * kSeg, g, mis[p]));
        float a = 0.f;
        if (full) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) a = fmaf(pj[j], vf[j], a);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            a = fmaf(pj[j], t0 + j < c_end ? vf[j] : 0.f, a);
        }
        acc[p] = acc[p] * alpha + a;
      }
    }
  }
  cp_async_wait<0>();

  // this split's partial (acc, m, l); acc is summed over a row's lanes,
  // which between them hold every key of the split
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1)
#pragma unroll
    for (int p = 0; p < kMaxPasses; ++p)
      acc[p] += __shfl_xor_sync(0xffffffffu, acc[p], o);
  float* pb = part + (bh * n_split + split) * (hd + 2);
#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p) {
    const int d = p * kRowsB + warp + kWarps * r;
    if (p < passes && d < hd && g == 0) pb[d] = acc[p];
  }
  if (tid == 0) {
    pb[hd] = m_run;
    pb[hd + 1] = l_run;
  }

  // the last block of this (b, h) merges every split's partials
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(count + bh, 1) == n_split - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // stage every split's partials with one round of loads (n_split <=
  // merge_cap(hd)), then fold them in split order (the same bits every
  // run), with a running max
  float* stage = reinterpret_cast<float*>(ring);
  const float* pr = part + bh * n_split * (hd + 2);
#pragma unroll 8
  for (int i = tid; i < n_split * (hd + 2); i += kThreads)
    stage[i] = __ldcg(pr + i);
  __syncthreads();
  if (tid < hd) {
    float m_all = -INFINITY, l_all = 0.f, o_all = 0.f;
    for (int i = 0; i < n_split; ++i) {
      const float* pi = stage + i * (hd + 2);
      const float mi = pi[hd], mx = fmaxf(m_all, mi);
      const float c_old = expf(m_all - mx), c_new = expf(mi - mx);
      o_all = o_all * c_old + pi[tid] * c_new;
      l_all = l_all * c_old + pi[hd + 1] * c_new;
      m_all = mx;
    }
    float o = o_all / fmaxf(l_all, 1e-30f);
    if (v_scale != nullptr) o *= v_scale[bh * hd + tid];
    out[bh * hd + tid] = from_f<QT>(o);
  }
  if (tid == 0) count[bh] = 0;  // ready for the next launch
}

template <typename QT, typename KT>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, void* out, void* part, void* count, int bh,
           int hd, int t_len, int t_valid, int chunk, int splits,
           float scale, cudaStream_t stream) {
  constexpr int TK = vec_keys<KT>() * kLanes;
  // the columns that hold a valid key
  const int cols = std::is_same<KT, int4x2>::value ? (t_valid + 1) / 2
                                                   : t_valid;
  if (chunk < TK || chunk % TK != 0 || splits < 1 || cols > t_len ||
      (splits - 1) * chunk >= cols || splits * chunk < cols ||
      hd < 1 || hd > 128 || splits > merge_cap(hd) || bh < 1 ||
      (((uintptr_t)k ^ (uintptr_t)v) & 15) != 0 ||
      (size_t)hd * t_len * sizeof(KT) > (size_t)INT_MAX)
    return (int)cudaErrorInvalidValue;
  auto kernel = dca_split<QT, KT>;
  static const int attr = (int)cudaFuncSetAttribute(  // once: hd 128's size
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<KT>(128));
  if (attr != 0) return attr;
  const dim3 grid(splits, bh);
  kernel<<<grid, kThreads, smem_bytes<KT>(hd), stream>>>(
      (const QT*)q, (const KT*)k, (const KT*)v, (const float*)ks,
      (const float*)vs, (QT*)out, (float*)part, (int*)count, hd, t_len,
      t_valid, chunk, scale);
  return (int)cudaGetLastError();
}

template <typename QT>
int dispatch_kv(int kv_dtype, const void* q, const void* k, const void* v,
                const void* ks, const void* vs, void* out, void* part,
                void* count, int bh, int hd, int t_len, int t_valid,
                int chunk, int splits, float scale, cudaStream_t stream) {
  switch (kv_dtype) {
    case kF32:
      return launch<QT, float>(q, k, v, ks, vs, out, part, count, bh, hd,
                               t_len, t_valid, chunk, splits, scale, stream);
    case kBF16:
      return launch<QT, __nv_bfloat16>(q, k, v, ks, vs, out, part, count, bh,
                                       hd, t_len, t_valid, chunk, splits,
                                       scale, stream);
    case kI8:
      return launch<QT, int8_t>(q, k, v, ks, vs, out, part, count, bh, hd,
                                t_len, t_valid, chunk, splits, scale, stream);
    case kI4:
      return launch<QT, int4x2>(q, k, v, ks, vs, out, part, count, bh, hd,
                                t_len, t_valid, chunk, splits, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// k_scale and v_scale are null in mode none. t_len and chunk count columns
// of the layout (int4, kv_dtype kI4: packed bytes, two keys each), t_valid
// keys. part is float32 scratch of bh * splits * (hd + 2); count is int32
// of bh, zero before the launch and left zero after it. chunk and splits
// come from split_plan. Returns cudaGetLastError().
extern "C" int decode_cross_attention(const void* q, const void* k,
                                      const void* v, const void* k_scale,
                                      const void* v_scale, void* out,
                                      void* part, void* count, int bh, int hd,
                                      int t_len, int t_valid, int chunk,
                                      int splits, float scale, int q_dtype,
                                      int kv_dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (q_dtype == kF32)
    return dispatch_kv<float>(kv_dtype, q, k, v, k_scale, v_scale, out, part,
                              count, bh, hd, t_len, t_valid, chunk, splits,
                              scale, s);
  if (q_dtype == kBF16)
    return dispatch_kv<__nv_bfloat16>(kv_dtype, q, k, v, k_scale, v_scale,
                                      out, part, count, bh, hd, t_len,
                                      t_valid, chunk, splits, scale, s);
  return (int)cudaErrorInvalidValue;
}
