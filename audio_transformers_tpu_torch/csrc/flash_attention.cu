// K4: flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of audio_transformers_tpu/ops/attention.py:
//   flash_attention_fwd      <- _fwd_kernel       online softmax over key
//                               tiles; writes out and the per-row lse
//   flash_attention_bwd_dq   <- _bwd_dq_kernel    p = exp(s - lse),
//                               ds = p * (dO v^T - delta), dq = ds k
//   flash_attention_bwd_dkv  <- _bwd_dkv_kernel   dv = p^T dO, dk = ds^T q
// The forward takes float32 and bfloat16. The backward here is the
// float32 route (its 2e-5 parity); bfloat16's runs on the tensor cores in
// flash_attention_bwd_sm90.cu.
//
// Layout: q (BH, Tq, d), k and v (BH, Tk, d), dO like q, all row-major in
// one storage dtype (float32 or bfloat16); lse and delta (BH, Tq) float32.
// The softmax scale is folded into q by the caller, so no kernel scales.
//
// What bounds it on the H100: compute. At the whisper-tiny encoder shape
// (BH = 96 at batch 16, T = 1500, d = 64) the forward is 4*BH*T^2*d = 55
// GFLOP and the backward about 2.5 times that, against a few MB of q/k/v.
// This first version runs every product as float32 FMA on the CUDA cores
// (67 TFLOP/s peak), not on the tensor cores, so it is bound by FMA issue
// and shared-memory bandwidth. What the design does about that: 64 x 64
// tiles staged in shared memory as float32 (the transposed tiles padded to
// a row stride of 68 floats), 256 threads each holding a 4 x 4 register
// tile of the scores and a 4 x d/16 tile of the output, float4 shared
// loads, and scores and probabilities that never leave the SM. Blocks run
// in no order, so every output tile is owned by one block: dq by query
// tile, dk/dv by key tile, and nothing is reduced across blocks. Loops are
// bounded by t_q/t_k and the ragged edge is masked explicitly, so no input
// is zero-padded; under causality the tiles that lie wholly above the
// diagonal are skipped (they contribute exactly nothing). bf16 operands
// become exact float32 values, so a product is exact and only the sum
// order differs from the TPU's f32-accumulating matmuls. The reference's
// roundings are kept: p is rounded to the storage dtype before P.V and
// before dv, ds before dq and dk. The bf16 backward has moved to the
// tensor cores (flash_attention_bwd_sm90.cu); the forward's turn is next.

#include "common.cuh"

namespace {

constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // key rows per tile (the micro-tiling needs BQ == BK)
constexpr int NT = 256;  // threads: a 16 x 16 grid of 4 x 4 micro-tiles
constexpr int TS = 68;   // row stride of a transposed tile (floats)
constexpr float kNegInf = -3.4028234663852886e38f;  // finfo(float32).min

// Columns of a (64 x DP) accumulator: thread tx owns NC columns, in G
// groups of W consecutive ones; group g starts at g * 16 * W + tx * W.
template <int DP>
struct Cols {
  static constexpr int NC = DP / 16;
  static constexpr int W = NC < 4 ? NC : 4;
  static constexpr int G = NC / W;
  __device__ static int col(int tx, int c) {
    return (c / W) * 16 * W + tx * W + (c % W);
  }
};

template <int W>
__device__ __forceinline__ void load_w(float* o, const float* p);
template <>
__device__ __forceinline__ void load_w<4>(float* o, const float* p) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x, o[1] = x.y, o[2] = x.z, o[3] = x.w;
}
template <>
__device__ __forceinline__ void load_w<2>(float* o, const float* p) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  o[0] = x.x, o[1] = x.y;
}

template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Reductions over the 16 threads (one half-warp) that share a row.
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [r0, r0 + 64) of a row-major (n, d) matrix into a transposed tile
// dst[k * TS + r], k < DP; zero outside the n rows and d columns.
template <typename T, int DP>
__device__ void load_t(float* dst, const T* src, int r0, int n, int d) {
  for (int i = threadIdx.x; i < 64 * DP; i += NT) {
    const int r = i / DP, k = i % DP;
    float x = 0.f;
    if (r0 + r < n && k < d) x = to_f(src[(size_t)(r0 + r) * d + k]);
    dst[k * TS + r] = x;
  }
}

// The same rows into a row-major tile dst[r * DP + k].
template <typename T, int DP>
__device__ void load_r(float* dst, const T* src, int r0, int n, int d) {
  for (int i = threadIdx.x; i < 64 * DP; i += NT) {
    const int r = i / DP, k = i % DP;
    float x = 0.f;
    if (r0 + r < n && k < d) x = to_f(src[(size_t)(r0 + r) * d + k]);
    dst[i] = x;
  }
}

// acc[i][j] += sum_k a[k][ty*4 + i] * b[k][tx*4 + j] over k < DP, for two
// transposed tiles: a 64 x 64 product contracted over the head dimension.
template <int DP>
__device__ __forceinline__ void mm_tt(float (&acc)[4][4], const float* a,
                                      const float* b, int ty, int tx) {
#pragma unroll 8
  for (int k = 0; k < DP; ++k) {
    float x[4], y[4];
    load_w<4>(x, a + k * TS + ty * 4);
    load_w<4>(y, b + k * TS + tx * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
}

// acc[i][c] += sum_j p[j][ty*4 + i] * b[j][col(tx, c)] over j < 64: a
// transposed 64 x 64 tile times a row-major (64 x DP) tile.
template <int DP>
__device__ __forceinline__ void mm_tr(float (&acc)[4][DP / 16],
                                      const float* p, const float* b, int ty,
                                      int tx) {
  using C = Cols<DP>;
#pragma unroll 4
  for (int j = 0; j < 64; ++j) {
    float x[4], y[C::NC];
    load_w<4>(x, p + j * TS + ty * 4);
#pragma unroll
    for (int g = 0; g < C::G; ++g)
      load_w<C::W>(y + g * C::W, b + j * DP + g * 16 * C::W + tx * C::W);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < C::NC; ++c) acc[i][c] = fmaf(x[i], y[c], acc[i][c]);
  }
}

// Writes the rows [r0 + ty*4, +4) of a (64 x DP) accumulator, each divided
// by div[i] when div is not null, to a row-major (n, d) output; rows >= n
// and columns >= d are not written.
template <typename T, int DP>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[4][DP / 16],
                                           const float* div, int r0, int n,
                                           int d, int ty, int tx) {
  using C = Cols<DP>;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= n) continue;
#pragma unroll
    for (int c = 0; c < C::NC; ++c) {
      const int col = C::col(tx, c);
      if (col < d)
        dst[(size_t)r * d + col] =
            from_f<T>(div == nullptr ? acc[i][c] : acc[i][c] / div[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// K4a: forward. One block per (query tile, bh).
// ---------------------------------------------------------------------------

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ out,
               float* __restrict__ lse, int t_q, int t_k, int d, int causal) {
  using C = Cols<DP>;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;            // [DP][TS]
  float* kt = qt + DP * TS;    // [DP][TS]
  float* vr = kt + DP * TS;    // [BK][DP]
  float* pt = vr + BK * DP;    // [BK][TS]: p^T, rounded to T
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ;
  const size_t bh = blockIdx.y;
  q += bh * t_q * d;
  k += bh * t_k * d;
  v += bh * t_k * d;
  load_t<T, DP>(qt, q, q0, t_q, d);

  float m[4], l[4], acc[4][C::NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::NC; ++c) acc[i][c] = 0.f;
  }
  const int k_end = causal ? min(t_k, q0 + BQ) : t_k;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_t<T, DP>(kt, k, k0, t_k, d);
    load_r<T, DP>(vr, v, k0, t_k, d);
    __syncthreads();
    float s[4][4] = {};
    mm_tt<DP>(s, qt, kt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        if (kpos >= t_k || (causal && kpos > qpos)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum += p;
        pt[(tx * 4 + j) * TS + ty * 4 + i] = round_to<T>(p);
      }
      l[i] = l[i] * alpha + sum16(psum);
#pragma unroll
      for (int c = 0; c < C::NC; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();
    mm_tr<DP>(acc, pt, vr, ty, tx);
  }

  float den[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    den[i] = fmaxf(l[i], 1e-30f);
    const int r = q0 + ty * 4 + i;
    if (tx == 0 && r < t_q) lse[bh * t_q + r] = m[i] + logf(den[i]);
  }
  store_rows<T, DP>(out + bh * t_q * d, acc, den, q0, t_q, d, ty, tx);
}

// ---------------------------------------------------------------------------
// K4b: dq. One block per (query tile, bh), looping over key tiles.
// ---------------------------------------------------------------------------

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int t_q, int t_k, int d, int causal) {
  using C = Cols<DP>;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;             // [DP][TS]
  float* ot = qt + DP * TS;     // [DP][TS]: dO
  float* kt = ot + DP * TS;     // [DP][TS]
  float* vt = kt + DP * TS;     // [DP][TS]
  float* kr = vt + DP * TS;     // [BK][DP]
  float* st = kr + BK * DP;     // [BK][TS]: ds^T, rounded to T
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ;
  const size_t bh = blockIdx.y;
  q += bh * t_q * d;
  dout += bh * t_q * d;
  k += bh * t_k * d;
  v += bh * t_k * d;
  load_t<T, DP>(qt, q, q0, t_q, d);
  load_t<T, DP>(ot, dout, q0, t_q, d);

  float lse_i[4], delta_i[4], acc[4][C::NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    lse_i[i] = r < t_q ? lse[bh * t_q + r] : 0.f;
    delta_i[i] = r < t_q ? delta[bh * t_q + r] : 0.f;
#pragma unroll
    for (int c = 0; c < C::NC; ++c) acc[i][c] = 0.f;
  }
  const int k_end = causal ? min(t_k, q0 + BQ) : t_k;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_t<T, DP>(kt, k, k0, t_k, d);
    load_t<T, DP>(vt, v, k0, t_k, d);
    load_r<T, DP>(kr, k, k0, t_k, d);
    __syncthreads();
    float s[4][4] = {}, dov[4][4] = {};
    mm_tt<DP>(s, qt, kt, ty, tx);
    mm_tt<DP>(dov, ot, vt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        const bool valid =
            kpos < t_k && qpos < t_q && !(causal && kpos > qpos);
        const float p = valid ? expf(s[i][j] - lse_i[i]) : 0.f;
        st[(tx * 4 + j) * TS + ty * 4 + i] =
            round_to<T>(p * (dov[i][j] - delta_i[i]));
      }
    }
    __syncthreads();
    mm_tr<DP>(acc, st, kr, ty, tx);
  }
  store_rows<T, DP>(dq + bh * t_q * d, acc, nullptr, q0, t_q, d, ty, tx);
}

// ---------------------------------------------------------------------------
// K4c: dk and dv. One block per (key tile, bh), looping over query tiles;
// threads own key rows and query columns of the transposed scores.
// ---------------------------------------------------------------------------

template <typename T, int DP>
__global__ void __launch_bounds__(NT)
    dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, int t_q, int t_k, int d,
               int causal) {
  using C = Cols<DP>;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;             // [DP][TS]
  float* vt = kt + DP * TS;     // [DP][TS]
  float* qt = vt + DP * TS;     // [DP][TS]
  float* ot = qt + DP * TS;     // [DP][TS]: dO
  float* qr = ot + DP * TS;     // [BQ][DP]
  float* orr = qr + BQ * DP;    // [BQ][DP]: dO
  float* buf = orr + BQ * DP;   // [BQ][TS]: p^T, then ds^T, rounded to T
  float* ls = buf + BQ * TS;    // [BQ]: lse
  float* dl = ls + BQ;          // [BQ]: delta
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * BK;
  const size_t bh = blockIdx.y;
  q += bh * t_q * d;
  dout += bh * t_q * d;
  k += bh * t_k * d;
  v += bh * t_k * d;
  lse += bh * t_q;
  delta += bh * t_q;
  load_t<T, DP>(kt, k, k0, t_k, d);
  load_t<T, DP>(vt, v, k0, t_k, d);

  float dk_acc[4][C::NC], dv_acc[4][C::NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C::NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  // under causality, query tiles wholly before this key tile see none of it
  for (int q0 = causal ? k0 : 0; q0 < t_q; q0 += BQ) {
    __syncthreads();
    load_t<T, DP>(qt, q, q0, t_q, d);
    load_t<T, DP>(ot, dout, q0, t_q, d);
    load_r<T, DP>(qr, q, q0, t_q, d);
    load_r<T, DP>(orr, dout, q0, t_q, d);
    for (int i = threadIdx.x; i < BQ; i += NT) {
      ls[i] = q0 + i < t_q ? lse[q0 + i] : 0.f;
      dl[i] = q0 + i < t_q ? delta[q0 + i] : 0.f;
    }
    __syncthreads();
    float s[4][4] = {}, dov[4][4] = {};
    mm_tt<DP>(s, kt, qt, ty, tx);    // s[i][j] = k_(ty*4+i) . q_(tx*4+j)
    mm_tt<DP>(dov, vt, ot, ty, tx);  // dov[i][j] = v_(ty*4+i) . dO_(tx*4+j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kpos = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j, qpos = q0 + c;
        const bool valid =
            kpos < t_k && qpos < t_q && !(causal && kpos > qpos);
        const float p = valid ? expf(s[i][j] - ls[c]) : 0.f;
        s[i][j] = p * (dov[i][j] - dl[c]);  // ds
        buf[c * TS + ty * 4 + i] = round_to<T>(p);
      }
    }
    __syncthreads();
    mm_tr<DP>(dv_acc, buf, orr, ty, tx);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        buf[(tx * 4 + j) * TS + ty * 4 + i] = round_to<T>(s[i][j]);
    __syncthreads();
    mm_tr<DP>(dk_acc, buf, qr, ty, tx);
  }
  store_rows<T, DP>(dk + bh * t_k * d, dk_acc, nullptr, k0, t_k, d, ty, tx);
  store_rows<T, DP>(dv + bh * t_k * d, dv_acc, nullptr, k0, t_k, d, ty, tx);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
int prepare(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int DP>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               void* lse, int bh, int t_q, int t_k, int d, int causal,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * DP * TS + BK * DP + BK * TS);
  if (int e = prepare(fwd_kernel<T, DP>, smem)) return e;
  const dim3 grid((t_q + BQ - 1) / BQ, bh);
  fwd_kernel<T, DP><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (float*)lse, t_q, t_k,
      d, causal);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int t_q,
              int t_k, int d, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (4 * DP * TS + BK * DP + BK * TS);
  if (int e = prepare(dq_kernel<T, DP>, smem)) return e;
  const dim3 grid((t_q + BQ - 1) / BQ, bh);
  dq_kernel<T, DP><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq, t_q, t_k, d, causal);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               int bh, int t_q, int t_k, int d, int causal,
               cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (4 * DP * TS + 2 * BQ * DP + BQ * TS + 2 * BQ);
  if (int e = prepare(dkv_kernel<T, DP>, smem)) return e;
  const dim3 grid((t_k + BK - 1) / BK, bh);
  dkv_kernel<T, DP><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, t_q, t_k, d,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

// The head dimension d (<= 128) picks the padded tile width DP in
// {32, 64, 128} for the storage type T.
#define FLASH_DISPATCH_T(T, FN, ...)                                   \
  do {                                                                 \
    if (d < 1 || d > 128) return (int)cudaErrorInvalidValue;           \
    if (d <= 32) return FN<T, 32>(__VA_ARGS__);                        \
    if (d <= 64) return FN<T, 64>(__VA_ARGS__);                        \
    return FN<T, 128>(__VA_ARGS__);                                    \
  } while (0)

// dtype is kF32 or kBF16 (the forward); the backward takes kF32 only.
#define FLASH_DISPATCH(FN, ...)                                        \
  do {                                                                 \
    if (dtype == kF32) FLASH_DISPATCH_T(float, FN, __VA_ARGS__);       \
    if (dtype == kBF16) FLASH_DISPATCH_T(__nv_bfloat16, FN, __VA_ARGS__); \
    return (int)cudaErrorInvalidValue;                                 \
  } while (0)
#define FLASH_DISPATCH_F32(FN, ...)                                    \
  do {                                                                 \
    if (dtype == kF32) FLASH_DISPATCH_T(float, FN, __VA_ARGS__);       \
    return (int)cudaErrorInvalidValue;                                 \
  } while (0)

// Each entry point returns cudaGetLastError() after its launch.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int bh, int t_q, int t_k, int d,
                                   int causal, int dtype, void* stream) {
  FLASH_DISPATCH(launch_fwd, q, k, v, out, lse, bh, t_q, t_k, d, causal,
                 (cudaStream_t)stream);
}

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int bh, int t_q, int t_k,
                                      int d, int causal, int dtype,
                                      void* stream) {
  FLASH_DISPATCH_F32(launch_dq, q, k, v, dout, lse, delta, dq, bh, t_q, t_k,
                     d, causal, (cudaStream_t)stream);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int bh, int t_q,
                                       int t_k, int d, int causal, int dtype,
                                       void* stream) {
  FLASH_DISPATCH_F32(launch_dkv, q, k, v, dout, lse, delta, dk, dv, bh, t_q,
                     t_k, d, causal, (cudaStream_t)stream);
}
