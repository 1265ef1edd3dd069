// Single-query cross-attention for one decode step, Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` of audio_transformers_tpu/ops/
// decode_attention.py (`decode_cross_attention`). q (BH, hd); k and v in
// the time-minor layout (BH, hd, T); out (BH, hd). Modes:
//   none: k, v float32 or bf16
//   int8: k, v int8 with k_scale (BH, T) folded into the logit row and
//         v_scale (BH, hd) into the output row; q and p stay float32.
//
// One block per (b, h). Pass 1: each thread scores keys t = tid, tid+256,
// ... against q (held in shared memory); for a fixed channel d the threads
// of a warp read k[d, t..t+31], contiguous in the time-minor layout. The
// scores go to shared memory, then a block max, exp and block sum give
// the softmax. Pass 2: each warp owns channels d = warp, warp+8, ... and
// its lanes stride over t, again reading v[d, t..t+31] contiguously; a
// warp sum finishes the channel. Keys at t >= t_valid are never read.

#include "common.cuh"

template <typename QT, typename KT>
__global__ void __launch_bounds__(256)
dca_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
           const KT* __restrict__ v, const float* __restrict__ k_scale,
           const float* __restrict__ v_scale, QT* __restrict__ out, int hd,
           int t_len, int t_valid, float scale) {
  extern __shared__ float sm[];
  float* qs = sm;                // hd
  float* red = sm + hd;          // 32
  float* p = red + 32;           // t_valid

  const int bh = blockIdx.x;
  const KT* kb = k + (size_t)bh * hd * t_len;
  const KT* vb = v + (size_t)bh * hd * t_len;
  for (int d = threadIdx.x; d < hd; d += blockDim.x)
    qs[d] = to_f(q[(size_t)bh * hd + d]);
  __syncthreads();

  float lmax = -INFINITY;
  for (int t = threadIdx.x; t < t_valid; t += blockDim.x) {
    float s = 0.f;
#pragma unroll 8
    for (int d = 0; d < hd; ++d) s = fmaf(qs[d], to_f(kb[(size_t)d * t_len + t]), s);
    if (k_scale != nullptr) s *= k_scale[(size_t)bh * t_len + t];
    s *= scale;
    p[t] = s;
    lmax = fmaxf(lmax, s);
  }
  const float m = block_max(lmax, red);
  float lsum = 0.f;
  for (int t = threadIdx.x; t < t_valid; t += blockDim.x) {
    const float e = expf(p[t] - m);
    p[t] = e;
    lsum += e;
  }
  const float l = block_sum(lsum, red);  // also orders the p writes

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int d = warp; d < hd; d += nwarps) {
    const KT* vd = vb + (size_t)d * t_len;
    float acc = 0.f;
    for (int t = lane; t < t_valid; t += 32) acc = fmaf(p[t], to_f(vd[t]), acc);
    acc = warp_sum(acc);
    if (lane == 0) {
      float o = acc / fmaxf(l, 1e-30f);
      if (v_scale != nullptr) o *= v_scale[(size_t)bh * hd + d];
      out[(size_t)bh * hd + d] = from_f<QT>(o);
    }
  }
}

template <typename QT, typename KT>
static int launch(const void* q, const void* k, const void* v,
                  const void* ks, const void* vs, void* out, int bh, int hd,
                  int t_len, int t_valid, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (hd + 32 + t_valid);
  dca_kernel<QT, KT><<<bh, 256, smem, stream>>>(
      (const QT*)q, (const KT*)k, (const KT*)v, (const float*)ks,
      (const float*)vs, (QT*)out, hd, t_len, t_valid, scale);
  return (int)cudaGetLastError();
}

template <typename QT>
static int dispatch_kv(int kv_dtype, const void* q, const void* k,
                       const void* v, const void* ks, const void* vs,
                       void* out, int bh, int hd, int t_len, int t_valid,
                       float scale, cudaStream_t stream) {
  switch (kv_dtype) {
    case kF32:
      return launch<QT, float>(q, k, v, ks, vs, out, bh, hd, t_len, t_valid,
                               scale, stream);
    case kBF16:
      return launch<QT, __nv_bfloat16>(q, k, v, ks, vs, out, bh, hd, t_len,
                                       t_valid, scale, stream);
    case kI8:
      return launch<QT, int8_t>(q, k, v, ks, vs, out, bh, hd, t_len, t_valid,
                                scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// k_scale and v_scale are null in mode none. Returns cudaGetLastError().
extern "C" int decode_cross_attention(const void* q, const void* k,
                                      const void* v, const void* k_scale,
                                      const void* v_scale, void* out, int bh,
                                      int hd, int t_len, int t_valid,
                                      float scale, int q_dtype, int kv_dtype,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (q_dtype == kF32)
    return dispatch_kv<float>(kv_dtype, q, k, v, k_scale, v_scale, out, bh,
                              hd, t_len, t_valid, scale, s);
  if (q_dtype == kBF16)
    return dispatch_kv<__nv_bfloat16>(kv_dtype, q, k, v, k_scale, v_scale,
                                      out, bh, hd, t_len, t_valid, scale, s);
  return (int)cudaErrorInvalidValue;
}
