// Fused log-mel front-end for Hopper (sm_90a).
//
// Replaces the TPU kernel `_mel_kernel` of audio_transformers_tpu/ops/
// mel_pallas.py (`log_mel_pallas`). Input: the centre-padded waveform
// (B, N) float32. Output: (B, T, n_mels) float32 = log10(max(mel, 1e-10))
// (log_mode 2), log(mel + 1e-9) (log_mode 1) or mel (log_mode 0), where
// mel = |rDFT(window * frame)|^2 @ filterbank.
//
// One block per (tile of TF frames, clip). The waveform span of the tile
// is staged in shared memory; each thread owns one frequency and keeps
// the real and imaginary sums of all TF frames in registers, so one load
// of a windowed-basis value feeds 2*TF FMAs. The tile's power spectrum
// stays in shared memory for the filterbank product. Everything is
// float32 FMA (no tensor cores): the reference's "highest" precision.

#include <cuda_runtime.h>

#define TF 16  // frames per block (TILE_FRAMES in ops/mel_cuda.py)

__global__ void __launch_bounds__(256)
mel_kernel(const float* __restrict__ wav, const float* __restrict__ wcos,
           const float* __restrict__ wsin, const float* __restrict__ fb,
           float* __restrict__ out, int n, int t_total, int n_fft, int hop,
           int n_freqs, int n_mels, int use_sqrt, int log_mode) {
  extern __shared__ float smem[];
  const int span = (TF - 1) * hop + n_fft;
  float* xs = smem;          // span samples
  float* pw = smem + span;   // TF * n_freqs power values

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TF;
  const float* w = wav + (size_t)b * n;
  const long base = (long)t0 * hop;
  for (int i = threadIdx.x; i < span; i += blockDim.x) {
    const long s = base + i;
    xs[i] = s < n ? w[s] : 0.f;
  }
  __syncthreads();

  for (int f = threadIdx.x; f < n_freqs; f += blockDim.x) {
    float re[TF], im[TF];
#pragma unroll
    for (int j = 0; j < TF; ++j) {
      re[j] = 0.f;
      im[j] = 0.f;
    }
    for (int k = 0; k < n_fft; ++k) {
      const float c = __ldg(wcos + (size_t)k * n_freqs + f);
      const float s = __ldg(wsin + (size_t)k * n_freqs + f);
#pragma unroll
      for (int j = 0; j < TF; ++j) {
        const float x = xs[j * hop + k];
        re[j] = fmaf(x, c, re[j]);
        im[j] = fmaf(x, s, im[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < TF; ++j) {
      float p = re[j] * re[j] + im[j] * im[j];
      if (use_sqrt) p = sqrtf(p);
      pw[j * n_freqs + f] = p;
    }
  }
  __syncthreads();

  const int frames = min(TF, t_total - t0);
  for (int o = threadIdx.x; o < frames * n_mels; o += blockDim.x) {
    const int j = o / n_mels;
    const int m = o - j * n_mels;
    const float* pj = pw + j * n_freqs;
    float acc = 0.f;
    for (int f = 0; f < n_freqs; ++f)
      acc = fmaf(pj[f], __ldg(fb + (size_t)f * n_mels + m), acc);
    float r = acc;
    if (log_mode == 2)
      r = log10f(fmaxf(acc, 1e-10f));
    else if (log_mode == 1)
      r = logf(acc + 1e-9f);
    out[((size_t)b * t_total + t0 + j) * n_mels + m] = r;
  }
}

extern "C" int log_mel_f32(const void* wav, const void* wcos,
                           const void* wsin, const void* fb, void* out,
                           int batch, int n, int t_total, int n_fft, int hop,
                           int n_mels, int use_sqrt, int log_mode,
                           void* stream) {
  const int n_freqs = n_fft / 2 + 1;
  const size_t smem =
      sizeof(float) * ((TF - 1) * hop + n_fft + TF * n_freqs);
  dim3 grid((t_total + TF - 1) / TF, batch);
  mel_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
      (const float*)wav, (const float*)wcos, (const float*)wsin,
      (const float*)fb, (float*)out, n, t_total, n_fft, hop, n_freqs, n_mels,
      use_sqrt, log_mode);
  return (int)cudaGetLastError();
}
