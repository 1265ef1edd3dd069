// Fused log-mel front-end for Hopper (sm_90a): a real FFT in shared
// memory, a sparse filterbank, the waveform read once.
//
// Replaces the TPU kernel `_mel_kernel` of audio_transformers_tpu/ops/
// mel_pallas.py (`log_mel_pallas`), which frames the waveform as
// row-shifted matmuls against dense windowed cos/sin bases. Input: the
// caller's (B, n) float32 waveform, unpadded. Output: (B, T, n_mels)
// float32 = log10(max(mel, 1e-10)) (log_mode 2), log(mel + 1e-9)
// (log_mode 1) or mel (log_mode 0), where mel = |rFFT(window * frame)|^p
// summed over each band's filterbank weights (p = 2, or 1 with use_sqrt).
//
// Bound on the H100: memory. The function needs about 6 kFLOP per frame
// (window, FFT, power, the filterbank's nonzeros) against 4 * hop bytes of
// waveform in and 4 * n_mels bytes out, far below the card's ridge line:
// at whisper's 30 s window and B = 16, 46 MB over 3.35 TB/s = 0.0138 ms.
// What the design does about it:
//  - Each block takes `fpb` consecutive frames of one clip (the plan in
//    ops/mel_cuda.py: enough blocks to fill the card at B = 1) and copies
//    their waveform span into shared memory once, with 16-byte cp.async
//    where a chunk lies inside the clip. The centre reflect pad and the
//    zero-pad of clips no longer than n_fft are index arithmetic on that
//    load, so no padded copy of the waveform is ever written; an unaligned
//    row start shifts the staging by up to 3 floats.
//  - The FFT replaces the dense DFT's n_fft multiply-adds per bin. Two
//    frames form one complex signal (a + ib), split after the transform
//    by conjugate symmetry. A float32 FFT's rounding scales with the norm
//    of its whole input, so each frame's windowed energy is reduced first
//    and the quieter frame of a pair is scaled by a power of two, 2^e,
//    that brings the two energies within a factor of 4 (exact in float32);
//    its power is scaled back by 2^-2e after the split. Each frame's
//    rounding then scales with its own energy, not its partner's, and a
//    frame of zero energy gets power exactly 0. N = R1 * R2 runs as two
//    passes over shared memory: R2 threads per pair each do an R1-point
//    DFT in registers (strided input, the Hann window and the balance
//    applied on the load) and the inter-pass twiddle (a float32 table the wrapper makes in float64 and
//    uploads once), then R1 threads per pair each do an R2-point DFT in
//    place along their row. The in-register DFTs are mixed radix (2, 3,
//    4, 5); their roots ride in the launch's parameters. The pass buffer's
//    row stride is odd, so the transposing reads are free of bank
//    conflicts. Three blocks share an SM (at most 80 registers a thread).
//  - The filterbank sums each band's [lo, lo + cnt) bins only, in
//    ascending order: the skipped terms are exact zeros, so the sum has
//    the bits of the dense FMA sum in the same order. A thread sums one
//    band for 8 frames at once, so a weight's load feeds 8 FMAs.
//  - One launch per call; the output is written once, coalesced.
// Everything is float32 FMA (no tensor cores), for both precision names.

#include <cuda_runtime.h>
#include <stdint.h>

#define MEL_THREADS 256
#define MEL_FPT 8        // frames per thread in the filterbank
#define MEL_MAX_FRAMES 16  // frames per block at most (mel_cuda.MAX_FRAMES)

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(fmaf(a.x, w.x, -a.y * w.y), fmaf(a.x, w.y, a.y * w.x));
}
// -i * a
__device__ __forceinline__ float2 mul_mi(float2 a) {
  return make_float2(a.y, -a.x);
}

// 2^k for -126 <= k <= 127, exactly
__device__ __forceinline__ float exp2i(int k) {
  return __int_as_float((127 + k) << 23);
}

// The balance of a frame pair of windowed energies (ea, eb): the exponents
// (sa, sb), at most one of them nonzero, by which the quieter frame is
// scaled up so that the two energies lie within a factor of 4 (2^(2 s)
// with s = floor(d / 2), d the difference of their binary exponents; at
// most 2^63, which balances any ratio up to 2^127). No scale when either
// frame has no energy: its power is set to 0 and the other's FFT has no
// partner.
__device__ __forceinline__ int2 balance(float ea, float eb) {
  if (!(ea > 0.f) || !(eb > 0.f)) return make_int2(0, 0);
  const int d = ilogbf(ea) - ilogbf(eb);
  const int s = min(abs(d) >> 1, 63);
  return d > 0 ? make_int2(0, s) : make_int2(s, 0);
}

// The in-register split of a DFT of R points: R = A * (R / A). 2, 3, 4 and
// 5 are computed directly (A = R); the FFT plan's emulation in
// tests/test_torch_kernels.py mirrors this rule.
template <int R>
struct Split {
  static constexpr int A = (R == 2 || R == 3 || R == 4 || R == 5) ? R
                           : R % 4 == 0                          ? 4
                           : R % 5 == 0                          ? 5
                           : R % 3 == 0                          ? 3
                                                                 : 2;
};

// Where the in-place DFT of R points leaves X[k] in its register array:
// a composite R = A * B leaves X[k1 + A * k2] at B * k1 + pos<B>(k2).
template <int R>
__host__ __device__ constexpr int pos(int k) {
  if constexpr (Split<R>::A == R) {
    return k;
  } else {
    constexpr int A = Split<R>::A, B = R / A;
    return B * (k % A) + pos<B>(k / A);
  }
}

// Forward DFT (e^{-2 pi i n k / R}) of v in place; X[k] ends in
// v[pos<R>(k)]. `tw` holds e^{-2 pi i q / RT} for q < RT, RT a multiple
// of R; every index into it is a constant once the loops are unrolled.
template <int R, int RT>
__device__ __forceinline__ void dft(float2 (&v)[R], const float2* tw) {
  if constexpr (R == 2) {
    const float2 a = v[0], b = v[1];
    v[0] = cadd(a, b);
    v[1] = csub(a, b);
  } else if constexpr (R == 3) {
    const float c = -0.5f, s = 0.8660254037844386f;
    const float2 a = cadd(v[1], v[2]), d = csub(v[1], v[2]);
    const float2 m = make_float2(fmaf(c, a.x, v[0].x), fmaf(c, a.y, v[0].y));
    const float2 r = make_float2(s * d.y, -s * d.x);  // -i s d
    v[0] = cadd(v[0], a);
    v[1] = cadd(m, r);
    v[2] = csub(m, r);
  } else if constexpr (R == 4) {
    const float2 s0 = cadd(v[0], v[2]), d0 = csub(v[0], v[2]);
    const float2 s1 = cadd(v[1], v[3]), d1 = mul_mi(csub(v[1], v[3]));
    v[0] = cadd(s0, s1);
    v[2] = csub(s0, s1);
    v[1] = cadd(d0, d1);
    v[3] = csub(d0, d1);
  } else if constexpr (R == 5) {
    const float c1 = 0.30901699437494745f, c2 = -0.8090169943749473f;
    const float s1 = 0.9510565162951535f, s2 = 0.5877852522924732f;
    const float2 a1 = cadd(v[1], v[4]), b1 = csub(v[1], v[4]);
    const float2 a2 = cadd(v[2], v[3]), b2 = csub(v[2], v[3]);
    const float2 x0 = v[0];
    // m1 = x0 + c1 a1 + c2 a2, m2 = x0 + c2 a1 + c1 a2
    const float2 m1 = make_float2(fmaf(c2, a2.x, fmaf(c1, a1.x, x0.x)),
                                  fmaf(c2, a2.y, fmaf(c1, a1.y, x0.y)));
    const float2 m2 = make_float2(fmaf(c1, a2.x, fmaf(c2, a1.x, x0.x)),
                                  fmaf(c1, a2.y, fmaf(c2, a1.y, x0.y)));
    // r1 = -i (s1 b1 + s2 b2), r2 = -i (s2 b1 - s1 b2)
    const float2 r1 = mul_mi(make_float2(fmaf(s2, b2.x, s1 * b1.x),
                                         fmaf(s2, b2.y, s1 * b1.y)));
    const float2 r2 = mul_mi(make_float2(fmaf(-s1, b2.x, s2 * b1.x),
                                         fmaf(-s1, b2.y, s2 * b1.y)));
    v[0] = cadd(x0, cadd(a1, a2));
    v[1] = cadd(m1, r1);
    v[4] = csub(m1, r1);
    v[2] = cadd(m2, r2);
    v[3] = csub(m2, r2);
  } else {
    // n = n2 + B n1, k = k1 + A k2: an A-point DFT down each of the B
    // columns, the twiddle W_R^(n2 k1), a B-point DFT along each row.
    constexpr int A = Split<R>::A, B = R / A;
#pragma unroll
    for (int n2 = 0; n2 < B; ++n2) {
      float2 u[A];
#pragma unroll
      for (int n1 = 0; n1 < A; ++n1) u[n1] = v[n2 + B * n1];
      dft<A, RT>(u, tw);
#pragma unroll
      for (int k1 = 0; k1 < A; ++k1) {
        float2 x = u[pos<A>(k1)];
        if (n2 > 0 && k1 > 0) x = cmul(x, tw[((n2 * k1) % R) * (RT / R)]);
        v[n2 + B * k1] = x;
      }
    }
#pragma unroll
    for (int k1 = 0; k1 < A; ++k1) {
      float2 u[B];
#pragma unroll
      for (int n2 = 0; n2 < B; ++n2) u[n2] = v[B * k1 + n2];
      dft<B, RT>(u, tw);
#pragma unroll
      for (int m = 0; m < B; ++m) v[B * k1 + m] = u[m];
    }
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Shared memory of a block: region one, from float 0, holds the waveform
// span (plus up to 3 floats of realignment), later the power spectra (fpb
// rows of PS floats); region two, from float `off2`, the pass buffer (P *
// R1 rows of YS complex), which pass two overwrites in place with the FFT.
// The wrapper lays it out (`mel_layout` in ops/mel_cuda.py) and passes
// `off2` and the size; the kernel only takes the row strides.

// The in-register DFTs' roots, e^{-2 pi i q / R} for q < R, made in float64
// by the wrapper. They ride in the launch's parameters, so the DFTs read
// them as constant-bank operands: no registers, no loads.
template <int R1, int R2>
struct Roots {
  float2 r1[R1];
  float2 r2[R2];
};

template <int R1, int R2>
__global__ void __launch_bounds__(MEL_THREADS, 3)
mel_kernel(const float* __restrict__ wav, const float* __restrict__ win,
           const __grid_constant__ Roots<R1, R2> rt,
           const float2* __restrict__ ptw, const float* __restrict__ fbw,
           const int* __restrict__ band, float* __restrict__ out, int n,
           int t_total, int hop, int pad, int n_mels, int fpb, int off2,
           int use_sqrt, int log_mode) {
  constexpr int N = R1 * R2;
  constexpr int YS = R2 | 1;      // odd: the transposing reads are free
  constexpr int PS = N / 2 + 1;   // of bank conflicts
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                                     // span
  float* pw = smem;                                     // power
  float2* ys = reinterpret_cast<float2*>(smem + off2);  // pass buffer

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * fpb;
  const int nf = min(fpb, t_total - t0);
  const int np = (nf + 1) / 2;
  const int span = (nf - 1) * hop + N;

  // 1. The span: padded positions [t0 hop, t0 hop + span) are raw samples
  // j = position - pad, reflected at the ends of the clip's length (n, or
  // N + 1 for a clip no longer than N, whose tail past n is zeros). xs[s]
  // holds raw index j0 - mis + s, so 16-byte chunks of the row land on
  // 16-byte boundaries of xs.
  const float* row = wav + (size_t)b * n;
  const long j0 = (long)t0 * hop - pad;
  const int mis = (int)((((uintptr_t)row >> 2) + (uintptr_t)j0) & 3);
  const long len = n > N ? n : N + 1;
  const int nchunk = (span + mis + 3) >> 2;
  for (int q = tid; q < nchunk; q += MEL_THREADS) {
    const long j = j0 - mis + 4L * q;
    float* dst = xs + 4 * q;
    if (j >= 0 && j + 4 <= n) {
      cp_async16(dst, row + j);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int s = 4 * q + r;
        if (s < mis || s >= span + mis) continue;
        long jj = j + r;
        if (jj < 0)
          jj = -jj;
        else if (jj >= len)
          jj = 2 * (len - 1) - jj;
        dst[r] = jj < n ? row[jj] : 0.f;
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. Each frame's windowed energy, a warp a frame; it only picks the
  // pair's balance below, so its own rounding does not matter.
  __shared__ float energy[MEL_MAX_FRAMES];
  // per pair, what step 5 multiplies each frame's power (or magnitude)
  // by: the balance's scale taken out, or 0 for a frame of zero energy
  __shared__ float2 unscale[MEL_MAX_FRAMES / 2];
  {
    const int warp = tid >> 5, lane = tid & 31;
    for (int f = warp; f < nf; f += MEL_THREADS / 32) {
      const float* xf = xs + mis + f * hop;
      float acc = 0.f;
      for (int k = lane; k < N; k += 32) {
        const float y = xf[k] * __ldg(win + k);
        acc = fmaf(y, y, acc);
      }
#pragma unroll
      for (int o = 16; o; o >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) energy[f] = acc;
    }
  }
  __syncthreads();

  // 3. Pass one: for pair p (frames 2p, 2p + 1) and column n2, an R1-point
  // DFT of z[n2 + R2 n1] = w (x_a + i x_b), times W_N^(n2 k1), stored as
  // row k1 of the pair's pass buffer; the quieter frame times 2^s (the
  // pair's thread of column 0 records what undoes it in step 5).
  for (int it = tid; it < np * R2; it += MEL_THREADS) {
    const int p = it / R2, n2 = it - p * R2;
    const float* xa = xs + mis + 2 * p * hop;
    const bool has_b = 2 * p + 1 < nf;
    const float ea = energy[2 * p], eb = has_b ? energy[2 * p + 1] : 0.f;
    const int2 sc = balance(ea, eb);
    const float sa = exp2i(sc.x), sb = exp2i(sc.y);
    if (n2 == 0) {
      const int k = use_sqrt ? 1 : 2;
      unscale[p] = make_float2(ea > 0.f ? exp2i(-k * sc.x) : 0.f,
                               eb > 0.f ? exp2i(-k * sc.y) : 0.f);
    }
    float2 v[R1];
#pragma unroll
    for (int n1 = 0; n1 < R1; ++n1) {
      const int k = n2 + R2 * n1;
      const float w = __ldg(win + k);
      v[n1] = make_float2(xa[k] * w * sa,
                          has_b ? xa[hop + k] * w * sb : 0.f);
    }
    dft<R1, R1>(v, rt.r1);
    float2* y = ys + p * R1 * YS + n2;
#pragma unroll
    for (int k1 = 0; k1 < R1; ++k1) {
      float2 x = v[pos<R1>(k1)];
      if (k1 > 0) x = cmul(x, __ldg(ptw + k1 * R2 + n2));
      y[k1 * YS] = x;
    }
  }
  __syncthreads();

  // 4. Pass two: for pair p and row k1, an R2-point DFT along the row, in
  // place: row k1 then holds Z[k1 + R1 k2] at column k2.
  for (int it = tid; it < np * R1; it += MEL_THREADS) {
    float2* y = ys + it * YS;
    float2 u[R2];
#pragma unroll
    for (int n2 = 0; n2 < R2; ++n2) u[n2] = y[n2];
    dft<R2, R2>(u, rt.r2);
#pragma unroll
    for (int k2 = 0; k2 < R2; ++k2) y[k2] = u[pos<R2>(k2)];
  }
  __syncthreads();

  // 5. The two frames' spectra from Z[k] and Z[N - k]: A = (Z[k] +
  // conj Z[N-k]) / 2, B = (Z[k] - conj Z[N-k]) / 2i; their power (or
  // magnitude), the balance's scale taken out, overwrites the span; a
  // frame of zero energy gets exactly 0.
  constexpr int NF = N / 2 + 1;
  for (int it = tid; it < np * NF; it += MEL_THREADS) {
    const int p = it / NF, k = it - p * NF;
    const int km = k == 0 ? 0 : N - k;
    const float2* zp = ys + p * R1 * YS;
    const float2 zk = zp[(k % R1) * YS + k / R1];
    const float2 zm = zp[(km % R1) * YS + km / R1];
    const float ar = 0.5f * (zk.x + zm.x), ai = 0.5f * (zk.y - zm.y);
    const float br = 0.5f * (zk.y + zm.y), bi = 0.5f * (zm.x - zk.x);
    float pa = fmaf(ar, ar, ai * ai), pb = fmaf(br, br, bi * bi);
    if (use_sqrt) {
      pa = sqrtf(pa);
      pb = sqrtf(pb);
    }
    const float2 us = unscale[p];
    pw[2 * p * PS + k] = pa * us.x;
    if (2 * p + 1 < nf) pw[(2 * p + 1) * PS + k] = pb * us.y;
  }
  __syncthreads();

  // 6. The filterbank: a thread takes one band and MEL_FPT frames, so each
  // weight it reads serves MEL_FPT independent sums; each sum runs over
  // the band's bins in ascending order. Then the log and the store
  // (neighbouring threads, neighbouring bands).
  const int nq = (nf + MEL_FPT - 1) / MEL_FPT;
  for (int it = tid; it < nq * n_mels; it += MEL_THREADS) {
    const int q = it / n_mels, m = it - q * n_mels;
    const int f0 = q * MEL_FPT;
    const int lo = __ldg(band + m), cnt = __ldg(band + n_mels + m);
    const float* wm = fbw + __ldg(band + 2 * n_mels + m);
    const float* rows[MEL_FPT];
    float acc[MEL_FPT];
#pragma unroll
    for (int j = 0; j < MEL_FPT; ++j) {
      rows[j] = pw + min(f0 + j, nf - 1) * PS + lo;
      acc[j] = 0.f;
    }
    for (int i = 0; i < cnt; ++i) {
      const float w = __ldg(wm + i);
#pragma unroll
      for (int j = 0; j < MEL_FPT; ++j) acc[j] = fmaf(rows[j][i], w, acc[j]);
    }
#pragma unroll
    for (int j = 0; j < MEL_FPT; ++j) {
      if (f0 + j >= nf) break;
      float r = acc[j];
      if (log_mode == 2)
        r = log10f(fmaxf(r, 1e-10f));
      else if (log_mode == 1)
        r = logf(r + 1e-9f);
      out[((size_t)b * t_total + t0 + f0 + j) * n_mels + m] = r;
    }
  }
}

template <int R1, int R2>
static int launch(const float* wav, const float* win, const float* roots,
                  const float2* ptw, const float* fbw, const int* band,
                  float* out, int batch, int n, int t_total, int hop, int pad,
                  int n_mels, int fpb, int off2, int smem, int use_sqrt,
                  int log_mode, cudaStream_t stream) {
  Roots<R1, R2> rt;
  for (int q = 0; q < R1; ++q)
    rt.r1[q] = make_float2(roots[2 * q], roots[2 * q + 1]);
  for (int q = 0; q < R2; ++q)
    rt.r2[q] = make_float2(roots[2 * (R1 + q)], roots[2 * (R1 + q) + 1]);
  if (fpb < 1 || fpb > MEL_MAX_FRAMES) return (int)cudaErrorInvalidValue;
  auto* kernel = mel_kernel<R1, R2>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((t_total + fpb - 1) / fpb, batch);
  kernel<<<grid, MEL_THREADS, smem, stream>>>(wav, win, rt, ptw, fbw, band,
                                              out, n, t_total, hop, pad,
                                              n_mels, fpb, off2, use_sqrt,
                                              log_mode);
  return (int)cudaGetLastError();
}

// n_fft -> (R1, R2); FFT_SPLITS in ops/mel_cuda.py. `roots` is a host
// array: the R1 roots, then the R2 roots, as (re, im) float32 pairs.
extern "C" int log_mel_f32(const void* wav, const void* win,
                           const void* roots, const void* ptw,
                           const void* fbw, const void* band, void* out,
                           int batch, int n, int t_total, int n_fft, int hop,
                           int pad, int n_mels, int fpb, int off2,
                           int smem, int use_sqrt, int log_mode,
                           void* stream) {
#define MEL_ARGS                                                            \
  (const float*)wav, (const float*)win, (const float*)roots,               \
      (const float2*)ptw, (const float*)fbw, (const int*)band, (float*)out, \
      batch, n, t_total, hop, pad, n_mels, fpb, off2, smem, use_sqrt,       \
      log_mode, (cudaStream_t)stream
  switch (n_fft) {
    case 400:  // whisper
      return launch<16, 25>(MEL_ARGS);
    case 1024:  // UrbanSound
      return launch<32, 32>(MEL_ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MEL_ARGS
}
