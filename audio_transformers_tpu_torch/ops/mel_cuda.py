"""Fused log-mel front-end as a hand-written CUDA kernel (`csrc/mel.cu`).

Replaces the TPU kernel `log_mel_pallas` (`audio_transformers_tpu/ops/
mel_pallas.py`, `_mel_kernel`): framing, Hann window, |rFFT|^2, mel
filterbank and the log10 clamp in one launch, reading the caller's
waveform once and writing the (B, T, n_mels) features once.

Design (details in the source's note): one block per (clip, run of
`mel_plan` frames). The block stages its waveform span in shared memory
with 16-byte `cp.async`, doing the centre reflect pad and the zero-pad of
short clips by index arithmetic on the load, so the CUDA path never calls
`prepare_waveform`. Two frames form one complex signal; a two-pass
mixed-radix FFT (`fft_plan`: N = R1 * R2, each pass an in-register DFT
per thread) runs in shared memory, the spectra are split by conjugate
symmetry, and each mel band sums only its own bins (`mel_bands`).

Bound on the H100: memory (the waveform read once, the features written
once); the function needs about 6 kFLOP per frame, far below the card's
ridge line.

Both `precision` names of the reference ("highest" and "high") compute
in full float32 FMA here; the float32 FFT's rounding grows as log N,
below the dense sum's. Pairing two frames makes a bin's rounding scale
with the pair's energy: a silent frame beside a loud one (the zero
padding after a short clip's end) gets an absolute error that `log(mel +
1e-9)` turns into a relative one. `pair_error_bound` states how far that
can go. Whisper's cross-frame floor, (x+4)/4 and the frame drop run as
plain PyTorch after the kernel, as in the TPU version.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from audio_transformers_tpu_torch.core.config import MelConfig
from audio_transformers_tpu_torch.ops import _build
from audio_transformers_tpu_torch.ops.mel import (hann_window,
                                                  log_mel_torch,
                                                  mel_filter_bank,
                                                  prepare_waveform,
                                                  whisper_floor)

# n_fft -> (R1, R2), the two passes of the FFT, for whisper's and
# UrbanSound's presets; the kernel is instantiated for exactly these (the
# switch in `log_mel_f32`)
FFT_SPLITS = {400: (16, 25), 1024: (32, 32)}
MAX_FRAMES = 16           # frames per block at most
# shared memory the plan lets a block take, so that 3 fit on an SM; above
# 48 KB the launcher opts in (cudaFuncSetAttribute)
_SMEM_LIMIT = 74 * 1024
_LOG_MODES = {"none": 0, "log_eps": 1, "whisper": 2}
# a bin's rounding error in the kernel's float32 FFT of a frame pair, in
# units of u * log2(n_fft) * ||pair||_2 (u = 2^-24): the numpy emulation
# of the kernel's two passes (tests/test_torch_kernels.py) reaches 0.66;
# 4 leaves a factor of 6
FFT_ERR = 4.0
LOG_EPS = 1e-9
# wav, win, roots (host), ptw, fbw, band, out; batch, n, t_total, n_fft,
# hop, pad, n_mels, fpb, off2, smem, use_sqrt, log_mode; stream
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12 + [ctypes.c_void_p]


def fft_plan(n_fft: int) -> Tuple[int, int]:
    """(R1, R2) with R1 * R2 = n_fft: pass one does R1-point DFTs, pass
    two R2-point ones. Raises for an n_fft the kernel does not take."""
    if n_fft not in FFT_SPLITS:
        raise ValueError(f"mel kernel: no FFT plan for n_fft={n_fft} "
                         f"(takes {sorted(FFT_SPLITS)})")
    return FFT_SPLITS[n_fft]


def fft_tables(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """(roots, ptw) as complex64, made in float64: roots = e^{-2 pi i q /
    R1} for q < R1, then e^{-2 pi i q / R2} for q < R2 (the in-register
    DFTs' twiddles, passed in each launch's parameters), and ptw[k1 * R2 +
    n2] = e^{-2 pi i n2 k1 / N} (the twiddle between the passes, uploaded
    once)."""
    r1, r2 = fft_plan(n_fft)
    roots = np.concatenate([np.exp(-2j * np.pi * np.arange(r) / r)
                            for r in (r1, r2)])
    k1, n2 = np.meshgrid(np.arange(r1), np.arange(r2), indexing="ij")
    ptw = np.exp(-2j * np.pi * (k1 * n2).ravel() / n_fft)
    return roots.astype(np.complex64), ptw.astype(np.complex64)


def mel_bands(fb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The filterbank (n_freqs, n_mels) as each band's bin range: (band,
    weights), band = int32 [lo (n_mels), cnt (n_mels), offset (n_mels)],
    band m's weights fb[lo:lo + cnt, m] at weights[offset:offset + cnt]."""
    n_mels = fb.shape[1]
    lo = np.zeros(n_mels, np.int32)
    cnt = np.zeros(n_mels, np.int32)
    off = np.zeros(n_mels, np.int32)
    weights = []
    total = 0
    for m in range(n_mels):
        nz = np.nonzero(fb[:, m])[0]
        if len(nz):
            lo[m], cnt[m] = nz[0], nz[-1] + 1 - nz[0]
        off[m] = total
        weights.append(fb[lo[m]:lo[m] + cnt[m], m])
        total += int(cnt[m])
    return (np.concatenate([lo, cnt, off]),
            np.concatenate(weights).astype(np.float32))


def mel_layout(fpb: int, hop: int, n_fft: int) -> Tuple[int, int]:
    """(off2, nbytes): the shared memory of a block of `fpb` frames, which
    the kernel takes as given. Region one, from float 0, the waveform span
    (realigned by up to 3 floats), later the power spectra (fpb rows of
    n_fft / 2 + 1); region two, from float off2, the pass buffer (a row of
    R2 | 1 complex, an odd stride, for each of the R1 rows of each frame
    pair), which pass two overwrites with the FFT."""
    r1, r2 = fft_plan(n_fft)
    pairs = (fpb + 1) // 2
    span = ((fpb - 1) * hop + n_fft + 6) // 4 * 4
    power = (fpb * (n_fft // 2 + 1) + 3) // 4 * 4
    off2 = max(span, power)
    return off2, 4 * (off2 + 2 * pairs * r1 * (r2 | 1))


@functools.lru_cache(maxsize=None)
def mel_plan(b: int, t_total: int, n_fft: int, hop: int,
             sm_count: int) -> int:
    """Frames per block: the largest even size up to MAX_FRAMES whose
    shared memory fits, among those that give every SM a block where any
    size does."""
    sizes = [f for f in range(MAX_FRAMES, 0, -2)
             if mel_layout(f, hop, n_fft)[1] <= _SMEM_LIMIT]
    if not sizes:
        raise ValueError(f"mel kernel: n_fft={n_fft}, hop={hop} needs more "
                         f"than {_SMEM_LIMIT} B of shared memory")
    return next((f for f in sizes if b * -(-t_total // f) >= sm_count),
                sizes[-1])


@functools.lru_cache(maxsize=16)
def device_tables(cfg: MelConfig, device: torch.device):
    """(roots, window, ptw, weights, band), made once per (config,
    device): the in-register DFTs' roots as a host float32 array of (re,
    im) pairs, and on `device` the float32 Hann window, the inter-pass
    twiddles as (re, im) pairs, the filterbank's nonzeros and the int32
    band ranges."""
    roots, ptw = fft_tables(cfg.n_fft)
    band, weights = mel_bands(mel_filter_bank(cfg))
    on_device = tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in (hann_window(cfg.n_fft), ptw.view(np.float32), weights,
                  band))
    return (np.ascontiguousarray(roots.view(np.float32)),) + on_device


def _launch(wav: torch.Tensor, cfg: MelConfig, t_full: int,
            fpb: int = 0) -> torch.Tensor:
    """One launch; `fpb` frames per block, or mel_plan's choice for 0."""
    if cfg.power not in (1.0, 2.0):
        raise ValueError(f"mel kernel: power must be 1 or 2, got {cfg.power}")
    b, n = wav.shape
    if not fpb:
        sms = torch.cuda.get_device_properties(
            wav.device).multi_processor_count
        fpb = mel_plan(b, t_full, cfg.n_fft, cfg.hop_length, sms)
    off2, smem = mel_layout(fpb, cfg.hop_length, cfg.n_fft)
    roots, win, ptw, fbw, band = device_tables(cfg, wav.device)
    out = torch.empty((b, t_full, cfg.n_mels), dtype=torch.float32,
                      device=wav.device)
    fn = _build.function("mel", "log_mel_f32", _ARGTYPES)
    rc = fn(_build.ptr(wav), _build.ptr(win), roots.ctypes.data,
            _build.ptr(ptw), _build.ptr(fbw), _build.ptr(band),
            _build.ptr(out), b, n, t_full, cfg.n_fft, cfg.hop_length,
            cfg.n_fft // 2 if cfg.center else 0, cfg.n_mels, fpb, off2,
            smem, int(cfg.power == 1.0), _LOG_MODES[cfg.log_mode],
            _build.stream_ptr(wav))
    _build.check(rc, "log_mel")
    _build.STATS["log_mel"].launches += 1
    return out


def pair_error_bound(waveform: torch.Tensor, cfg: MelConfig,
                     mel_power: torch.Tensor) -> torch.Tensor:
    """(B, T, n_mels) float64: how far the kernel's log_eps features,
    log(mel + 1e-9), may lie from exact ones on these clips, beyond the
    float32 rounding of the filterbank sum and the log.

    `mel_power` is the exact (or plain float32) mel power of the same
    clips (`mel.log_mel_torch` with log_mode "none"). The kernel FFTs
    frames 2p and 2p + 1 (windowed: a, b) as z = a + ib and takes A_k =
    (Z_k + conj Z_(N-k)) / 2, so a bin's error is at most e = FFT_ERR * u
    * log2(N) * ||z||_2 with ||z||^2 = ||a||^2 + ||b||^2: the pair's
    energy, not the frame's. The power |A_k|^2 then errs by at most
    2 |A_k| e + e^2, and band m (weights 0 <= f <= 1, W_m their sum) by
    at most d = 2 e sqrt(W_m mel_m) + e^2 W_m (Cauchy-Schwarz, f^2 <= f).
    With x = mel_m + 1e-9 and the kernel's mel never below 0, the log
    moves by at most max(log1p(d / x), -log(max(1 - d / x, 1e-9 / x))).
    A silent frame whose partner is loud has mel_m = 0 and takes
    log1p(e^2 W_m / 1e-9), about 0.3 for a partner of unit-variance
    noise: the loud frame's relative error made absolute."""
    if cfg.log_mode != "log_eps":
        raise ValueError("pair_error_bound covers log_mode 'log_eps'")
    n = cfg.n_fft
    win = torch.from_numpy(hann_window(n)).to(waveform.device,
                                              torch.float64)
    frames = prepare_waveform(waveform, cfg).double().unfold(
        1, n, cfg.hop_length) * win
    energy = frames.square().sum(-1)                       # (B, T)
    t = energy.shape[1]
    energy = F.pad(energy, (0, t % 2))
    pair = energy.view(energy.shape[0], -1, 2).sum(-1) \
        .repeat_interleave(2, dim=1)[:, :t]
    e = (FFT_ERR * 2.0 ** -24 * math.log2(n) * pair.sqrt())[..., None]
    w = torch.from_numpy(mel_filter_bank(cfg)).to(
        waveform.device, torch.float64).sum(0)
    mel = mel_power.double().clamp_min(0.0)
    d = 2.0 * e * (w * mel).sqrt() + e * e * w
    x = mel + LOG_EPS
    return torch.maximum(torch.log1p(d / x), -torch.log(torch.maximum(
        1.0 - d / x, LOG_EPS / x)))


def log_mel_cuda(waveform: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """waveform (B, num_samples) -> (B, frames, n_mels) float32 features.

    A CUDA waveform runs the kernel; a CPU waveform runs the plain version
    `mel.log_mel_torch`."""
    if waveform.dim() != 2:
        raise ValueError(
            f"waveform must be (B, N), got {tuple(waveform.shape)}")
    if not waveform.is_cuda:
        return log_mel_torch(waveform, cfg)
    if cfg.log_mode not in _LOG_MODES:
        raise ValueError(cfg.log_mode)
    if cfg.center and cfg.pad_mode != "reflect":
        raise ValueError(f"mel kernel: pad_mode {cfg.pad_mode!r} (takes "
                         f"'reflect')")
    fft_plan(cfg.n_fft)
    wav = waveform.float().contiguous()
    # the frames of the padded clip: a clip no longer than n_fft is first
    # zero-padded to n_fft + 1 samples (prepare_waveform)
    n = max(wav.shape[1], cfg.n_fft + 1)
    t_full = (n + (2 * (cfg.n_fft // 2) if cfg.center else 0)
              - cfg.n_fft) // cfg.hop_length + 1
    out = _launch(wav, cfg, t_full)
    if cfg.log_mode != "whisper":
        return out
    # the kernel already took log10(max(mel, 1e-10)); what is left of the
    # whisper epilogue is the frame drop and the cross-frame floor
    if cfg.drop_last_frame:
        out = out[:, :-1, :]
    return whisper_floor(out)
