"""Log-mel spectrogram front-end.

framing -> Hann window -> |rDFT|^2 -> mel filterbank -> log

The filterbank, window and DFT-basis builders and the numpy golden
`reference_log_mel` are the reference package's (`audio_transformers_tpu/
ops/mel.py`), carried here because that module imports JAX. `log_mel_torch`
is the plain PyTorch version of the CUDA kernel in `mel_cuda.py`; `log_mel`
is the entry point, which runs the kernel for a CUDA waveform and the plain
version for a CPU one.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from audio_transformers_tpu_torch.core.config import MelConfig
from audio_transformers_tpu_torch.ops import _build

# ---------------------------------------------------------------------------
# Filterbank / basis construction (numpy, once per config)
# ---------------------------------------------------------------------------


def hz_to_mel(freq: np.ndarray, mel_scale: str) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    if mel_scale == "slaney":
        f_sp = 200.0 / 3.0
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = math.log(6.4) / 27.0
        mels = freq / f_sp
        above = freq >= min_log_hz
        with np.errstate(divide="ignore"):
            mels = np.where(above, min_log_mel + np.log(
                np.maximum(freq, 1e-10) / min_log_hz) / logstep, mels)
        return mels
    raise ValueError(f"unknown mel_scale {mel_scale!r}")


def mel_to_hz(mels: np.ndarray, mel_scale: str) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    if mel_scale == "slaney":
        f_sp = 200.0 / 3.0
        min_log_hz = 1000.0
        min_log_mel = min_log_hz / f_sp
        logstep = math.log(6.4) / 27.0
        freqs = f_sp * mels
        above = mels >= min_log_mel
        freqs = np.where(
            above, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)
        return freqs
    raise ValueError(f"unknown mel_scale {mel_scale!r}")


def mel_filter_bank(cfg: MelConfig) -> np.ndarray:
    """Triangular mel filterbank, shape (n_freqs, n_mels), float32
    (torchaudio `melscale_fbanks` for htk/no-norm, HF `mel_filter_bank`
    for slaney/slaney)."""
    all_freqs = np.linspace(0.0, cfg.sample_rate / 2.0, cfg.n_freqs)
    m_min = hz_to_mel(np.array(cfg.f_min), cfg.mel_scale)
    m_max = hz_to_mel(np.array(cfg.effective_f_max), cfg.mel_scale)
    m_pts = np.linspace(m_min, m_max, cfg.n_mels + 2)
    f_pts = mel_to_hz(m_pts, cfg.mel_scale)

    f_diff = f_pts[1:] - f_pts[:-1]                       # (n_mels+1,)
    slopes = f_pts[None, :] - all_freqs[:, None]          # (n_freqs, n_mels+2)
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))            # (n_freqs, n_mels)

    if cfg.mel_norm == "slaney":
        enorm = 2.0 / (f_pts[2: cfg.n_mels + 2] - f_pts[: cfg.n_mels])
        fb = fb * enorm[None, :]
    elif cfg.mel_norm is not None:
        raise ValueError(f"unknown mel_norm {cfg.mel_norm!r}")
    return fb.astype(np.float32)


def hann_window(n: int, periodic: bool = True) -> np.ndarray:
    denom = n if periodic else n - 1
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / denom))
    return w.astype(np.float32)


def dft_bases(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT cos/sin bases, each (n_fft, n_freqs) fp32. Only the power
    (x @ cos)^2 + (x @ sin)^2 is needed, so the sign is irrelevant."""
    n_freqs = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_freqs, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _windowed_bases(cfg: MelConfig):
    """(window*cos, window*sin, mel_fb): the Hann window folded into the
    DFT bases."""
    win = hann_window(cfg.n_fft)
    cos_b, sin_b = dft_bases(cfg.n_fft)
    fb = mel_filter_bank(cfg)
    return win[:, None] * cos_b, win[:, None] * sin_b, fb


@functools.lru_cache(maxsize=16)
def device_bases(cfg: MelConfig, device: torch.device):
    """`_windowed_bases` as float32 tensors on `device`, made once."""
    return tuple(torch.from_numpy(a).to(device) for a in _windowed_bases(cfg))


# ---------------------------------------------------------------------------
# Numpy golden reference (mirrors torchaudio / HF)
# ---------------------------------------------------------------------------


def reference_log_mel(waveform: np.ndarray, cfg: MelConfig) -> np.ndarray:
    """Pure-numpy reference. waveform (num_samples,) -> (frames, n_mels)."""
    wav = np.asarray(waveform, dtype=np.float32)
    if cfg.center:
        pad = cfg.n_fft // 2
        wav = np.pad(wav, pad, mode=cfg.pad_mode)
        n_frames = len(waveform) // cfg.hop_length + 1
    else:
        n_frames = (len(waveform) - cfg.n_fft) // cfg.hop_length + 1
    idx = (np.arange(n_frames)[:, None] * cfg.hop_length
           + np.arange(cfg.n_fft)[None, :])
    frames = wav[idx] * hann_window(cfg.n_fft)[None, :]
    spec = np.fft.rfft(frames.astype(np.float64), axis=-1)
    power = (spec.real ** 2 + spec.imag ** 2).astype(np.float32)
    if cfg.power == 1.0:
        power = np.sqrt(power)
    mel = power @ mel_filter_bank(cfg)
    if cfg.log_mode == "log_eps":
        out = np.log(mel + 1e-9)
    elif cfg.log_mode == "whisper":
        if cfg.drop_last_frame:
            mel = mel[:-1]
        out = np.log10(np.maximum(mel, 1e-10))
        out = np.maximum(out, out.max() - 8.0)
        out = (out + 4.0) / 4.0
    elif cfg.log_mode == "none":
        out = mel
    else:
        raise ValueError(cfg.log_mode)
    return out.astype(np.float32)


# ---------------------------------------------------------------------------
# PyTorch path
# ---------------------------------------------------------------------------


def prepare_waveform(waveform: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """(B, N) -> float32 (B, N') ready for framing: clips no longer than
    one FFT window are zero-padded to n_fft + 1 samples (reflect padding
    needs more than n_fft // 2), then the centre reflect pad is applied."""
    wav = waveform.float()
    if wav.shape[1] <= cfg.n_fft:
        wav = F.pad(wav, (0, cfg.n_fft + 1 - wav.shape[1]))
    if cfg.center:
        pad = cfg.n_fft // 2
        wav = F.pad(wav[:, None, :], (pad, pad), mode=cfg.pad_mode)[:, 0, :]
    return wav.contiguous()


def log_epilogue(mel: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """mel (B, T, n_mels) power-mel -> log features per cfg.log_mode."""
    if cfg.log_mode == "log_eps":
        return torch.log(mel + 1e-9)
    if cfg.log_mode == "whisper":
        if cfg.drop_last_frame:
            mel = mel[:, :-1, :]
        out = torch.log10(torch.clamp(mel, min=1e-10))
        return whisper_floor(out)
    if cfg.log_mode == "none":
        return mel
    raise ValueError(cfg.log_mode)


def whisper_floor(out: torch.Tensor) -> torch.Tensor:
    """Whisper's cross-frame dynamic-range floor (max - 8) and (x+4)/4."""
    floor = out.amax(dim=(1, 2), keepdim=True) - 8.0
    return (torch.maximum(out, floor) + 4.0) / 4.0


def log_mel_torch(waveform: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """Plain PyTorch log-mel: waveform (B, num_samples) -> (B, frames,
    n_mels) float32. Frames are gathered with `unfold`, the windowed rDFT
    and the filterbank are float32 matmuls."""
    _build.count_plain("log_mel", waveform)
    wcos, wsin, fb = device_bases(cfg, waveform.device)
    wav = prepare_waveform(waveform, cfg)
    frames = wav.unfold(1, cfg.n_fft, cfg.hop_length)     # (B, T, n_fft)
    re = frames @ wcos
    im = frames @ wsin
    power = re * re + im * im
    if cfg.power == 1.0:
        power = torch.sqrt(power)
    return log_epilogue(power @ fb, cfg)


def log_mel(waveform: torch.Tensor, cfg: MelConfig, *,
            precision: str = "highest") -> torch.Tensor:
    """Batched log-mel features, (B, num_samples) -> (B, frames, n_mels)
    float32: the CUDA kernel for a CUDA waveform, `log_mel_torch` for a CPU
    one. `precision` is "highest" or "high"; both compute in full float32
    (see `mel_cuda.log_mel_cuda`)."""
    if precision not in ("highest", "high"):
        raise ValueError(f"unknown mel precision {precision!r}")
    from audio_transformers_tpu_torch.ops.mel_cuda import log_mel_cuda
    return log_mel_cuda(waveform, cfg)
