"""Fused log-mel front-end as a hand-written CUDA kernel (`csrc/mel.cu`).

Replaces the TPU kernel `log_mel_pallas` (`audio_transformers_tpu/ops/
mel_pallas.py`, `_mel_kernel`): framing, Hann-windowed rDFT, power, mel
filterbank and the log10 clamp in one pass, so the (B, T, n_fft) frame
tensor and the (B, T, n_freqs) power spectrum never reach device memory.

Design: one block per (clip, tile of 16 frames). The block copies the
waveform span of its frames into shared memory; each thread owns one
frequency and accumulates the real and imaginary parts of all 16 frames
in registers while it walks the 400 window taps, reading the windowed
cos/sin bases (321 KB, shared by every block) through L1/L2. The power
spectrum of the tile stays in shared memory for the filterbank product.

Bound on the H100: float32 FMA issue. At whisper's 30 s window it is
~2 * 3001 * 201 * 400 FMA per clip (~0.96 GFLOP) against ~1.9 MB of
waveform and ~1 MB of features, so it is far above the memory roofline;
the register-blocked 16 frames per basis load keep the loads off the
critical path. Tensor cores are not used yet.

Both `precision` names of the reference ("highest" and "high") compute in
full float32 FMA here, so the kernel matches or beats "highest". The
reflect padding, and whisper's cross-frame floor and (x+4)/4 epilogue, run
as plain PyTorch around the kernel, as in the TPU version.
"""

from __future__ import annotations

import ctypes

import torch

from audio_transformers_tpu.core.config import MelConfig
from audio_transformers_tpu_torch.ops import _build
from audio_transformers_tpu_torch.ops.mel import (device_bases,
                                                  log_mel_torch,
                                                  prepare_waveform,
                                                  whisper_floor)

TILE_FRAMES = 16          # frames per block; must match csrc/mel.cu
_LOG_MODES = {"none": 0, "log_eps": 1, "whisper": 2}
_SMEM_LIMIT = 48 * 1024   # the kernel asks for no opt-in shared memory
# wav, wcos, wsin, fb, out; batch, n, t_total, n_fft, hop, n_mels,
# use_sqrt, log_mode; stream
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def _smem_bytes(cfg: MelConfig) -> int:
    span = (TILE_FRAMES - 1) * cfg.hop_length + cfg.n_fft
    return 4 * (span + TILE_FRAMES * cfg.n_freqs)


def _launch(wav: torch.Tensor, cfg: MelConfig, t_full: int) -> torch.Tensor:
    if _smem_bytes(cfg) > _SMEM_LIMIT:
        raise ValueError(f"mel kernel: config needs {_smem_bytes(cfg)} B "
                         f"of shared memory (limit {_SMEM_LIMIT})")
    if cfg.power not in (1.0, 2.0):
        raise ValueError(f"mel kernel: power must be 1 or 2, got {cfg.power}")
    wcos, wsin, fb = device_bases(cfg, wav.device)
    b, n = wav.shape
    out = torch.empty((b, t_full, cfg.n_mels), dtype=torch.float32,
                      device=wav.device)
    fn = _build.function("mel", "log_mel_f32", _ARGTYPES)
    rc = fn(_build.ptr(wav), _build.ptr(wcos), _build.ptr(wsin),
            _build.ptr(fb), _build.ptr(out), b, n, t_full, cfg.n_fft,
            cfg.hop_length, cfg.n_mels, int(cfg.power == 1.0),
            _LOG_MODES[cfg.log_mode], _build.stream_ptr(wav))
    _build.check(rc, "log_mel")
    _build.STATS["log_mel"].launches += 1
    return out


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
    wav = prepare_waveform(waveform, cfg)
    t_full = (wav.shape[1] - cfg.n_fft) // cfg.hop_length + 1
    out = _launch(wav, cfg, t_full)
    if cfg.log_mode != "whisper":
        return out
    # the kernel already took log10(max(mel, 1e-10)); what is left of the
    # whisper epilogue is the frame drop and the cross-frame floor
    if cfg.drop_last_frame:
        out = out[:, :-1, :]
    return whisper_floor(out)
