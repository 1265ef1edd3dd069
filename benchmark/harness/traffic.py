"""The one generator of every traffic mix: inputs from (seed, batch index).

A mix file (`workloads/<traffic>.json`) gives the parameters; this module
turns them into tensors on the device. Every batch of a mix holds the same
set of sizes (audio lengths, transcript lengths), spread evenly over the
mix's range, in an order drawn from the seed, so two seeds do the same
work on different values.

Audio is speech-like: a voiced source (a fundamental of 90-250 Hz with
slow vibrato and 8 harmonics falling as 1/h) under a syllable-rate
envelope (3-6 Hz), plus a little noise, zero-padded after its length to
the model window, as whisper pads.
"""

from __future__ import annotations

import json
import math
from typing import Dict

import torch

from benchmark.harness.spec import Dims


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def batch_seed(seed: int, index: int, stream: int = 0) -> int:
    """A generator seed for batch `index` of `stream`, a function of the
    run's seed alone (seeds may exceed 32 bits)."""
    return (int(seed) * 1_000_003 + index * 7919 + stream * 104_729) \
        % (2 ** 62)


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s rows in a cell on several cards: the
    run's seed on rank 0 (whose rows are then a one-card cell's), a seed
    drawn from it on the others."""
    return int(seed) if rank == 0 else batch_seed(seed, rank, 5)


def _spread(lo: float, hi: float, n: int, g: torch.Generator) -> torch.Tensor:
    """n values evenly spread over [lo, hi], in an order drawn from g."""
    vals = lo + (hi - lo) * (torch.arange(n, dtype=torch.float64) + 0.5) / n
    return vals[torch.randperm(n, generator=g)]


def audio_lengths(mix: dict, seed: int, index: int, rows: int) -> torch.Tensor:
    """(rows,) float64 audio seconds of batch `index`."""
    g = torch.Generator().manual_seed(batch_seed(seed, index, 1))
    lo, hi = mix["audio_s"]
    return _spread(lo, hi, rows, g)


def audio(mix: dict, dims: Dims, seed: int, index: int, rows: int,
          device) -> torch.Tensor:
    """(rows, window) float32 waveforms of batch `index`."""
    n = dims.window_samples
    sr = dims.sample_rate
    lengths = (audio_lengths(mix, seed, index, rows) * sr).long().clamp(
        max=n).to(device)
    g = torch.Generator(device=device).manual_seed(batch_seed(seed, index))

    def u(lo, hi, shape=(rows, 1)):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)
    t = torch.arange(n, device=device, dtype=torch.float32)[None, :] / sr
    f0 = u(90.0, 250.0) * (1.0 + 0.03 * torch.sin(
        2 * math.pi * u(4.0, 7.0) * t + u(0.0, 6.3)))
    phase = torch.cumsum(f0 / sr, dim=1) * (2 * math.pi)
    phase = torch.remainder(phase, 2 * math.pi)
    voiced = torch.zeros((rows, n), device=device)
    for h in range(1, 9):
        voiced += torch.sin(h * phase + u(0.0, 6.3)) / h
    env = torch.sin(2 * math.pi * u(3.0, 6.0) * t + u(0.0, 6.3)) ** 2
    wav = 0.1 * env * voiced + 0.005 * torch.randn(
        (rows, n), generator=g, device=device)
    keep = torch.arange(n, device=device)[None, :] < lengths[:, None]
    return torch.where(keep, wav, 0.0).contiguous()


def labels(mix: dict, dims: Dims, seed: int, index: int, rows: int,
           device) -> Dict[str, torch.Tensor]:
    """{"labels": (rows, label_len) int64, "emotion_labels": (rows,)}: a
    transcript of mix["transcript_ids"] ids per row (<|startoftranscript|>
    then text ids), pad after it; emotion classes uniform."""
    g = torch.Generator().manual_seed(batch_seed(seed, index, 2))
    lo, hi = mix["transcript_ids"]
    n_ids = _spread(lo, hi + 1, rows, g).floor().long().clamp(lo, hi)
    width = mix["label_len"]
    tlo, thi = dims.text_ids
    ids = torch.randint(tlo, thi, (rows, width), generator=g)
    ids[:, 0] = dims.sot_id
    pos = torch.arange(width)[None, :]
    ids = torch.where(pos < n_ids[:, None], ids, dims.pad_id)
    emo = torch.randint(0, dims.classes, (rows,), generator=g)
    return {"labels": ids.to(device), "emotion_labels": emo.to(device)}


def train_batch(mix: dict, dims: Dims, seed: int, index: int,
                device) -> Dict[str, torch.Tensor]:
    rows = mix["batch"]
    out = {"waveform": audio(mix, dims, seed, index, rows, device)}
    out.update(labels(mix, dims, seed, index, rows, device))
    return out
