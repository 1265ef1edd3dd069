"""Synthetic datasets: deterministic class-separable audio fixtures.

Serve two roles:
  - unit/integration tests without network access (the reference's datasets
    are HF downloads: danavery/urbansound8K at urban_sounds/dataset.py:10,
    ylacombe/expresso at whisper_finetune/dataset.py:166);
  - the `--dataset synthetic` CLI path for smoke-training anywhere.

Each class k is a band of sinusoids around a class-specific base frequency
plus noise, so a classifier can actually learn (and overfit) the mapping.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from audio_transformers_tpu_torch.data.loader import Batcher


class SyntheticClassification:
    """Fixed-duration labeled clips for the urbansound-style pipeline."""

    def __init__(self, num_samples: int = 64, num_classes: int = 10,
                 sample_rate: int = 22050, duration: float = 4.0,
                 seed: int = 42):
        self.num_samples = num_samples
        self.num_classes = num_classes
        self.sample_rate = sample_rate
        self.num_audio_samples = int(sample_rate * duration)
        rng = np.random.default_rng(seed)
        self.labels = rng.integers(0, num_classes, num_samples)
        self.seeds = rng.integers(0, 2**31 - 1, num_samples)

    def __len__(self) -> int:
        return self.num_samples

    def __call__(self, i: int) -> Dict[str, np.ndarray]:
        label = int(self.labels[i])
        rng = np.random.default_rng(int(self.seeds[i]))
        t = np.arange(self.num_audio_samples) / self.sample_rate
        base = 150.0 * (label + 1)
        wav = np.zeros_like(t, dtype=np.float32)
        for h in range(1, 4):
            f = base * h * (1.0 + 0.01 * rng.standard_normal())
            wav += (0.5 / h) * np.sin(2 * np.pi * f * t).astype(np.float32)
        wav += 0.05 * rng.standard_normal(len(t)).astype(np.float32)
        peak = np.abs(wav).max()
        return {
            "waveform": (wav / peak).astype(np.float32),
            "label": np.int32(label),
        }

    def batcher(self, batch_size: int, seed: int = 42,
                num_workers: int = 0) -> Batcher:
        return Batcher(self, self.num_samples, batch_size, seed=seed,
                       num_workers=num_workers)


class SyntheticSeq2Seq:
    """Labeled clips + token sequences for the whisper-emotion pipeline.

    Token "transcripts" are deterministic functions of the clip id within a
    small vocab; emotion label = class id, audio as in
    SyntheticClassification (at 16 kHz)."""

    def __init__(self, num_samples: int = 32, num_classes: int = 6,
                 vocab_size: int = 1024, max_label_len: int = 12,
                 sample_rate: int = 16000, duration: float = 3.0,
                 bos_id: int = 1, eos_id: int = 0, pad_id: int = 0,
                 seed: int = 42):
        self.inner = SyntheticClassification(
            num_samples, num_classes, sample_rate, duration, seed)
        self.vocab_size = vocab_size
        self.max_label_len = max_label_len
        self.bos_id, self.eos_id, self.pad_id = bos_id, eos_id, pad_id
        rng = np.random.default_rng(seed + 1)
        lens = rng.integers(3, max_label_len - 2, num_samples)
        self.token_seqs: List[np.ndarray] = []
        for i in range(num_samples):
            toks = rng.integers(10, vocab_size, lens[i])
            self.token_seqs.append(toks.astype(np.int32))

    def __len__(self) -> int:
        return self.inner.num_samples

    @property
    def num_samples(self) -> int:
        return self.inner.num_samples

    def __call__(self, i: int) -> Dict[str, np.ndarray]:
        base = self.inner(i)
        toks = self.token_seqs[i]
        labels = np.full(self.max_label_len, self.pad_id, np.int32)
        seq = [self.bos_id, *toks.tolist(), self.eos_id]
        labels[: len(seq)] = seq[: self.max_label_len]
        return {
            "waveform": base["waveform"],
            "labels": labels,
            "label_len": np.int32(min(len(seq), self.max_label_len)),
            "emotion_labels": base["label"],
        }

    def batcher(self, batch_size: int, seed: int = 42,
                num_workers: int = 0) -> Batcher:
        return Batcher(self, self.num_samples, batch_size, seed=seed,
                       num_workers=num_workers)
