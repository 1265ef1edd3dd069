"""Expresso emotion dataset pipeline (whisper-emotion fine-tuning).

Capability-equivalent to the reference (reference:
whisper_finetune/dataset.py:10-240):
  - loads `ylacombe/expresso` (HF datasets; requires network/cache — the
    synthetic variant below serves hub-less environments)
  - filters out the "longform" style (dataset.py:170)
  - optional seeded `data_percentage` subsample (dataset.py:174-180)
  - global sorted style_to_idx built BEFORE splitting (dataset.py:183-191)
  - seeded stratified 80/10/10 split (splits.py fixes the reference's
    unseeded shuffle, dataset.py:135)
  - per-sample: waveform padded/truncated to 30 s (the mel front-end runs
    on-device, unlike the reference's host-side WhisperFeatureExtractor),
    tokenized transcription padded with pad_token_id, emotion label index

The `SIMPLE_STYLES` subset mirrors dataset.py:230-240.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from audio_transformers_tpu_torch.data.loader import Batcher, Subset
from audio_transformers_tpu_torch.data.splits import stratified_split
from audio_transformers_tpu_torch.data.synthetic import SyntheticSeq2Seq
from audio_transformers_tpu_torch.data.tokenizer import Tokenizer
from audio_transformers_tpu_torch.utils.audio import (pad_or_trim,
                                                      resample, to_mono)

SIMPLE_STYLES = [
    "angry", "calm", "default", "disgusted", "fearful", "happy", "sad",
    "sleepy", "sympathetic",
]

EXPRESSO_SAMPLE_RATE = 16000
CLIP_SECONDS = 30.0


class ExpressoSource:
    """Map-style source over an HF dataset split: index -> batch sample."""

    def __init__(self, hf_split, indices: List[int], tokenizer: Tokenizer,
                 style_to_idx: Dict[str, int], *,
                 max_label_len: int = 448,
                 sample_rate: int = EXPRESSO_SAMPLE_RATE,
                 clip_seconds: float = CLIP_SECONDS):
        self.ds = hf_split
        self.indices = indices
        self.tokenizer = tokenizer
        self.style_to_idx = style_to_idx
        self.max_label_len = max_label_len
        self.sample_rate = sample_rate
        self.target_len = int(sample_rate * clip_seconds)

    @property
    def num_samples(self) -> int:
        return len(self.indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __call__(self, i: int) -> Dict[str, np.ndarray]:
        row = self.ds[int(self.indices[i])]
        audio = row["audio"]
        wav = to_mono(np.asarray(audio["array"], dtype=np.float32))
        if audio["sampling_rate"] != self.sample_rate:
            wav = resample(wav, audio["sampling_rate"], self.sample_rate)
        wav = pad_or_trim(wav, self.target_len)

        ids = self.tokenizer.encode(row["text"])[: self.max_label_len]
        labels = np.full(self.max_label_len, self.tokenizer.pad_token_id,
                         np.int32)
        labels[: len(ids)] = ids

        style = row["style"]
        emotion = self.style_to_idx.get(style, 0)
        return {
            "waveform": wav.astype(np.float32),
            "labels": labels,
            "label_len": np.int32(len(ids)),
            "emotion_labels": np.int32(emotion),
        }

    def batcher(self, batch_size: int, seed: int = 42,
                num_workers: int = 0) -> Batcher:
        return Batcher(self, self.num_samples, batch_size, seed=seed,
                       num_workers=num_workers)


def create_dataset(tokenizer: Tokenizer, *,
                   selected_styles: Optional[List[str]] = None,
                   data_percentage: float = 1.0,
                   test_size: float = 0.1, val_size: float = 0.1,
                   seed: int = 42, max_label_len: int = 448,
                   cache_dir: Optional[str] = None
                   ) -> Tuple[ExpressoSource, ExpressoSource, ExpressoSource,
                              Dict[str, int]]:
    """Returns (train, val, test, style_to_idx) — the reference
    create_dataset contract (dataset.py:164-226)."""
    from datasets import load_dataset

    full = load_dataset("ylacombe/expresso", split="train",
                        cache_dir=cache_dir)
    styles_col = full["style"]
    keep = [i for i, s in enumerate(styles_col) if s != "longform"
            and (selected_styles is None or s in selected_styles)]

    if data_percentage < 1.0:
        rng = np.random.default_rng(seed)
        n = int(len(keep) * data_percentage)
        keep = [keep[j] for j in
                rng.choice(len(keep), n, replace=False)]

    kept_styles = [styles_col[i] for i in keep]
    style_to_idx = {s: i for i, s in enumerate(sorted(set(kept_styles)))}

    tr, va, te = stratified_split(kept_styles, test_size=test_size,
                                  val_size=val_size, seed=seed)

    def mk(local_idxs):
        return ExpressoSource(full, [keep[j] for j in local_idxs], tokenizer,
                              style_to_idx, max_label_len=max_label_len)

    return mk(tr), mk(va), mk(te), style_to_idx


# ---------------------------------------------------------------------------
# Offline stand-in with the same contract
# ---------------------------------------------------------------------------


class SyntheticExpresso:
    """Style-labeled synthetic clips + byte-token transcripts with the same
    sample schema as ExpressoSource — powers tests/CLI in hub-less envs."""

    def __init__(self, tokenizer: Tokenizer, *, num_samples: int = 64,
                 styles: Optional[List[str]] = None, duration: float = 3.0,
                 max_label_len: int = 32, seed: int = 42,
                 vocab_size: Optional[int] = None):
        self.styles = styles or SIMPLE_STYLES
        self.style_to_idx = {s: i for i, s in
                             enumerate(sorted(self.styles))}
        self.tokenizer = tokenizer
        self.inner = SyntheticSeq2Seq(
            num_samples=num_samples, num_classes=len(self.styles),
            vocab_size=vocab_size or getattr(tokenizer, "vocab_size", 264),
            max_label_len=max_label_len, duration=duration,
            bos_id=tokenizer.decoder_start_token_id,
            eos_id=tokenizer.eos_token_id, pad_id=tokenizer.pad_token_id,
            seed=seed)

    @property
    def num_samples(self) -> int:
        return self.inner.num_samples

    def __len__(self) -> int:
        return self.inner.num_samples

    def __call__(self, i: int):
        return self.inner(i)

    def batcher(self, batch_size: int, seed: int = 42,
                num_workers: int = 0) -> Batcher:
        return Batcher(self, self.num_samples, batch_size, seed=seed,
                       num_workers=num_workers)

    def splits(self, *, test_size: float = 0.1, val_size: float = 0.1,
               seed: int = 42):
        labels = [int(self.inner.inner.labels[i])
                  for i in range(self.num_samples)]
        tr, va, te = stratified_split(labels, test_size=test_size,
                                      val_size=val_size, seed=seed)
        return (_SubsetSource(self, tr), _SubsetSource(self, va),
                _SubsetSource(self, te), self.style_to_idx)


# shared index-remapping view (data/loader.py); kept under the old
# private name for local readers
_SubsetSource = Subset
