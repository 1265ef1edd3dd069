"""UrbanSound8K data pipeline.

Capability-equivalent to the reference (reference:
urban_sounds/dataset.py:8-101): loads `danavery/urbansound8K` via HF
datasets (network/cache required; SyntheticClassification serves hub-less
environments), per-sample host preprocessing = mono mean -> resample to
22.05 kHz -> pad/trim to 4 s -> peak normalize, seeded 80/20 split, and
optional `limit_samples`. The mel transform runs on-device (ops/mel.py),
not here — the reference computes it per-sample in DataLoader workers
(dataset.py:55-56).

Also supports local-directory loading (wav files + a metadata csv with
`slice_file_name,classID` columns, the UrbanSound8K layout) so training
doesn't require the HF hub.

The port's copy of the reference package's `data/urbansound.py`; the HF
source imports `datasets` only when it is built, and says what to use
instead where the package is missing.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from audio_transformers_tpu_torch.data.loader import Batcher, Subset
from audio_transformers_tpu_torch.data.splits import random_split
from audio_transformers_tpu_torch.utils.audio import (preprocess_clip,
                                                     read_audio)

SAMPLE_RATE = 22050
DURATION = 4.0
NUM_CLASSES = 10


class UrbanSoundHFSource:
    def __init__(self, *, sample_rate: int = SAMPLE_RATE,
                 duration: float = DURATION,
                 limit_samples: Optional[int] = None,
                 cache_dir: Optional[str] = None):
        try:
            from datasets import load_dataset
        except ImportError as e:
            raise ImportError(
                "the urbansound8k source needs the `datasets` package; "
                "without it use --dataset local (a directory of wav files "
                "and metadata.csv) or --dataset synthetic") from e
        self.ds = load_dataset("danavery/urbansound8K", split="train",
                               cache_dir=cache_dir)
        self.sample_rate = sample_rate
        self.duration = duration
        self.n = min(limit_samples or len(self.ds), len(self.ds))

    @property
    def num_samples(self) -> int:
        return self.n

    def __len__(self) -> int:
        return self.n

    def __call__(self, i: int) -> Dict[str, np.ndarray]:
        row = self.ds[int(i)]
        wav = preprocess_clip(np.asarray(row["audio"]["array"]),
                              row["audio"]["sampling_rate"],
                              target_sr=self.sample_rate,
                              duration=self.duration)
        return {"waveform": wav, "label": np.int32(row["classID"])}


class UrbanSoundLocalSource:
    """wav-file directory + metadata csv (UrbanSound8K on-disk layout).

    Uses the native C++ loader (native/audiodec via data/native_loader) for
    decode+resample when built — the equivalent of the reference's C++
    DataLoader-worker tier — with a pure-numpy fallback."""

    def __init__(self, data_dir: str, metadata_csv: Optional[str] = None, *,
                 sample_rate: int = SAMPLE_RATE, duration: float = DURATION,
                 limit_samples: Optional[int] = None,
                 use_native: Optional[bool] = None):
        self.data_dir = data_dir
        meta = metadata_csv or os.path.join(data_dir, "metadata.csv")
        self.rows: List[Tuple[str, int]] = []
        with open(meta) as f:
            for row in csv.DictReader(f):
                name = row.get("slice_file_name") or row["file"]
                label = int(row.get("classID", row.get("label", 0)))
                self.rows.append((name, label))
        if limit_samples:
            self.rows = self.rows[:limit_samples]
        self.sample_rate = sample_rate
        self.duration = duration
        if use_native is None:
            from audio_transformers_tpu_torch.data import native_loader
            use_native = native_loader.available()
        self.use_native = use_native

    @property
    def num_samples(self) -> int:
        return len(self.rows)

    def __len__(self) -> int:
        return len(self.rows)

    def __call__(self, i: int) -> Dict[str, np.ndarray]:
        name, label = self.rows[int(i)]
        path = os.path.join(self.data_dir, name)
        if self.use_native:
            from audio_transformers_tpu_torch.data import native_loader as nl
            from audio_transformers_tpu_torch.utils.audio import (
                pad_or_trim, peak_normalize)
            with open(path, "rb") as f:
                audio, sr = nl.decode_wav(f.read())
            if sr != self.sample_rate:
                audio = nl.resample(audio, sr, self.sample_rate)
            wav = peak_normalize(pad_or_trim(
                audio, int(self.sample_rate * self.duration)))
        else:
            audio, sr = read_audio(path)
            wav = preprocess_clip(audio, sr, target_sr=self.sample_rate,
                                  duration=self.duration)
        return {"waveform": wav, "label": np.int32(label)}

    def path_of(self, i: int) -> str:
        return os.path.join(self.data_dir, self.rows[int(i)][0])

    def cached(self, cache_dir: str, *, dtype: str = "int16",
               max_bytes: int = 2 * 1024 ** 3):
        """Wrap in a decoded-waveform cache (data/cache.py): epochs >= 2
        serve mmap reads instead of re-decoding identical bytes, which is
        what the reference's DataLoader workers do every epoch
        (urban_sounds/dataset.py:98-99). Keys fingerprint each wav's
        mtime+size, so edited files re-decode."""
        from audio_transformers_tpu_torch.data.cache import (CachedSource,
                                                             WaveformCache)
        cache = WaveformCache(
            cache_dir,
            target_len=int(self.sample_rate * self.duration),
            spec=f"wav->{self.sample_rate}Hz,{self.duration}s,peaknorm",
            dtype=dtype, max_bytes=max_bytes)
        return CachedSource(self, cache, path_of=self.path_of)

    def prefetch_iter(self, indices, *, num_threads: int = 4):
        """Stream samples for `indices` (in order) from the C++ prefetch
        pool — decode/resample/pad/normalize run in native worker threads,
        overlapping the training step (the reference hides the same work in
        DataLoader worker processes, urban_sounds/dataset.py:98-99).
        Returns None when the native library isn't available so the caller
        can fall back to its generic thread-pool tier."""
        if not self.use_native:
            return None
        return self._native_stream(list(indices), num_threads)

    def _native_stream(self, indices, num_threads: int):
        # iter_clips owns the deadlock-sensitive submit-until-full /
        # pop-one pump (ONE implementation, native_loader.py); it yields
        # in submission order with tag = position in `paths`
        from audio_transformers_tpu_torch.data import native_loader as nl

        paths = [os.path.join(self.data_dir, self.rows[int(i)][0])
                 for i in indices]
        for k, clip, ok in nl.iter_clips(
                paths, target_rate=self.sample_rate,
                target_len=int(self.sample_rate * self.duration),
                num_threads=num_threads):
            i = int(indices[k])
            if ok:
                yield {"waveform": clip, "label": np.int32(self.rows[i][1])}
            else:  # unreadable/corrupt file: python path decides
                yield self(i)


def get_batchers(source, *, batch_size: int = 32, val_split: float = 0.2,
                 seed: int = 42, num_workers: int = 0
                 ) -> Tuple[Batcher, Batcher]:
    """Seeded train/val split -> (train_batcher, val_batcher); the
    reference get_dataloaders contract (urban_sounds/dataset.py:73-101,
    incl. its num_workers=4 prefetch, dataset.py:98-99)."""
    tr, va = random_split(source.num_samples, val_split, seed=seed)
    return (Subset(source, tr).batcher(batch_size, seed=seed,
                                        num_workers=num_workers),
            Subset(source, va).batcher(batch_size, seed=seed,
                                        num_workers=num_workers))
