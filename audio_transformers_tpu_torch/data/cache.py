"""Decoded-waveform cache: skip re-decoding identical bytes every epoch.

The reference's torch DataLoader re-runs the full decode/resample chain
for every sample every epoch (reference: urban_sounds/dataset.py:98-99 —
workers re-open the wav files each pass). Epochs >= 2 read identical
bytes — a cache turns them into mmap reads.

Design:
  - ONE sparse data file (`data.bin`) of fixed-length slots, preallocated
    to `max_bytes` with ftruncate (disk blocks materialize only as slots
    are written) and accessed through np.memmap — no per-clip files.
  - `index.jsonl`: one appended line per insert (slot, key, per-clip
    fields such as the label and the int16 scale). Replayed on open, so
    the cache survives process restarts and a crash loses at most the
    final in-flight line.
  - `meta.json` pins (target_len, dtype, spec); opening with a different
    preprocessing spec raises instead of serving wrong waveforms.
  - Keys fingerprint the SOURCE FILE: abspath + mtime_ns + size. A
    rewritten file misses (the stale slot is simply never read again).
  - Bounded: when the slot budget is exhausted, inserts become no-ops
    (first-epoch-wins — every epoch sweeps the whole dataset, so LRU
    eviction would thrash; the cached prefix still skips its decodes).

Storage dtype: "int16" (default) stores round(wav / scale) with one f32
scale per clip (scale = max|wav| / 32767) — half the bytes of f32 and a
-90 dB quantization floor, far below the mel front-end's log floor;
"float32" stores exact values for byte-identical replay.

The port's copy of the reference package's `data/cache.py` (numpy only).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np

_DTYPES = {"int16": np.int16, "float32": np.float32}


def file_fingerprint(path: str) -> Optional[str]:
    """Key component identifying the current bytes of `path` (None when
    the file doesn't exist — callers treat that as uncacheable)."""
    try:
        st = os.stat(path)
    except OSError:
        return None
    return f"{os.path.abspath(path)}|{st.st_mtime_ns}|{st.st_size}"


class WaveformCache:
    """Fixed-length waveform slots in one sparse mmap file.

    `spec` names the preprocessing this cache holds (e.g.
    "wav->22050Hz,4.0s,peaknorm"); opening an existing cache with a
    different spec/target_len/dtype raises ValueError.
    """

    def __init__(self, cache_dir: str, *, target_len: int, spec: str,
                 dtype: str = "int16",
                 max_bytes: int = 2 * 1024 ** 3):
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, "
                             f"got {dtype!r}")
        self.dir = cache_dir
        self.target_len = int(target_len)
        self.dtype = dtype
        self.spec = spec
        itemsize = np.dtype(_DTYPES[dtype]).itemsize
        self.capacity = max(int(max_bytes) // (self.target_len * itemsize),
                            1)
        os.makedirs(cache_dir, exist_ok=True)
        meta_path = os.path.join(cache_dir, "meta.json")
        meta = {"target_len": self.target_len, "dtype": dtype, "spec": spec}
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                have = json.load(f)
            if {k: have.get(k) for k in meta} != meta:
                raise ValueError(
                    f"waveform cache at {cache_dir} was built with "
                    f"{have}, requested {meta}; use a different cache_dir")
        else:
            with open(meta_path, "w") as f:
                json.dump(meta, f)
        self._data_path = os.path.join(cache_dir, "data.bin")
        nbytes = self.capacity * self.target_len * itemsize
        if not os.path.exists(self._data_path) or \
                os.path.getsize(self._data_path) < nbytes:
            with open(self._data_path, "ab") as f:
                f.truncate(nbytes)  # sparse: no blocks written yet
        self._mm = np.memmap(self._data_path, dtype=_DTYPES[dtype],
                             mode="r+",
                             shape=(self.capacity, self.target_len))
        self._index_path = os.path.join(cache_dir, "index.jsonl")
        self._index: Dict[str, dict] = {}
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn final line from a crash
                    if rec.get("slot", self.capacity) < self.capacity:
                        self._index[rec["key"]] = rec
        self._index_f = open(self._index_path, "a")
        self._next_slot = (max((r["slot"] for r in self._index.values()),
                               default=-1) + 1)

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._index)

    @property
    def full(self) -> bool:
        return self._next_slot >= self.capacity

    def contains(self, key: Optional[str]) -> bool:
        return key is not None and key in self._index

    def get(self, key: Optional[str]) -> Optional[dict]:
        """-> {"waveform": float32 (target_len,), **fields} or None."""
        if key is None:
            return None
        rec = self._index.get(key)
        if rec is None:
            return None
        row = np.asarray(self._mm[rec["slot"]])
        if self.dtype == "int16":
            wav = row.astype(np.float32) * np.float32(rec["scale"])
        else:
            wav = row.astype(np.float32, copy=True)
        out = {"waveform": wav}
        out.update(rec.get("fields", {}))
        return out

    def put(self, key: Optional[str], waveform: np.ndarray,
            fields: Optional[dict] = None) -> bool:
        """Insert (no-op returning False when full / key is None /
        already present / wrong length). `fields` must be JSON-scalar
        values (they ride the index line, e.g. {"label": 3})."""
        if key is None or key in self._index or self.full:
            return False
        wav = np.asarray(waveform, np.float32)
        if wav.shape != (self.target_len,):
            return False
        slot = self._next_slot
        rec = {"key": key, "slot": slot}
        if self.dtype == "int16":
            scale = float(np.max(np.abs(wav))) / 32767.0
            if scale <= 0.0:
                scale = 1.0
            self._mm[slot] = np.round(wav / np.float32(scale)) \
                .astype(np.int16)
            rec["scale"] = scale
        else:
            self._mm[slot] = wav
        if fields:
            rec["fields"] = {k: (v.item() if hasattr(v, "item") else v)
                             for k, v in fields.items()}
        # data row lands before the index line so a replayed index never
        # points at an unwritten slot; flushing every insert cost ~40% of
        # the cold epoch, so lines batch (a crash loses at most 64 clips
        # of cache, never correctness)
        self._index_f.write(json.dumps(rec) + "\n")
        if slot % 64 == 63:
            self._index_f.flush()
        self._index[key] = rec
        self._next_slot = slot + 1
        return True

    def close(self):
        self._index_f.flush()
        self._index_f.close()
        self._mm.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class CachedSource:
    """Wrap a map-style sample source with a WaveformCache.

    base(i) must return {"waveform": float32 (target_len,), **small}
    where the non-waveform fields are JSON scalars (labels etc. — they
    are stored on the index line and reconstructed on hits without
    touching `base`). `path_of(i)` maps an index to the underlying audio
    file so keys can fingerprint its bytes; without it the key falls
    back to the bare index — correct for immutable in-memory sources,
    documented as non-invalidating.

    Forwards `prefetch_iter`: cache hits are served inline and only the
    misses stream through the base source's native prefetch pool, in
    order, inserting as they arrive.
    """

    def __init__(self, base, cache: WaveformCache, *,
                 path_of: Optional[Callable[[int], str]] = None):
        self.base = base
        self.cache = cache
        self.path_of = path_of

    @property
    def num_samples(self) -> int:
        return self.base.num_samples

    def __len__(self) -> int:
        return self.base.num_samples

    def _key(self, i: int) -> Optional[str]:
        if self.path_of is None:
            return f"idx:{int(i)}|{self.cache.spec}"
        return file_fingerprint(self.path_of(int(i)))

    def _split(self, sample: dict):
        wav = sample["waveform"]
        fields = {k: v for k, v in sample.items() if k != "waveform"}
        return wav, fields

    def __call__(self, i: int) -> dict:
        key = self._key(i)
        hit = self.cache.get(key)
        if hit is not None:
            return hit
        sample = self.base(int(i))
        wav, fields = self._split(sample)
        self.cache.put(key, wav, fields)
        return sample

    def prefetch_iter(self, indices: Sequence[int], *,
                      num_threads: int = 4) -> Optional[Iterator[dict]]:
        base_fn = getattr(self.base, "prefetch_iter", None)
        if base_fn is None:
            return None
        indices = [int(i) for i in indices]
        keys = [self._key(i) for i in indices]
        # membership only — waveforms are read lazily in gen(), so an
        # epoch of hits never sits in RAM all at once
        is_hit = [self.cache.contains(k) for k in keys]
        miss = [i for i, h in zip(indices, is_hit) if not h]
        stream = None
        if miss:
            stream = base_fn(miss, num_threads=num_threads)
            if stream is None:
                return None

        def gen():
            for key, hit in zip(keys, is_hit):
                if hit:
                    yield self.cache.get(key)
                    continue
                sample = next(stream)
                wav, fields = self._split(sample)
                self.cache.put(key, wav, fields)
                yield sample

        return gen()
