"""Host-side batching over in-memory/lazy sample sources.

The TPU consumes fixed-shape batches; the host's job is decode/resample/
pad only (the mel front-end runs on device, unlike the reference which
does mel per-sample in DataLoader workers — urban_sounds/dataset.py:55-56,
:98-99). Training iterates seeded-shuffled full batches (drop_last, so the
jit'd step never recompiles); evaluation pads the final batch and carries a
validity mask so metrics are exact.

Prefetch: `num_workers > 0` overlaps host sample preparation with device
compute — the TPU-side equivalent of the reference's
`DataLoader(num_workers=4)` worker processes (urban_sounds/dataset.py:98-99).
Two tiers:
  - sources exposing `prefetch_iter(indices, num_threads)` (e.g.
    UrbanSoundLocalSource backed by the C++ pool in native/audiodec) stream
    decoded clips from native worker threads in submission order;
  - any other source is driven through a thread pool (numpy and the ctypes
    decode path release the GIL, so work genuinely overlaps).
Sample order is identical to the synchronous path in both tiers, so runs
are bit-reproducible regardless of `num_workers`.

Data parallelism: each process takes its contiguous slice of every
global batch (`parallel/distributed.py` owns the process geometry; one
process takes the whole batch), so the same script feeds any number of
processes. The port's copy of the reference package's `data/loader.py`
as it runs with `process_sharded=True`: the port runs one process per
device, so no process needs the whole global batch.
"""

from __future__ import annotations

import itertools
from collections import deque
from typing import Callable, Dict, Iterator, List, Sequence, Tuple

import numpy as np

from audio_transformers_tpu_torch.parallel import distributed


class Batcher:
    """Batches a map-style source: `source(i) -> dict of numpy arrays`."""

    def __init__(self, source: Callable[[int], Dict[str, np.ndarray]],
                 num_samples: int, batch_size: int, *, seed: int = 42,
                 num_workers: int = 0, prefetch_batches: int = 2):
        self.source = source
        self.num_samples = num_samples
        self.batch_size = batch_size
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch_batches = max(prefetch_batches, 1)

    # ------------------------------------------------------------------
    def _local_slice(self, idxs: Sequence[int],
                     valid: int) -> Tuple[List[int], int]:
        """This process's contiguous slice of a global batch and the count
        of valid (non-wrap-padded) rows inside it (identity on a single
        process)."""
        n_proc = distributed.process_count()
        if n_proc == 1:
            return list(idxs), valid
        if len(idxs) % n_proc:
            raise ValueError(f"global batch {len(idxs)} not divisible by "
                             f"{n_proc} processes")
        per = len(idxs) // n_proc
        pid = distributed.process_index()
        local_valid = min(max(valid - pid * per, 0), per)
        return list(idxs[pid * per: (pid + 1) * per]), local_valid

    def _assemble(self, samples: List[Dict[str, np.ndarray]],
                  valid: int) -> Dict[str, np.ndarray]:
        batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
        mask = np.zeros(len(samples), dtype=bool)
        mask[:valid] = True
        batch["valid"] = mask
        return batch

    def _collate(self, idxs: Sequence[int],
                 valid: int) -> Dict[str, np.ndarray]:
        samples = [self.source(int(i)) for i in idxs]
        return self._assemble(samples, valid)

    # ------------------------------------------------------------------
    def _iter_groups(self, groups: List[Tuple[List[int], int]]
                     ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield collated batches for (indices, valid_count) groups, with
        background prefetch when num_workers > 0. Order is preserved."""
        groups = [self._local_slice(idxs, valid) for idxs, valid in groups]
        if self.num_workers <= 0:
            for idxs, valid in groups:
                yield self._collate(idxs, valid)
            return

        flat = [i for idxs, _ in groups for i in idxs]
        native = getattr(self.source, "prefetch_iter", None)
        stream = (native(flat, num_threads=self.num_workers)
                  if native is not None else None)
        if stream is not None:
            # C++ pool path: samples stream back in submission order
            for idxs, valid in groups:
                samples = [next(stream) for _ in idxs]
                yield self._assemble(samples, valid)
            return

        from concurrent.futures import ThreadPoolExecutor

        window = max(self.batch_size * self.prefetch_batches,
                     self.num_workers)
        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            it = iter(flat)
            futures: deque = deque(
                ex.submit(self.source, int(i))
                for i in itertools.islice(it, window))
            for idxs, valid in groups:
                samples = []
                for _ in idxs:
                    samples.append(futures.popleft().result())
                    nxt = next(it, None)
                    if nxt is not None:
                        futures.append(ex.submit(self.source, int(nxt)))
                yield self._assemble(samples, valid)

    # ------------------------------------------------------------------
    def train_epochs(self, *, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        """Seeded shuffle per epoch; drops the final partial batch so batch
        shape is static under jit."""
        rng = np.random.default_rng(self.seed + epoch)
        order = rng.permutation(self.num_samples)
        n_full = self.num_samples // self.batch_size
        groups = [(list(order[b * self.batch_size:(b + 1) * self.batch_size]),
                   self.batch_size) for b in range(n_full)]
        yield from self._iter_groups(groups)

    def eval_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        """Sequential; final batch padded by wrapping, with `valid` mask."""
        groups = []
        for start in range(0, self.num_samples, self.batch_size):
            idxs = list(range(start, min(start + self.batch_size,
                                         self.num_samples)))
            valid = len(idxs)
            while len(idxs) < self.batch_size:
                idxs.append(idxs[-1])
            groups.append((idxs, valid))
        yield from self._iter_groups(groups)

    @property
    def steps_per_epoch(self) -> int:
        return self.num_samples // self.batch_size


class Subset:
    """Index-remapped view over a sample source (the ONE subset wrapper —
    urbansound and expresso splits both use it). Forwards `prefetch_iter`
    when the base source has one, so native-pool prefetch survives
    subsetting."""

    def __init__(self, base, indices: Sequence[int]):
        self.base = base
        self.indices = indices

    @property
    def num_samples(self) -> int:
        return len(self.indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __call__(self, i: int):
        return self.base(int(self.indices[i]))

    def prefetch_iter(self, indices, *, num_threads: int = 4):
        base_fn = getattr(self.base, "prefetch_iter", None)
        if base_fn is None:
            return None
        return base_fn([int(self.indices[i]) for i in indices],
                       num_threads=num_threads)

    def batcher(self, batch_size: int, seed: int = 42,
                num_workers: int = 0) -> "Batcher":
        return Batcher(self, self.num_samples, batch_size, seed=seed,
                       num_workers=num_workers)
