"""Training throughput meter.

The reference's `StepTimer` (`audio_transformers_tpu/core/metrics.py`)
syncs through `core.profiling.sync`, which imports JAX; this one syncs
with `torch.cuda.synchronize()`. The metric logger is the reference's own
`MetricLogger`, which is JAX-free.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from audio_transformers_tpu.core.metrics import MetricLogger

__all__ = ["MetricLogger", "StepTimer"]


class StepTimer:
    """Wall clock per training window: steps and items per second, and the
    time spent blocked on the host input pipeline (`data_tick`).

    PyTorch returns before the card finishes, so `rates(device)` first
    waits for the card when `device` is a CUDA device. Call it before any
    eval work so the window measures training only."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._start = time.perf_counter()
        self._steps = 0
        self._items = 0
        self._data_wait = 0.0

    def tick(self, items: int = 0):
        self._steps += 1
        self._items += items

    def data_tick(self, seconds: float):
        self._data_wait += seconds

    def rates(self, device: Optional[torch.device] = None) -> dict:
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - self._start
        out = {"steps_per_sec": self._steps / dt if dt else 0.0,
               "data_wait_s": self._data_wait}
        if self._items:
            out["items_per_sec"] = self._items / dt if dt else 0.0
        return out
