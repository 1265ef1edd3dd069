"""Training throughput meter.

The reference's `StepTimer` (`audio_transformers_tpu/core/metrics.py`)
syncs through `core.profiling.sync`, which imports JAX; this one syncs
with `torch.cuda.synchronize()`. `MetricLogger` is the port's copy of the
reference's (console, JSONL on disk, wandb when configured).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

import torch

__all__ = ["MetricLogger", "StepTimer"]


class MetricLogger:
    def __init__(self, log_dir: Optional[str] = None,
                 wandb_project: Optional[str] = None,
                 wandb_entity: Optional[str] = None,
                 config: Optional[dict] = None,
                 console: bool = True):
        self.console = console
        self._file = None
        self._wandb = None
        self._t0 = time.time()
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        if wandb_project and os.environ.get("WANDB_KEY"):
            try:
                import wandb
                wandb.login(key=os.environ["WANDB_KEY"])
                self._wandb = wandb.init(project=wandb_project,
                                         entity=wandb_entity, config=config)
            except Exception as e:  # offline or wandb missing: JSONL only
                print(f"[metrics] wandb unavailable ({e}); using JSONL sink")

    def log(self, metrics: dict, step: Optional[int] = None):
        payload = {k: (float(v) if hasattr(v, "item") or
                       isinstance(v, (int, float)) else v)
                   for k, v in metrics.items()}
        if step is not None:
            payload["step"] = step
        payload["wall_time"] = round(time.time() - self._t0, 3)
        if self._file:
            self._file.write(json.dumps(payload) + "\n")
            self._file.flush()
        if self._wandb:
            self._wandb.log(payload, step=step)
        if self.console:
            body = ", ".join(f"{k}={v:.5g}" if isinstance(v, float) else
                             f"{k}={v}" for k, v in payload.items()
                             if k != "wall_time")
            print(f"[metrics] {body}")

    def finish(self):
        if self._file:
            self._file.close()
            self._file = None
        if self._wandb:
            self._wandb.finish()
            self._wandb = None


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
