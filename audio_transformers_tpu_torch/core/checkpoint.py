"""Checkpoints: save and restore with retention and metadata.

The port of `audio_transformers_tpu/core/checkpoint.py`, written with
`torch.save` where the reference uses orbax (the card's machine has no
orbax). A checkpointer's directory holds one directory per step, as orbax
lays them out:

    <directory>/<step>/tree.pt        torch.save of the tree of tensors
    <directory>/<step>/metadata.json  the metadata, when given
    <directory>/<step>/metrics.json   {"best_metric": x}, when given

A step is written to a hidden temporary directory and moved into place
with one `os.replace`, so a crash leaves either the whole step or none of
it. Retention keeps the `max_to_keep` best steps by metric (orbax's
best_fn rule, newer first among equals); steps saved without a metric
rank below every step with one, newest first. Orbax keeps every step
without a metric under best_fn, so the reference's resume/ directory
keeps one per epoch where the port's keeps `max_to_keep`.

The port never reads an orbax checkpoint: weights cross between the two
packages as HF directories (`utils/hub.export_hf_dir`,
`models/whisper/load.py`).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import torch

from audio_transformers_tpu_torch.core.params import leaves_with_path

_TREE, _META, _METRICS = "tree.pt", "metadata.json", "metrics.json"


def _structure(tree: Any) -> list:
    return [(p, tuple(t.shape) if isinstance(t, torch.Tensor) else None)
            for p, t in leaves_with_path(tree)]


def check_structure(tree: Any, like: Any, where: str) -> None:
    """Raises an actionable ValueError unless `tree` has `like`'s paths
    (in order) and tensor shapes."""
    got, want = _structure(tree), _structure(like)
    if got == want:
        return
    diff = sorted(set(got) ^ set(want), key=str)[:4] or "the leaves' order"
    raise ValueError(
        f"checkpoint at {where} has a different tree structure than the "
        f"current code expects (it was likely written by an older version "
        f"of this package, e.g. a different optimizer or model size). "
        f"Resume is only possible with matching code; start a fresh run "
        f"(point --output_dir elsewhere or delete the stale "
        f"checkpoints).\n  first differences (path, shape): {diff}")


class Checkpointer:
    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 best_mode: str = "min"):
        if best_mode not in ("min", "max"):
            raise ValueError('best_mode must be "min" or "max"')
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.best_mode = best_mode

    def _steps(self) -> list:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit()
                      and os.path.exists(os.path.join(self.directory, d,
                                                      _TREE)))

    def _metric(self, step: int) -> Optional[float]:
        path = os.path.join(self.directory, str(step), _METRICS)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return float(json.load(f)["best_metric"])

    def _rank(self, step: int) -> tuple:
        """Sort key, worst first: steps without a metric, then by metric
        quality, newer steps above older ones among equals."""
        m = self._metric(step)
        if m is None:
            return (0, 0.0, step)
        return (1, -m if self.best_mode == "min" else m, step)

    def save(self, step: int, tree: dict, *, metadata: Optional[dict] = None,
             best_metric: Optional[float] = None) -> None:
        final = os.path.join(self.directory, str(step))
        if os.path.exists(final):
            raise ValueError(f"step {step} already exists in "
                             f"{self.directory}")
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)   # and the directory, on the first save
        torch.save(tree, os.path.join(tmp, _TREE))
        if metadata is not None:
            with open(os.path.join(tmp, _META), "w") as f:
                json.dump(metadata, f)
        if best_metric is not None:
            with open(os.path.join(tmp, _METRICS), "w") as f:
                json.dump({"best_metric": float(best_metric)}, f)
        os.replace(tmp, final)
        steps = sorted(self._steps(), key=self._rank)
        for old in steps[:max(0, len(steps) - self.max_to_keep)]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def restore(self, step: Optional[int] = None, like: Optional[Any] = None
                ) -> tuple:
        """(tree, metadata or None, step) of `step`, the latest by default.
        Leaves load on the CPU; with `like`, a tree of the same structure,
        each tensor leaf takes the dtype and device of `like`'s."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        where = os.path.join(self.directory, str(step))
        tree = torch.load(os.path.join(where, _TREE), map_location="cpu",
                          weights_only=True)
        if like is not None:
            check_structure(tree, like, f"{self.directory} step {step}")
            tree = _cast_like(tree, like)
        meta = None
        if os.path.exists(os.path.join(where, _META)):
            with open(os.path.join(where, _META)) as f:
                meta = json.load(f)
        return tree, meta, step

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def best_step(self) -> Optional[int]:
        """The best step by metric; None when no step has a metric."""
        scored = [s for s in self._steps() if self._metric(s) is not None]
        return max(scored, key=self._rank) if scored else None

    def close(self) -> None:
        """Nothing is held open; kept for the reference's interface."""


def _cast_like(tree: Any, like: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _cast_like(v, like[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_like(v, w) for v, w in zip(tree, like))
    if isinstance(tree, torch.Tensor) and isinstance(like, torch.Tensor):
        return tree.to(device=like.device, dtype=like.dtype)
    return tree


def save_label_map(path: str, label_to_idx: dict) -> None:
    """The reference-format label map: one "name: idx" line per label."""
    with open(path, "w") as f:
        for name, idx in label_to_idx.items():
            f.write(f"{name}: {idx}\n")


def load_label_map(path: str) -> dict:
    """Parses a file of "name: idx" lines (the name may hold colons)."""
    out: dict = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or ":" not in line:
                continue
            name, idx = line.rsplit(":", 1)
            out[name.strip()] = int(idx.strip())
    return out


def export_json(path: str, obj: Any) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True)
