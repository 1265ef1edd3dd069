"""Deterministic dataset splitting.

The reference's stratified splitter uses an UNSEEDED `np.random.shuffle`
(reference: whisper_finetune/dataset.py:135) so its splits are not
reproducible across runs — the rebuild seeds everything (SURVEY.md §4
determinism notes).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def stratified_split(labels: Sequence, *, test_size: float = 0.1,
                     val_size: float = 0.1, seed: int = 42
                     ) -> Tuple[List[int], List[int], List[int]]:
    """Per-class shuffle + split guaranteeing >=1 sample of every class in
    every split (capability of reference create_stratified_split,
    dataset.py:113-161, with seeding fixed).

    Returns (train_indices, val_indices, test_indices).
    """
    rng = np.random.default_rng(seed)
    by_class: Dict = {}
    for i, lab in enumerate(labels):
        by_class.setdefault(lab, []).append(i)

    train_idx, val_idx, test_idx = [], [], []
    for lab in sorted(by_class, key=str):
        idxs = np.array(by_class[lab])
        rng.shuffle(idxs)
        n = len(idxs)
        if n < 3:
            # the >=1-per-split guarantee needs 3 samples; degrade loudly
            # (train first, then val) rather than silently emitting a
            # split with zero samples of this class
            import warnings
            warnings.warn(
                f"class {lab!r} has only {n} sample(s); cannot place >=1 "
                f"in every split — filling train, then val", stacklevel=2)
            n_train, n_val = 1, n - 1
        else:
            n_test = max(1, int(n * test_size))
            n_val = max(1, int(n * val_size))
            n_train = n - n_test - n_val
            while n_train < 1:  # shrink the larger split, keep each >= 1
                if n_val >= n_test and n_val > 1:
                    n_val -= 1
                elif n_test > 1:
                    n_test -= 1
                n_train = n - n_test - n_val
        train_idx.extend(idxs[:n_train].tolist())
        val_idx.extend(idxs[n_train:n_train + n_val].tolist())
        test_idx.extend(idxs[n_train + n_val:].tolist())
    return train_idx, val_idx, test_idx


def random_split(num_samples: int, val_fraction: float,
                 seed: int = 42) -> Tuple[List[int], List[int]]:
    """Seeded random train/val split (reference get_dataloaders uses
    torch random_split with manual_seed 42, urban_sounds/dataset.py:90-94)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(num_samples)
    n_val = int(val_fraction * num_samples)
    return order[n_val:].tolist(), order[:n_val].tolist()
