"""Pooling of decoder hidden states for the emotion head.

Only the sequence-level masked mean is ported so far; the timestamp
segment pooling of the reference (`audio_transformers_tpu/ops/
segment_pool.py`) waits for timestamped decoding.
"""

from __future__ import annotations

import torch


def masked_sequence_mean(hiddens: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """hiddens (B, L, D), mask (B, L) bool -> (B, D) float32 mean over the
    valid positions; rows with no valid position fall back to the full
    mean."""
    m = mask.float()
    denom = m.sum(dim=1, keepdim=True)
    h = hiddens.float()
    summed = torch.einsum("bld,bl->bd", h, m)
    safe = torch.where(denom > 0, denom, torch.full_like(denom, h.shape[1]))
    return torch.where(denom > 0, summed / safe, h.mean(dim=1))
