"""Pooling of decoder hidden states for the emotion head: the masked
sequence mean and the timestamp segment pooling of the reference
(`audio_transformers_tpu/ops/segment_pool.py`). A segment id per token is
derived from the timestamp structure, then one masked segment mean runs
over the batch: fixed shapes, no host sync.
"""

from __future__ import annotations

from typing import Tuple

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


def segment_ids_from_tokens(tokens: torch.Tensor, lengths: torch.Tensor, *,
                            prompt_len: int, timestamp_begin: int,
                            eos_token_id: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token segment ids from the whisper timestamp structure of
    decoded rows tokens (B, L): timestamps come in pairs <start> text...
    <end>, and text after the pair's second timestamp belongs to the next
    segment. Returns (seg_ids (B, L) int32, 0-based, and valid (B, L)
    bool): valid marks text tokens (not a timestamp, not EOS, after the
    prompt, before `lengths`); invalid positions keep an id that must be
    masked with `valid`."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    in_range = (positions >= prompt_len) & (positions < lengths[:, None])
    is_ts = (tokens >= timestamp_begin) & in_range
    ts_ordinal = torch.cumsum(is_ts.int(), dim=1)      # 1-based
    is_end_ts = (is_ts & (ts_ordinal % 2 == 0)).int()
    seg_ids = torch.cumsum(is_end_ts, dim=1) - is_end_ts
    valid = in_range & ~is_ts & (tokens != eos_token_id)
    return seg_ids.int(), valid


def segment_means(hiddens: torch.Tensor, seg_ids: torch.Tensor,
                  valid: torch.Tensor, num_segments: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """hiddens (B, L, D) -> (means (B, S, D), counts (B, S)), float32, by a
    one-hot product; ids at or past `num_segments` fall out, as in the
    reference's one_hot."""
    segs = torch.arange(num_segments, device=seg_ids.device)
    onehot = ((seg_ids[:, :, None] == segs) & valid[:, :, None]).float()
    counts = onehot.sum(dim=1)
    sums = torch.einsum("bls,bld->bsd", onehot, hiddens.float())
    return sums / counts.clamp(min=1.0)[:, :, None], counts
