"""Logit processors for greedy decoding, on PyTorch tensors.

The HF chain the reference decodes with (`audio_transformers_tpu/ops/
logit_processors.py`): suppress lists, repetition penalty over a seen-token
mask, no-repeat-ngram, and the whisper timestamp rules in their interval
form. The decode loop runs on the host here, so the generation position
`pos` (number of tokens already in the (B, L) buffer) is a Python int.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

# Same sentinel as the reference (finfo(float32).min, not -inf): a
# suppressed logit that is also penalised overflows to -inf there too.
NEG_INF = torch.finfo(torch.float32).min
_INT32_MAX = torch.iinfo(torch.int32).max


def suppress_vector(width: int, token_ids: Sequence[int], *, vocab: int,
                    device=None) -> torch.Tensor:
    """(width,) float32 additive mask: NEG_INF at `token_ids` and at the
    padded tail ids >= `vocab`, 0 elsewhere."""
    add = torch.zeros(width, dtype=torch.float32, device=device)
    add[vocab:] = NEG_INF
    if len(token_ids):
        add[torch.tensor(list(token_ids), device=device)] = NEG_INF
    return add


def repetition_penalty(logits: torch.Tensor, seen: torch.Tensor,
                       penalty: float) -> torch.Tensor:
    """HF CTRL-style penalty on the ids marked in `seen`: positive logits
    are divided by `penalty`, negative ones multiplied, in float32."""
    s = seen != 0
    return torch.where(s & (logits > 0), logits / penalty,
                       torch.where(s, logits * penalty, logits))


def ngram_window_match(tokens: torch.Tensor, pos: int, n: int):
    """No-repeat-ngram window matching over the (B, L) token buffer.

    Returns (flag, cont, starts):
      flag   (B, W) bool: history windows whose (n-1)-gram equals the
             suffix ending at pos-1, lying fully inside tokens[:, :pos],
             with a full (n-1)-gram of history available (pos >= n)
      cont   (B, W) each window's continuation token id
      starts (W,)   window starts
    """
    b, length = tokens.shape
    start = max(pos - (n - 1), 0)
    last = tokens[:, start:start + n - 1]                  # (B, n-1)
    num_windows = length - n + 1
    match = torch.ones((b, num_windows), dtype=torch.bool,
                       device=tokens.device)
    for j in range(n - 1):
        match &= tokens[:, j: j + num_windows] == last[:, j: j + 1]
    starts = torch.arange(num_windows, device=tokens.device)
    valid = (starts[None, :] + (n - 1)) < pos
    flag = match & valid & (pos >= n)
    cont = tokens[:, n - 1: n - 1 + num_windows]
    return flag, cont, starts


def ngram_ban_mask(tokens: torch.Tensor, pos: int, n: int, width: int,
                   finished: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, width) int8 0/1 mask of the ids that would complete an n-gram
    already present in tokens[:, :pos]. Rows already `finished` ban
    nothing (their next token is forced to pad anyway). The full banned
    set is built directly; it equals the reference's top-16 compaction
    with its dense fallback."""
    b = tokens.shape[0]
    flag, cont, _ = ngram_window_match(tokens, pos, n)
    if finished is not None:
        flag &= ~finished[:, None]
    # unflagged windows scatter into a spare column that is cut off
    idx = torch.where(flag, cont, torch.full_like(cont, width))
    ban = torch.zeros((b, width + 1), dtype=torch.int8, device=tokens.device)
    ban.scatter_(1, idx, 1)
    return ban[:, :width].contiguous()


def timestamp_row_bounds(tokens: torch.Tensor, pos: int, *, begin_index: int,
                         timestamp_begin: int, eos_token_id: int,
                         max_initial_timestamp_index: Optional[int] = 50):
    """Interval encoding of the pre-probability whisper timestamp rules
    except the static <|notimestamps|> ban. For vocab id v the rules mask

        v < text_ban_below | (timestamp_begin <= v < ts_ban_below)
        | v > cap_above

    Returns three (B,) int32 tensors (text_ban_below, ts_ban_below,
    cap_above), as the reference's `timestamp_row_bounds`."""
    b, length = tokens.shape
    dev = tokens.device
    last = tokens[:, max(pos - 1, 0)]
    penult = tokens[:, max(pos - 2, 0)]
    last_was_ts = (pos > begin_index) & (last >= timestamp_begin)
    penult_was_ts = (pos <= begin_index + 1) | (penult >= timestamp_begin)
    mask_ts = last_was_ts & penult_was_ts
    mask_text = last_was_ts & ~penult_was_ts

    positions = torch.arange(length, device=dev)
    hist = (positions[None, :] >= begin_index) & (positions[None, :] < pos)
    is_ts_hist = hist & (tokens >= timestamp_begin)
    last_idx = torch.where(is_ts_hist, positions[None, :],
                           torch.full_like(tokens, -1)).amax(dim=1)
    has_ts = last_idx >= 0
    last_ts = tokens.gather(1, last_idx.clamp(min=0)[:, None])[:, 0]
    floor = torch.where(mask_text, last_ts, last_ts + 1)
    at_begin = pos == begin_index

    zeros = torch.zeros(b, dtype=torch.int64, device=dev)
    text_ban_below = (zeros + timestamp_begin if at_begin
                      else torch.where(mask_text, eos_token_id, zeros))
    ts_ban_below = torch.where(
        mask_ts, _INT32_MAX, torch.where(has_ts, floor, timestamp_begin))
    if max_initial_timestamp_index is not None and at_begin:
        cap_above = zeros + timestamp_begin + max_initial_timestamp_index
    else:
        cap_above = zeros + _INT32_MAX
    return tuple(x.to(torch.int32) for x in
                 (text_ban_below, ts_ban_below, cap_above))
