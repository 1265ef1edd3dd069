"""Logit processors for decoding, on PyTorch tensors.

The HF chain the reference decodes with (`audio_transformers_tpu/ops/
logit_processors.py`): suppress lists, repetition penalty over a seen-token
mask, no-repeat-ngram, and the whisper timestamp rules, in their interval
form (three scalars per row, which the greedy kernel K2 applies) and in
their full-distribution form with the probability rule (sampling and beam
scores). The decode loop runs on the host here, so the generation position
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
                   finished: Optional[torch.Tensor] = None, *,
                   offset: Optional[int] = None) -> torch.Tensor:
    """(B, width) int8 0/1 mask of the ids that would complete an n-gram
    already present in tokens[:, :pos]. Rows already `finished` ban
    nothing (their next token is forced to pad anyway). The full banned
    set is built directly; it equals the reference's top-16 compaction
    with its dense fallback. With an `offset` the mask is a vocab shard:
    column j is id offset + j, and ids outside the shard ban nothing."""
    b = tokens.shape[0]
    flag, cont, _ = ngram_window_match(tokens, pos, n)
    if finished is not None:
        flag &= ~finished[:, None]
    if offset is not None:
        cont = cont - offset
        flag &= (cont >= 0) & (cont < width)
    # unflagged windows scatter into a spare column that is cut off
    idx = torch.where(flag, cont, torch.full_like(cont, width))
    ban = torch.zeros((b, width + 1), dtype=torch.int8, device=tokens.device)
    ban.scatter_(1, idx, 1)
    return ban[:, :width].contiguous()


def _timestamp_row_scalars(tokens: torch.Tensor, pos: int, *,
                           begin_index: int, timestamp_begin: int):
    """The per-row scalars every timestamp rule derives from, as the
    reference's: (mask_ts, mask_text, has_ts, floor) (B,) tensors and
    at_begin, a bool."""
    length = tokens.shape[1]
    last = tokens[:, max(pos - 1, 0)]
    penult = tokens[:, max(pos - 2, 0)]
    last_was_ts = (pos > begin_index) & (last >= timestamp_begin)
    penult_was_ts = (pos <= begin_index + 1) | (penult >= timestamp_begin)
    mask_ts = last_was_ts & penult_was_ts      # has to be non-timestamp
    mask_text = last_was_ts & ~penult_was_ts   # cannot be normal text
    # monotonicity: mask timestamps below the last one in the history,
    # exclusive mid-pair, else inclusive (+1)
    positions = torch.arange(length, device=tokens.device)
    hist = (positions[None, :] >= begin_index) & (positions[None, :] < pos)
    is_ts_hist = hist & (tokens >= timestamp_begin)
    last_idx = torch.where(is_ts_hist, positions[None, :],
                           torch.full_like(tokens, -1)).amax(dim=1)
    has_ts = last_idx >= 0
    last_ts = tokens.gather(1, last_idx.clamp(min=0)[:, None])[:, 0]
    floor = torch.where(mask_text, last_ts, last_ts + 1)
    return mask_ts, mask_text, has_ts, floor, pos == begin_index


def timestamp_row_bounds(tokens: torch.Tensor, pos: int, *, begin_index: int,
                         timestamp_begin: int, eos_token_id: int,
                         max_initial_timestamp_index: Optional[int] = 50):
    """Interval encoding of the pre-probability whisper timestamp rules
    except the static <|notimestamps|> ban. For vocab id v the rules mask

        v < text_ban_below | (timestamp_begin <= v < ts_ban_below)
        | v > cap_above

    Returns three (B,) int32 tensors (text_ban_below, ts_ban_below,
    cap_above), as the reference's `timestamp_row_bounds`."""
    mask_ts, mask_text, has_ts, floor, at_begin = _timestamp_row_scalars(
        tokens, pos, begin_index=begin_index,
        timestamp_begin=timestamp_begin)
    zeros = torch.zeros(tokens.shape[0], dtype=torch.int64,
                        device=tokens.device)
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


def _timestamp_mask_cond(tokens: torch.Tensor, pos: int, *, vocab: int,
                         begin_index: int, timestamp_begin: int,
                         eos_token_id: int, no_timestamps_token_id: int,
                         max_initial_timestamp_index: Optional[int]
                         ) -> torch.Tensor:
    """(B, vocab) bool predicate of every timestamp rule except the
    probability rule, from the per-row scalars against the vocab ids, as
    the reference's `_timestamp_mask_cond`."""
    ids = torch.arange(vocab, device=tokens.device)
    is_ts_vocab = ids >= timestamp_begin
    mask_ts, mask_text, has_ts, floor, at_begin = _timestamp_row_scalars(
        tokens, pos, begin_index=begin_index,
        timestamp_begin=timestamp_begin)
    cond = (ids == no_timestamps_token_id)[None, :]           # always
    cond = cond | (mask_ts[:, None] & is_ts_vocab[None, :])   # pair rule
    # no normal text after a lone timestamp (HF masks ids < eos: in the
    # real whisper vocab every text id lies below eos)
    cond = cond | (mask_text[:, None] & (ids < eos_token_id)[None, :])
    cond = cond | (has_ts[:, None] & is_ts_vocab[None, :]
                   & (ids[None, :] < floor[:, None]))         # monotonic
    if at_begin:                                              # ts only
        cond = cond | ~is_ts_vocab[None, :]
        if max_initial_timestamp_index is not None:
            cap = timestamp_begin + max_initial_timestamp_index
            cond = cond | (ids > cap)[None, :]
    return cond


def whisper_timestamp_rules(logits: torch.Tensor, tokens: torch.Tensor,
                            pos: int, *, begin_index: int,
                            timestamp_begin: int, eos_token_id: int,
                            no_timestamps_token_id: int,
                            max_initial_timestamp_index: Optional[int] = 50
                            ) -> torch.Tensor:
    """HF WhisperTimeStampLogitsProcessor semantics on (B, V) float32
    logits, the reference's full-distribution form (sampling, beam
    scores): <|notimestamps|> is always suppressed; timestamps come in
    pairs; they do not decrease; the first generated position takes only
    timestamps up to max_initial_timestamp_index; and where the summed
    probability of the timestamps exceeds the largest text probability,
    text is suppressed (compared in raw-logit space: log_softmax
    subtracts the same constant from both sides)."""
    vocab = logits.shape[-1]
    cond = _timestamp_mask_cond(
        tokens, pos, vocab=vocab, begin_index=begin_index,
        timestamp_begin=timestamp_begin, eos_token_id=eos_token_id,
        no_timestamps_token_id=no_timestamps_token_id,
        max_initial_timestamp_index=max_initial_timestamp_index)
    masked = torch.where(cond, NEG_INF, logits)
    tb = min(max(timestamp_begin, 0), vocab)
    if 0 < tb < vocab:
        lse_ts = torch.logsumexp(masked[:, tb:], dim=-1)
        max_text = masked[:, :tb].amax(dim=-1)
        force_ts = lse_ts > max_text
        is_text = torch.arange(vocab, device=logits.device) < tb
        cond = cond | (force_ts[:, None] & is_text[None, :])
    return torch.where(cond, NEG_INF, logits)
