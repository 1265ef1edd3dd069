"""EmotionWhisper: whisper encoder-decoder + linear emotion head.

The reference's `audio_transformers_tpu/models/whisper/emotion.py`:
`forward_train`, the teacher-forced training pass (token logits and
emotion logits mean-pooled from the decoder states), the sequence-level
emotion logits pooled from the hidden states a decode recorded, and the
per-segment emotion logits of a timestamped decode, pooled over each
timestamp segment's text tokens.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from audio_transformers_tpu_torch.core.config import \
    EmotionWhisperConfig
from audio_transformers_tpu_torch.core import params as cp
from audio_transformers_tpu_torch.core import tracing
from audio_transformers_tpu_torch.models.whisper import model as wm
from audio_transformers_tpu_torch.ops import nn
from audio_transformers_tpu_torch.ops.segment_pool import (
    masked_sequence_mean, segment_ids_from_tokens, segment_means)


def init(cfg: EmotionWhisperConfig, generator: torch.Generator) -> dict:
    """Fresh {"whisper", "emotion_head"} parameters from `generator`."""
    return cp.init(cfg, generator)


def param_axes(params: dict, cfg: EmotionWhisperConfig,
               model_size: int = 1) -> dict:
    """The tensor-parallel layout (`parallel.tensor.Split` per leaf):
    whisper's rules (`model.param_axes`) and the emotion head whole, as
    the reference's `param_axes`."""
    return {"whisper": wm.param_axes(params["whisper"], cfg.whisper,
                                     model_size),
            "emotion_head": {k: None for k in params["emotion_head"]}}


def forward_train(params: dict, cfg: EmotionWhisperConfig, mel: torch.Tensor,
                  decoder_ids: torch.Tensor, *, remat: bool = False,
                  pooling: str = "all", attn_impl: str = "auto",
                  model_group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced pass: mel (B, T_mel, n_mels) in the compute dtype,
    decoder_ids (B, T) -> (token logits (B, T, V) float32, emotion logits
    (B, C) float32).

    pooling="all" mean-pools every decoder position, padding included (the
    reference's training-time pooling); "masked" leaves out positions whose
    id is the pad token. attn_impl="flash" trains through the flash
    attention kernels (forward and backward); "auto" is "xla" here, as in
    the reference. With a `model_group`, `params` are this rank's shards
    (`param_axes`) and the token logits are this rank's vocab shard, (B,
    T, ids [v0, v1) of `parallel.tensor.vocab_shard`), not gathered: the
    train and eval steps take their cross-entropy over the shards
    (`train.whisper_emotion.token_cross_entropy`), and `tensor.gather_vocab`
    joins them where the whole rows are needed; the emotion logits are
    whole on every rank."""
    w = cfg.whisper
    enc = wm.encode(params["whisper"], w, mel, remat=remat,
                    attn_impl=attn_impl, model_group=model_group)
    hidden = wm.apply_decoder(params["whisper"], w, enc, decoder_ids,
                              remat=remat, attn_impl=attn_impl,
                              model_group=model_group)
    logits = wm.logits_from_hidden(params["whisper"], hidden, model_group)
    if pooling == "all":
        pooled = hidden.float().mean(dim=1)
    elif pooling == "masked":
        pooled = masked_sequence_mean(hidden, decoder_ids != w.pad_token_id)
    else:
        raise ValueError(f"unknown pooling {pooling!r}")
    return logits, nn.linear(params["emotion_head"], pooled).float()


def sequence_emotion_from_hiddens(params: dict, hiddens: torch.Tensor,
                                  lengths: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """(B, L, D) decode hiddens -> (B, C) float32 emotion logits. Pools
    over positions < lengths, or over all L positions when lengths is None
    (the reference's unmasked mean, which the head is trained on)."""
    with tracing.span("emotion_head"):
        if lengths is None:
            pooled = hiddens.float().mean(dim=1)
        else:
            mask = (torch.arange(hiddens.shape[1],
                                 device=hiddens.device)[None, :]
                    < lengths[:, None])
            pooled = masked_sequence_mean(hiddens, mask)
        return nn.linear(params["emotion_head"], pooled).float()


def segment_emotion_from_decode(params: dict, cfg: EmotionWhisperConfig,
                                decode_out: dict, *, prompt_len: int,
                                max_segments: Optional[int] = None) -> dict:
    """Per-segment emotion logits of a timestamped decode. Returns
    {"segment_logits" (B, S, C) float32, "segment_counts" (B, S),
    "num_segments" (B,)}; segments with count 0 are padding.

    max_segments=None sizes the segment buffer from the decode buffer: a
    row of G generated tokens closes at most G // 2 timestamp pairs, plus
    one slot for the fallback, so no segment is dropped. A row with no
    segment falls back to whole-sequence pooling (positions < lengths) as
    its segment 0, as in the reference."""
    w = cfg.whisper
    tokens, lengths = decode_out["tokens"], decode_out["lengths"]
    hiddens = decode_out["hiddens"]
    if max_segments is None:
        max_segments = max((tokens.shape[1] - prompt_len) // 2, 0) + 1
    seg_ids, valid = segment_ids_from_tokens(
        tokens, lengths, prompt_len=prompt_len,
        timestamp_begin=w.timestamp_begin_id, eos_token_id=w.eos_token_id)
    means, counts = segment_means(hiddens, seg_ids, valid, max_segments)
    logits = nn.linear(params["emotion_head"], means).float()
    num = (counts > 0).int().sum(dim=1)
    mask = (torch.arange(hiddens.shape[1], device=hiddens.device)[None, :]
            < lengths[:, None])
    seq_logits = nn.linear(params["emotion_head"],
                           masked_sequence_mean(hiddens, mask)).float()
    empty = num == 0
    logits[:, 0] = torch.where(empty[:, None], seq_logits, logits[:, 0])
    counts[:, 0] = torch.where(empty, 1.0, counts[:, 0])
    return {"segment_logits": logits, "segment_counts": counts,
            "num_segments": torch.where(empty, 1, num)}
