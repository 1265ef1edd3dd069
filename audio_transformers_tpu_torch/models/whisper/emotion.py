"""EmotionWhisper: whisper encoder-decoder + linear emotion head.

The reference's `audio_transformers_tpu/models/whisper/emotion.py`:
`forward_train`, the teacher-forced training pass (token logits and
emotion logits mean-pooled from the decoder states), and the sequence-level
emotion logits pooled from the hidden states the greedy decode recorded.
Segment-level pooling from timestamped decodes waits for timestamped
decoding.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from audio_transformers_tpu.core.config import EmotionWhisperConfig
from audio_transformers_tpu_torch.core import params as cp
from audio_transformers_tpu_torch.models.whisper import model as wm
from audio_transformers_tpu_torch.ops import nn
from audio_transformers_tpu_torch.ops.segment_pool import masked_sequence_mean


def init(cfg: EmotionWhisperConfig, generator: torch.Generator) -> dict:
    """Fresh {"whisper", "emotion_head"} parameters from `generator`."""
    return cp.init(cfg, generator)


def forward_train(params: dict, cfg: EmotionWhisperConfig, mel: torch.Tensor,
                  decoder_ids: torch.Tensor, *, remat: bool = False,
                  pooling: str = "all", attn_impl: str = "auto"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced pass: mel (B, T_mel, n_mels) in the compute dtype,
    decoder_ids (B, T) -> (token logits (B, T, V) float32, emotion logits
    (B, C) float32).

    pooling="all" mean-pools every decoder position, padding included (the
    reference's training-time pooling); "masked" leaves out positions whose
    id is the pad token. attn_impl="flash" trains through the flash
    attention kernels (forward and backward); "auto" is "xla" here, as in
    the reference."""
    w = cfg.whisper
    enc = wm.encode(params["whisper"], w, mel, remat=remat,
                    attn_impl=attn_impl)
    hidden = wm.apply_decoder(params["whisper"], w, enc, decoder_ids,
                              remat=remat, attn_impl=attn_impl)
    logits = wm.logits_from_hidden(params["whisper"], hidden)
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
    if lengths is None:
        pooled = hiddens.float().mean(dim=1)
    else:
        mask = (torch.arange(hiddens.shape[1], device=hiddens.device)[None, :]
                < lengths[:, None])
        pooled = masked_sequence_mean(hiddens, mask)
    return nn.linear(params["emotion_head"], pooled).float()
