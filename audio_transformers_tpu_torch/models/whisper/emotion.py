"""EmotionWhisper: whisper encoder-decoder + linear emotion head.

The serving half of the reference (`audio_transformers_tpu/models/whisper/
emotion.py`): the sequence-level emotion logits pooled from the hidden
states the greedy decode recorded. Segment-level pooling from timestamped
decodes waits for timestamped decoding.
"""

from __future__ import annotations

from typing import Optional

import torch

from audio_transformers_tpu.core.config import EmotionWhisperConfig
from audio_transformers_tpu_torch.core import params as cp
from audio_transformers_tpu_torch.ops import nn
from audio_transformers_tpu_torch.ops.segment_pool import masked_sequence_mean


def init(cfg: EmotionWhisperConfig, generator: torch.Generator) -> dict:
    """Fresh {"whisper", "emotion_head"} parameters from `generator`."""
    return cp.init(cfg, generator)


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
