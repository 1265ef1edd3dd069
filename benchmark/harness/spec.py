"""A configuration file read into the sizes and ids the benchmark needs.

A configuration file (`configs/<name>.json`) holds the model as it is
run: the keys of the published whisper `config.json`, the special ids of
its `generation_config.json`, `num_emotion_classes` and the sizes the
benchmark assumed (`assumed`). Nothing here imports the program.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class Dims:
    d_model: int
    encoder_layers: int
    decoder_layers: int
    heads: int
    ffn: int
    n_mels: int
    vocab: int
    source_positions: int
    target_positions: int
    classes: int
    pad_id: int
    eos_id: int
    sot_id: int
    no_timestamps_id: int
    timestamp_begin_id: int
    transcribe_id: int
    lang_en_id: int
    suppress: Tuple[int, ...]
    begin_suppress: Tuple[int, ...]
    text_ids: Tuple[int, int]          # [lo, hi): ids a transcript draws
    sample_rate: int = 16000
    n_fft: int = 400
    hop: int = 160

    @property
    def head_dim(self) -> int:
        return self.d_model // self.heads

    @property
    def window_samples(self) -> int:
        """One model window: source positions x conv stride x hop."""
        return self.source_positions * 2 * self.hop

    @property
    def mel_frames(self) -> int:
        return self.source_positions * 2


def load(path: str) -> Dims:
    with open(path) as f:
        raw = json.load(f)
    return from_dict(raw)


def from_dict(raw: dict) -> Dims:
    if raw["encoder_attention_heads"] != raw["decoder_attention_heads"] or \
            raw["encoder_ffn_dim"] != raw["decoder_ffn_dim"]:
        raise ValueError("encoder and decoder widths differ; the port's "
                         "WhisperConfig has one of each")
    assumed = raw.get("assumed", {})
    return Dims(
        d_model=raw["d_model"], encoder_layers=raw["encoder_layers"],
        decoder_layers=raw["decoder_layers"],
        heads=raw["encoder_attention_heads"], ffn=raw["encoder_ffn_dim"],
        n_mels=raw["num_mel_bins"], vocab=raw["vocab_size"],
        source_positions=raw["max_source_positions"],
        target_positions=raw["max_target_positions"],
        classes=raw["num_emotion_classes"],
        pad_id=raw["pad_token_id"], eos_id=raw["eos_token_id"],
        sot_id=raw["decoder_start_token_id"],
        no_timestamps_id=raw["no_timestamps_token_id"],
        timestamp_begin_id=raw["timestamp_begin_id"],
        transcribe_id=raw["transcribe_token_id"],
        lang_en_id=raw["lang_en_token_id"],
        suppress=tuple(raw["suppress_tokens"]),
        begin_suppress=tuple(raw["begin_suppress_tokens"]),
        text_ids=tuple(assumed["text_token_ids"]))
