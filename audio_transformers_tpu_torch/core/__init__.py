"""Configs (config.py, the port's copy of the reference package's
dataclasses) and the port's parameter trees (params.py)."""

from audio_transformers_tpu_torch.core.config import (  # noqa: F401
    DecodeConfig,
    EmotionWhisperConfig,
    MelConfig,
    OptimizerConfig,
    TrainConfig,
    WhisperConfig,
)
