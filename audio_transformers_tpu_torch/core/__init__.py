"""Configs (the reference package's JAX-free dataclasses, re-exported) and
the port's parameter trees (params.py)."""

from audio_transformers_tpu.core.config import (  # noqa: F401
    DecodeConfig,
    EmotionWhisperConfig,
    MelConfig,
    OptimizerConfig,
    TrainConfig,
    WhisperConfig,
)
