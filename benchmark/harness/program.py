"""The system under test: `audio_transformers_tpu_torch`, the PyTorch and
CUDA port, reached only through its public entry points.

This is the one module of the harness that imports the program; the
reference (`benchmark/reference/`) never does.
"""

from __future__ import annotations

from benchmark.harness.spec import Dims


def configs(dims: Dims):
    """(EmotionWhisperConfig, MelConfig) of the program for `dims`."""
    from audio_transformers_tpu_torch.core.config import (
        EmotionWhisperConfig, MelConfig, WhisperConfig)
    w = WhisperConfig(
        vocab_size=dims.vocab, n_mels=dims.n_mels, d_model=dims.d_model,
        encoder_layers=dims.encoder_layers, decoder_layers=dims.decoder_layers,
        num_heads=dims.heads, ffn_dim=dims.ffn,
        max_source_positions=dims.source_positions,
        max_target_positions=dims.target_positions,
        pad_token_id=dims.pad_id, bos_token_id=dims.eos_id,
        eos_token_id=dims.eos_id, decoder_start_token_id=dims.sot_id,
        no_timestamps_token_id=dims.no_timestamps_id,
        timestamp_begin_id=dims.timestamp_begin_id,
        lang_en_token_id=dims.lang_en_id,
        transcribe_token_id=dims.transcribe_id)
    return (EmotionWhisperConfig(whisper=w, num_emotion_classes=dims.classes),
            MelConfig.whisper(n_mels=dims.n_mels))


def modules():
    """The program's modules whose names the harness wraps."""
    from audio_transformers_tpu_torch.infer import pipeline
    from audio_transformers_tpu_torch.models.whisper import decode, emotion
    from audio_transformers_tpu_torch.models.whisper import model
    from audio_transformers_tpu_torch.train import whisper_emotion
    return {"pipeline": pipeline, "decode": decode, "emotion": emotion,
            "model": model, "whisper_emotion": whisper_emotion}


def join(world: int, rank: int, coordinator: str, device):
    """This process as rank `rank` of `world` in the program's process
    group (NCCL on the card, gloo on the CPU), pinned to card `rank`;
    returns the program's data-parallel mesh over the group."""
    import torch

    from audio_transformers_tpu_torch.parallel import distributed, mesh
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", rank)
    distributed.initialize_if_multihost(coordinator, world, rank,
                                        device=device)
    return mesh.build_mesh((("data", world),))


def leave() -> None:
    from audio_transformers_tpu_torch.parallel import distributed
    distributed.shutdown()


def launches() -> dict:
    """The program's kernel launch counters (read, never written)."""
    from audio_transformers_tpu_torch.ops import _build
    return {k: v.launches for k, v in _build.STATS.items()}
