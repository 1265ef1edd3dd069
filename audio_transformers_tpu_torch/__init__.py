"""The PyTorch/CUDA port of audio_transformers_tpu.

The serving path of the EmotionWhisper model on an NVIDIA Hopper GPU
(log-mel front end, whisper encoder, precomputed cross K/V, KV-cached
greedy decode with the HF logit-processor chain, emotion head and the
HTTP server) and its dual-loss training path (teacher-forced
encoder-decoder with flash attention forward and backward, AdamW with
warmup and decay, the train_whisper CLI). The JAX package `audio_transformers_tpu` stays the
reference; this package imports only its JAX-free modules (configs,
audio IO, tokenizer, datasets and batcher, metric logger, micro-batcher,
HTTP handler).

Subpackages:
  core/      parameter trees (the weights bridge from JAX, a seeded init,
             trainable leaves) and the step timer
  ops/       nn primitives, log-mel, logit processors, flash attention, and
             the hand-written CUDA kernels (csrc/) with their plain PyTorch
             versions
  models/    whisper encoder-decoder, greedy decode, emotion head
  infer/     EmotionWhisperPipeline
  serve/     HTTP entry point over the reference package's handler
  train/     optimizer and schedules, the whisper-emotion trainer
  cli/       train_whisper
"""

__version__ = "0.1.0"
