"""The PyTorch/CUDA port of audio_transformers_tpu.

The serving path of the EmotionWhisper model on an NVIDIA Hopper GPU
(log-mel front end, whisper encoder, precomputed cross K/V, KV-cached
greedy decode with the HF logit-processor chain, emotion head and the
HTTP server) and its dual-loss training path (teacher-forced
encoder-decoder with flash attention forward and backward, AdamW with
warmup and decay, the train_whisper CLI), beam search, segment-level
evaluation and model I/O (HF directories both ways, checkpoints and
resume, the infer and evaluate CLIs), and the UrbanSound classifier
(conv front end, encoder and CNN head; its trainer with SpecAugment, its
data path and the train_classifier CLI). The JAX package
`audio_transformers_tpu` stays the reference; this package imports
nothing of it and keeps its own copies of its JAX-free modules (configs,
audio IO, tokenizer, datasets and batcher, metric logger, micro-batcher,
HTTP handler).

Subpackages:
  core/      parameter trees (the weights bridge from JAX, a seeded init,
             trainable leaves), checkpoints and the step timer
  ops/       nn primitives, log-mel, SpecAugment, logit processors, flash
             attention, and the hand-written CUDA kernels (csrc/) with
             their plain PyTorch versions
  models/    whisper encoder-decoder, greedy and beam decode, emotion
             head, HF weight loading; the UrbanSound classifier
  infer/     EmotionWhisperPipeline, evaluation and its metrics
  serve/     HTTP entry point and micro-batcher
  train/     optimizer and schedules, the whisper-emotion and classifier
             trainers
  utils/     audio IO, the safetensors reader and writer, HF export
  data/      datasets, batcher, native loader and waveform cache
  cli/       train_whisper, train_classifier, infer, evaluate,
             evaluate_simple
"""

__version__ = "0.1.0"
