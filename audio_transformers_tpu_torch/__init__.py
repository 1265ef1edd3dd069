"""The PyTorch/CUDA port of audio_transformers_tpu.

The serving path of the EmotionWhisper model on an NVIDIA Hopper GPU:
log-mel front end, whisper encoder, precomputed cross K/V, KV-cached
greedy decode with the HF logit-processor chain, emotion head and the
HTTP server. The JAX package `audio_transformers_tpu` stays the
reference; this package imports only its JAX-free modules (configs,
audio IO, tokenizer, metrics, micro-batcher, HTTP handler).

Subpackages:
  core/      parameter trees: the weights bridge from JAX and a seeded init
  ops/       nn primitives, log-mel, logit processors, and the hand-written
             CUDA kernels (csrc/) with their plain PyTorch versions
  models/    whisper encoder-decoder, greedy decode, emotion head
  infer/     EmotionWhisperPipeline
  serve/     HTTP entry point over the reference package's handler
"""

__version__ = "0.1.0"
