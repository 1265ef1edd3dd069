"""Serve the port's pipeline over HTTP.

The HTTP layer is the reference package's JAX-free stdlib server
(`audio_transformers_tpu.serve.http_server.make_handler`/`serve`: a JSON
`POST /analyze` with a wav or flac body, `/health`, `/stats`, a demo page)
and its cross-request `MicroBatcher`; only the pipeline behind it is the
port's. Run:

    python -m audio_transformers_tpu_torch.serve.http_server \
        [--params bridged.pt] [--config tiny|test] [--port 8501]

Without `--params` the weights are a seeded random init. A `.pt` file
holds a port parameter tree (`core.params.from_jax_params` of a JAX tree,
saved with `torch.save`).
"""

from __future__ import annotations

import argparse

import torch

from audio_transformers_tpu.serve.batching import MicroBatcher
from audio_transformers_tpu.serve.http_server import make_handler, serve
from audio_transformers_tpu_torch.core import (EmotionWhisperConfig,
                                               WhisperConfig)
from audio_transformers_tpu_torch.core.params import init
from audio_transformers_tpu_torch.infer.pipeline import EmotionWhisperPipeline

__all__ = ["MicroBatcher", "build_pipeline", "main", "make_handler", "serve"]


def build_pipeline(*, config: str = "tiny", params_path=None,
                   kv_quant: str = "none",
                   num_beams: int = 1) -> EmotionWhisperPipeline:
    """The port's pipeline from a saved parameter tree (its emotion head
    gives the class count) or from a seeded init with 10 classes: on the
    GPU in bfloat16 when there is one, else on the CPU in float32.
    num_beams > 1 serves beam-search decoding."""
    cuda = torch.cuda.is_available()
    if params_path:
        params = torch.load(params_path, map_location="cpu")
        n_classes = params["emotion_head"]["w"].shape[0]
    else:
        params, n_classes = None, 10
    cfg = EmotionWhisperConfig(whisper=WhisperConfig.by_name(config),
                               num_emotion_classes=n_classes)
    if params is None:
        params = init(cfg, torch.Generator().manual_seed(0))
    return EmotionWhisperPipeline(
        params, cfg, device="cuda" if cuda else "cpu",
        compute_dtype=torch.bfloat16 if cuda else torch.float32,
        kv_quant=kv_quant, num_beams=num_beams)


def main(argv=None):
    p = argparse.ArgumentParser(description="Serve the emotion demo (PyTorch)")
    p.add_argument("--params", default=None,
                   help=".pt of a port parameter tree; default: seeded init")
    p.add_argument("--config", default="tiny",
                   help="whisper size name (tiny, base, ..., test)")
    p.add_argument("--kv_quant", default="none", choices=["none", "int8"])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8501)
    p.add_argument("--segment_duration", type=float, default=5.0)
    p.add_argument("--no_microbatch", action="store_true")
    p.add_argument("--microbatch_wait_ms", type=float, default=10.0)
    args = p.parse_args(argv)
    pipeline = build_pipeline(config=args.config, params_path=args.params,
                              kv_quant=args.kv_quant)
    serve(pipeline, host=args.host, port=args.port,
          segment_duration=args.segment_duration,
          microbatch=not args.no_microbatch,
          max_wait_ms=args.microbatch_wait_ms)


if __name__ == "__main__":
    main()
