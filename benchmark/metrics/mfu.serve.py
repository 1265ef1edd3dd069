"""FLOPs of a batch from its shapes (encoder, cross K/V, every decoder
step, the vocabulary projection of each picked token) times the
window's batches per second, over 989 TFLOP/s bf16."""

from benchmark.harness import readers

NAME = "mfu.serve"
UNIT = "%"
LAYER = "pipeline (infer/pipeline.py)"
MOVES = "audio_s_per_s"


def read(ctx):
    return readers.mfu_serve(ctx)
