"""Device time of one encoder call (one batch of windows), CUDA events
around each `encode` call, mean over the window's batches."""

from benchmark.harness import readers

NAME = "encoder_ms"
UNIT = "ms"
LAYER = "encoder (models/whisper/model.encode)"
MOVES = "audio_s_per_s"


def read(ctx):
    return readers.mean(ctx.spans.cuda_ms("encode", ctx.cell.t0_ns))
