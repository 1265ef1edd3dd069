"""Device time of one AdamW step (the benchmark's optimizer object's
`step`), CUDA events around each call, mean over the window's steps."""

from benchmark.harness import readers

NAME = "optimizer_ms"
UNIT = "ms"
LAYER = "optimizer (train/optim.Optimizer.step)"
MOVES = "train_clips_per_s"


def read(ctx):
    return readers.mean(ctx.spans.cuda_ms("optimizer.step", ctx.cell.t0_ns))
