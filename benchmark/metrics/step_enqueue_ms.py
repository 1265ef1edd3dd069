"""Host time of one train_step call (the enqueue: no synchronise inside),
mean over the window's steps, host clock."""

from benchmark.harness import readers

NAME = "step_enqueue_ms"
UNIT = "ms"
LAYER = "train step (train/whisper_emotion.make_steps)"
MOVES = "train_clips_per_s"


def read(ctx):
    return readers.mean(ctx.spans.host_ms("train_step", ctx.cell.t0_ns))
