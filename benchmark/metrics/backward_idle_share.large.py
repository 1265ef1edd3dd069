"""The share of the traced steps' `train.backward` span time (the
program's spans) in which no device operation ran."""

from benchmark.harness import program_spans

NAME = "backward_idle_share.large"
UNIT = "%"
LAYER = "train step (train/whisper_emotion.make_steps)"
MOVES = "train_clips_per_s.large"

program_spans.install()


def read(ctx):
    return program_spans.idle_share(ctx, "train.backward")
