"""Model FLOPs per clip (the forward three times; remat's recompute not
counted) times the window's clips per second, over 989 TFLOP/s bf16."""

from benchmark.harness import readers

NAME = "mfu.large"
UNIT = "%"
LAYER = "train step (train/whisper_emotion.make_steps)"
MOVES = "train_clips_per_s.large"


def read(ctx):
    return readers.mfu_train(ctx)
