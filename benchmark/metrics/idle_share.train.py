"""The share of the traced block's host-clock time in which no device
operation ran."""

from benchmark.harness import readers

NAME = "idle_share.train"
UNIT = "%"
LAYER = "device"
MOVES = "train_clips_per_s"


def read(ctx):
    return readers.idle_share(ctx)
