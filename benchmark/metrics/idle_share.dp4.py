"""The share of the traced block's host-clock time in which no device
operation ran on rank 0's card."""

from benchmark.harness import readers

NAME = "idle_share.dp4"
UNIT = "%"
LAYER = "device"
MOVES = "train_clips_per_s.dp4"


def read(ctx):
    return readers.idle_share(ctx)
