"""The share of the traced batch's host-clock time in which no device
operation ran."""

from benchmark.harness import readers

NAME = "idle_share.omni"
UNIT = "%"
LAYER = "device"
MOVES = "audio_s_per_s"


def read(ctx):
    return readers.idle_share(ctx)
