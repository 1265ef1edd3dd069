"""K3's share of its roofline in a train step: the float32 waveform read
once and the features written once (bound by bytes at 3.35 TB/s) over
K3's device time (mel_kernel) per traced step."""

from benchmark.harness import readers

NAME = "k3_roofline.train"
UNIT = "%"
LAYER = "front end (K3, ops/mel.py)"
MOVES = "train_clips_per_s"


def read(ctx):
    return readers.kernel_roofline(
        ctx, ("mel_kernel",),
        readers.counts.mel_bytes(ctx.dims, ctx.cell.batch))
