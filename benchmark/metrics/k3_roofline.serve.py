"""K3's share of its roofline in `analyze_windows`: the float32 waveform
of the batch read once and its features written once (bound by bytes at
3.35 TB/s), over K3's device time (mel_kernel)."""

from benchmark.harness import readers

NAME = "k3_roofline.serve"
UNIT = "%"
LAYER = "front end (K3, ops/mel.py)"
MOVES = "audio_s_per_s"


def read(ctx):
    return readers.kernel_roofline(
        ctx, ("mel_kernel",),
        readers.counts.mel_bytes(ctx.dims, ctx.cell.batch))
