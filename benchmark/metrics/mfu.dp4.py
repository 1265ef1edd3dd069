"""Model FLOPs per clip (the forward three times; remat's recompute not
counted) times the window's clips per second over every card, over the
cards' 989 TFLOP/s bf16 each."""

from benchmark.harness import counts

NAME = "mfu.dp4"
UNIT = "%"
LAYER = "train step (train/whisper_emotion.make_steps)"
MOVES = "train_clips_per_s.dp4"


def read(ctx):
    c = ctx.cell
    flops = counts.train_flops_per_clip(ctx.dims, c.t_dec)
    return 100.0 * flops * c.rate / (c.world * counts.PEAK_BF16_FLOPS)
