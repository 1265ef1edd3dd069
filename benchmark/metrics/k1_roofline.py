"""K1's share of its roofline: each launch (one layer of one step) reads
the bf16 cross K/V of every row and q once and writes the output (bound
by bytes at 3.35 TB/s), over K1's device time (dca_split)."""

from benchmark.harness import readers

NAME = "k1_roofline"
UNIT = "%"
LAYER = "cross-attention (K1, ops/decode_attention.py)"
MOVES = "audio_s_per_s"


def read(ctx):
    return readers.kernel_roofline(
        ctx, ("dca_split",),
        readers.counts.cross_attention_bytes(ctx.dims, ctx.cell.batch))
