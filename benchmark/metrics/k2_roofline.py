"""K2's share of its roofline: each launch reads the padded bf16 table,
the additive vector and the seen and ban masks once (bound by bytes at
3.35 TB/s), over K2's device time (greedy_step_sm90)."""

from benchmark.harness import readers

NAME = "k2_roofline"
UNIT = "%"
LAYER = "greedy step (K2, ops/decode_logits.py)"
MOVES = "audio_s_per_s"


def read(ctx):
    return readers.kernel_roofline(
        ctx, ("greedy_step_sm90",),
        readers.counts.greedy_step_bytes(ctx.dims, ctx.cell.batch))
