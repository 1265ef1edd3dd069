"""K4's share of its roofline in a train step: the flash-attention calls'
operations at the cell's shapes (forward and backward of the encoder's
self-attention, the decoder's causal self- and cross-attention; bound by
operations at 989 TFLOP/s bf16) over K4's device time (fwd_sm90,
dq_sm90, dkv_sm90) per traced step."""

from benchmark.harness import readers

NAME = "k4_roofline.large"
UNIT = "%"
LAYER = "attention, training (K4, ops/attention.py)"
MOVES = "train_clips_per_s.large"


def read(ctx):
    return readers.k4_train(ctx)
