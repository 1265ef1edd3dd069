"""FLOPs of a batch as the routing actually did it (`harness/omni_counts
.batch_flops`: the encoder of its windows, every fed token through the
layers, the routed experts' counted rows, the head at each pick), times
the window's batches per second, over 989 TFLOP/s bf16."""

from benchmark.harness import omni_readers, program_spans

NAME = "mfu.omni"
UNIT = "%"
LAYER = "omni pipeline (infer/omni.py)"
MOVES = "audio_s_per_s"

program_spans.install()


def read(ctx):
    return omni_readers.mfu(ctx)
