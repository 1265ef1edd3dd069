"""K6's share of its roofline: the least time the traced batch's routed
work allows (its counted rows and active experts, `harness/omni_counts`:
6 D F flops a row at 989 TFLOP/s, or each active expert's weights read
once a call and each row's activations at 3.35 TB/s, the larger), over
the device time of K6's kernels (k6_gate_up_sm90, k6_down_sm90) in the
trace. The bound is taken over the batch's sums, so the share never
overstates."""

from benchmark.harness import omni_readers, program_spans

NAME = "expert_gemm_roofline.omni"
UNIT = "%"
LAYER = "MoE FFN (models/unimoe/model.moe)"
MOVES = "audio_s_per_s"

program_spans.install()


def read(ctx):
    return omni_readers.expert_gemm_roofline(ctx)
