"""Device time of the MoE FFN a batch: the program's `moe` spans (CUDA
events around each layer's routing, dispatch, K6, shared experts and
combine), summed over the window's calls of `OmniPipeline.generate`, over
the calls."""

from benchmark.harness import omni_readers, program_spans

NAME = "moe_ms.omni"
UNIT = "ms"
LAYER = "MoE FFN (models/unimoe/model.moe)"
MOVES = "audio_s_per_s"

program_spans.install()


def read(ctx):
    return omni_readers.span_ms_per_batch(ctx, "moe")
