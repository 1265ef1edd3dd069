"""Device time of one greedy decode step of the omni pipeline: the
program's `omni.decode.step` spans (CUDA events around the 28 layers over
the cache and K2's pick), their mean over the window's calls."""

from benchmark.harness import omni_readers, program_spans

NAME = "decode_step_ms.omni"
UNIT = "ms"
LAYER = "omni decode loop (infer/omni.OmniPipeline.generate)"
MOVES = "audio_s_per_s"

program_spans.install()


def read(ctx):
    return omni_readers.span_ms_mean(ctx, "omni.decode.step")
