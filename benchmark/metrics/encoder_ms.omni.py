"""Device time of the whisper encoder a batch in the omni pipeline: the
program's `encode` spans (CUDA events, one a bucket of at most 32
windows), summed over the window's calls, over the calls."""

from benchmark.harness import omni_readers, program_spans

NAME = "encoder_ms.omni"
UNIT = "ms"
LAYER = "encoder (models/whisper/model.encode)"
MOVES = "audio_s_per_s"

program_spans.install()


def read(ctx):
    return omni_readers.span_ms_per_batch(ctx, "encode")
