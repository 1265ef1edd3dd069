"""Device operations recorded inside the traced `generate` calls (from a
call's start to the emotion head's) over the decoder steps they ran."""

from benchmark.harness import readers

NAME = "launches_per_step"
UNIT = "launches"
LAYER = "decode loop (models/whisper/decode.generate)"
MOVES = "audio_s_per_s"


def read(ctx):
    return readers.launches_per_step(ctx)
