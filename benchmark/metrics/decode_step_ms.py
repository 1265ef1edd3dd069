"""Host time of the window's `generate` calls over the decoder steps they
ran."""

from benchmark.harness import readers

NAME = "decode_step_ms"
UNIT = "ms"
LAYER = "decode loop (models/whisper/decode.generate)"
MOVES = "audio_s_per_s"


def read(ctx):
    return readers.decode_step_ms(ctx)
