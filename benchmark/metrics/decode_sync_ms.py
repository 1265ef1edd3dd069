"""Host time a greedy decode step waits in the loop's one device read:
the program's `decode.sync` spans summed over the window's calls, over
their `decode.steps` (the decoder steps, the final feed included)."""

from benchmark.harness import program_spans

NAME = "decode_sync_ms"
UNIT = "ms"
LAYER = "decode loop (models/whisper/decode.generate)"
MOVES = "audio_s_per_s"

program_spans.install()


def read(ctx):
    return program_spans.decode_ms(ctx, "sync")
