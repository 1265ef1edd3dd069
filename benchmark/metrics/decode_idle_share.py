"""The share of the traced batch's `decode.step` span time (the
program's spans) in which no device operation ran."""

from benchmark.harness import program_spans

NAME = "decode_idle_share"
UNIT = "%"
LAYER = "decode loop (models/whisper/decode.generate)"
MOVES = "audio_s_per_s"

program_spans.install()


def read(ctx):
    return program_spans.idle_share(ctx, "decode.step")
