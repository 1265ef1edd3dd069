"""The share of the window's `encode` calls whose self-attention took K4a
(the flash route): the program's counter `encode.attn.flash` over
`encode.attn.flash` and `encode.attn.xla`, summed over the window's calls.
None where the program counts neither route (a program without the
counters)."""

from benchmark.harness import program_spans

NAME = "encoder_flash_share"
UNIT = "%"
LAYER = "encoder (models/whisper/model.encode)"
MOVES = "audio_s_per_s"

program_spans.install()


def read(ctx):
    got = program_spans.window(ctx)
    if got is None:
        return None
    rec, calls = got
    flash = rec.counter("encode.attn.flash", calls)
    calls_counted = flash + rec.counter("encode.attn.xla", calls)
    if not calls_counted:
        return None
    return 100.0 * flash / calls_counted
