"""Host time a greedy decode step spends issuing its work: the program's
`decode.step` spans less their `decode.sync` child (the loop's device
read), summed over the window's calls, over their `decode.steps` (the
decoder steps, the final feed included)."""

from benchmark.harness import program_spans

NAME = "decode_issue_ms"
UNIT = "ms"
LAYER = "decode loop (models/whisper/decode.generate)"
MOVES = "audio_s_per_s"

program_spans.install()


def read(ctx):
    return program_spans.decode_ms(ctx, "issue")
