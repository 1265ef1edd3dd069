"""The share of the window's decoder steps that replayed the captured
step: the program's counter `decode.graph_replays` over its
`decode.steps`, summed over the window's calls. None where the program
counts no replay (a program without the captured step)."""

from benchmark.harness import program_spans

NAME = "decode_graph_share"
UNIT = "%"
LAYER = "decode loop (models/whisper/decode.generate)"
MOVES = "audio_s_per_s"

program_spans.install()


def read(ctx):
    got = program_spans.window(ctx)
    if got is None:
        return None
    rec, calls = got
    if not any(name == "decode.graph_replays" for name, _ in rec.counts):
        return None
    steps = rec.counter("decode.steps", calls)
    if not steps:
        return None
    return 100.0 * rec.counter("decode.graph_replays", calls) / steps
