"""Host time of a train step's backward: the program's `train.backward`
spans (`loss.backward()`, remat's recompute included), mean over the
window's steps."""

from benchmark.harness import program_spans

NAME = "backward_issue_ms.large"
UNIT = "ms"
LAYER = "train step (train/whisper_emotion.make_steps)"
MOVES = "train_clips_per_s.large"

program_spans.install()


def read(ctx):
    return program_spans.mean_ms(ctx, "train.backward")
