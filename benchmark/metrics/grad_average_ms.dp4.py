"""Host time of a data-parallel train step's gradient exchange: the
program's `train.grad_average` spans on rank 0 (`average_gradients`:
the flat bucket's copy in, the all-reduce issued, the division, the
copy back), mean over the window's steps."""

from benchmark.harness import program_spans

NAME = "grad_average_ms.dp4"
UNIT = "ms"
LAYER = "gradient all-reduce (parallel/mesh.average_gradients)"
MOVES = "train_clips_per_s.dp4"

program_spans.install()


def read(ctx):
    return program_spans.mean_ms(ctx, "train.grad_average")
