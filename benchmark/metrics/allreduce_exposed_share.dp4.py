"""The share of rank 0's traced steps in which a collective (NCCL) kernel
runs on its card and no other device operation beside it: the exchange
that computation does not hide, the wait for the slowest rank
included."""

from benchmark.harness.tracing import merged

NAME = "allreduce_exposed_share.dp4"
UNIT = "%"
LAYER = "gradient all-reduce (parallel/mesh.average_gradients)"
MOVES = "train_clips_per_s.dp4"


def exposed_ns(records) -> float:
    """The time covered by a NCCL record and by no other record."""
    nccl = merged([(s, e) for n, s, e in records if "nccl" in n.lower()])
    other = merged([(s, e) for n, s, e in records if "nccl" not in n.lower()])
    total, j = 0.0, 0
    for s, e in nccl:
        total += e - s
        while j < len(other) and other[j][1] <= s:
            j += 1
        k = j
        while k < len(other) and other[k][0] < e:
            total -= min(e, other[k][1]) - max(s, other[k][0])
            k += 1
    return total


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or not any(
            "nccl" in n.lower() for n, _, _ in t.records):
        return None
    return 100.0 * exposed_ns(t.records) / 1e9 / t.window_s
