"""Arithmetic the per-layer metrics' readers share. Each returns None when
its run holds nothing to read (no trace, no matching kernel, no span),
never 0 for a share."""

from __future__ import annotations

from typing import Optional, Sequence

from benchmark.harness import counts  # noqa: F401  (used by the readers)


def mean(values: Sequence[float]) -> Optional[float]:
    return sum(values) / len(values) if values else None


def idle_share(ctx) -> Optional[float]:
    t = ctx.trace
    if t is None or not t.records or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)


def kernel_roofline(ctx, needles, bytes_per_launch: float
                    ) -> Optional[float]:
    """A bytes-bound kernel's share: the launches' bytes over the memory
    rate, over their device time."""
    t = ctx.trace
    if t is None:
        return None
    n, dev_s = t.by_name(*needles)
    if not n or dev_s <= 0:
        return None
    return 100.0 * n * bytes_per_launch / counts.HBM_BYTES_PER_S / dev_s


def k4_train(ctx) -> Optional[float]:
    t = ctx.trace
    if t is None:
        return None
    n, dev_s = t.by_name("fwd_sm90", "dq_sm90", "dkv_sm90")
    if not n or dev_s <= 0:
        return None
    flops, byts = counts.train_attention(ctx.dims, ctx.cell.batch,
                                         ctx.cell.t_dec)
    bound_s, _ = counts.bound(byts, flops)
    return 100.0 * bound_s * ctx.cell.traced_steps / dev_s


def mfu_train(ctx) -> Optional[float]:
    flops = counts.train_flops_per_clip(ctx.dims, ctx.cell.t_dec)
    return 100.0 * flops * ctx.cell.rate / counts.PEAK_BF16_FLOPS


def _steps_per_call(ctx) -> Optional[float]:
    calls = ctx.spans.of("generate", ctx.cell.t0_ns)
    steps = ctx.spans.of("decoder_step", ctx.cell.t0_ns)
    return len(steps) / len(calls) if calls and steps else None


def decode_step_ms(ctx) -> Optional[float]:
    ms = ctx.spans.host_ms("generate", ctx.cell.t0_ns)
    steps = ctx.spans.of("decoder_step", ctx.cell.t0_ns)
    return sum(ms) / len(steps) if ms and steps else None


def launches_per_step(ctx) -> Optional[float]:
    t = ctx.trace
    if t is None or not t.records:
        return None
    heads = [s for s, _ in ctx.spans.of("emotion_head", t.t0)]
    launches = steps = 0
    for g0, g1 in ctx.spans.of("generate", t.t0):
        if g1 > t.t1:
            continue
        end = min([h for h in heads if h >= g1] or [g1])
        launches += t.in_span(g0, end)
        steps += sum(1 for s, _ in ctx.spans.of("decoder_step", g0)
                     if s < g1)
    return launches / steps if steps else None


def mfu_serve(ctx) -> Optional[float]:
    steps = _steps_per_call(ctx)
    if steps is None:
        return None
    flops = ctx.cell.batch * counts.analyze_flops_per_window(
        ctx.dims, round(steps), ctx.cell.prompt_len)
    return 100.0 * flops * ctx.cell.rate_batches / counts.PEAK_BF16_FLOPS
