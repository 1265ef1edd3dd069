"""What the omni cells' per-layer metrics read: the program's own spans
and routing counters (`program_spans`), over the window's calls of
`OmniPipeline.generate` (or those inside the device trace), per batch.
Each returns None when the run holds nothing to read."""

from __future__ import annotations

from typing import Dict, Optional

from benchmark.harness import counts, omni_counts, program_spans


def span_ms_per_batch(ctx, name: str) -> Optional[float]:
    """Device ms (the spans' CUDA events) of the window's spans `name`,
    summed, over its calls."""
    got = program_spans.window(ctx)
    if got is None:
        return None
    rec, calls = got
    ms = [s.device_ms for s in rec.of(name, calls) if s.device_ms is not None]
    return sum(ms) / len(calls) if ms else None


def span_ms_mean(ctx, name: str) -> Optional[float]:
    """Mean device ms of the window's spans `name`."""
    got = program_spans.window(ctx)
    if got is None:
        return None
    ms = [s.device_ms for s in got[0].of(name, got[1])
          if s.device_ms is not None]
    return sum(ms) / len(ms) if ms else None


def counters(rec, calls) -> Dict[str, int]:
    return {k: rec.counter(k, calls) for k, _ in rec.counts}


def traced_calls(ctx):
    """(records, ids of the calls that lie inside the device trace)."""
    t, rec = ctx.trace, program_spans.records()
    if t is None or not t.records or rec is None:
        return None
    calls = {s.id for s in rec.spans if s.call == s.id
             and s.t0 >= t.t0 and s.t1 <= t.t1}
    return (rec, calls) if calls else None


def expert_gemm_roofline(ctx) -> Optional[float]:
    got = traced_calls(ctx)
    if got is None:
        return None
    n, dev_s = ctx.trace.by_name("k6_gate_up", "k6_down")
    c = counters(*got)
    if not n or dev_s <= 0 or not omni_counts.routed_rows(c, ctx.dims.experts):
        return None
    return omni_counts.expert_gemm_roofline(ctx.dims, c, dev_s)


def batch_shape(ctx):
    """(windows, tokens fed to the prefill, causal (token, key) pairs over
    the prefill and every step) of a batch (every batch of a mix has the
    same lengths)."""
    cell = ctx.cell
    counts_w, _ = cell._windows()
    prompts = cell.pool[0][1]
    new = cell.mix["max_new_tokens"]
    lengths = [len(p) + ctx.dims.audio_tokens * n
               for p, n in zip(prompts, counts_w)]
    pairs = sum(n * (n + 1) / 2 + sum(n + s + 1 for s in range(new - 1))
                for n in lengths)
    return sum(counts_w), sum(lengths), pairs


def mfu(ctx) -> Optional[float]:
    got = program_spans.window(ctx)
    if got is None:
        return None
    c = counters(*got)
    if not omni_counts.routed_rows(c, ctx.dims.experts):
        return None
    per_batch = {k: v / len(got[1]) for k, v in c.items()}
    windows, tokens, pairs = batch_shape(ctx)
    flops = omni_counts.batch_flops(ctx.dims, per_batch, windows, tokens,
                                    ctx.cell.batch,
                                    ctx.cell.mix["max_new_tokens"], pairs)
    return 100.0 * flops * ctx.cell.rate_batches / counts.PEAK_BF16_FLOPS
