"""The program's own spans and counters, for the per-layer metrics that
read them.

The port records spans and counters at its layer boundaries through its
recorder (`audio_transformers_tpu_torch/core/tracing.py`, off unless
enabled). Here the recorder is on for the whole of a traced run: from the
harness's `Spans` of a run with events, which `cell.run` makes right
before it builds the cell and only when `trace` is true, to that
`Spans`'s `close` in `cell.run`'s `finally`. `install` attaches this to
the `Spans` class; each metric module that reads the recorder calls it
when `registry.find` loads it, before `cell.run` makes the `Spans`. The
first reader's call of `records` turns the recorder off and drains it;
the records stay here until the next traced run begins.

Against a program that has no recorder, `install` does nothing and every
reader returns None. Like `program.py`, this module reaches the program
only through its public names.
"""

from __future__ import annotations

import bisect
from typing import Optional, Set, Tuple

from benchmark.harness.tracing import Spans, merged

_state = {"installed": False, "owner": None, "records": None}


def recorder():
    """The program's recorder module, or None where it has none."""
    try:
        from audio_transformers_tpu_torch.core import tracing
    except ImportError:
        return None
    return tracing


def install() -> None:
    """Turns the recorder on with each `Spans(events=True)` and off and
    drained at its `close` (once; later calls do nothing)."""
    rec = recorder()
    if _state["installed"] or rec is None:
        return
    _state["installed"] = True
    init, close = Spans.__init__, Spans.close

    def traced_init(self, events: bool):
        init(self, events)
        if events:
            rec.disable()
            rec.drain()
            _state.update(owner=self, records=None)
            rec.enable()

    def traced_close(self):
        close(self)
        if _state["owner"] is self:
            records()
            _state["owner"] = None

    Spans.__init__, Spans.close = traced_init, traced_close


def records():
    """The traced run's `tracing.Records`, or None: the first call turns
    the recorder off and drains it."""
    if _state["records"] is None and _state["owner"] is not None:
        rec = recorder()
        rec.disable()
        _state["records"] = rec.drain()
    return _state["records"]


def window(ctx) -> Optional[Tuple[object, Set[int]]]:
    """(records, the ids of the calls that began in the window)."""
    rec = records()
    if rec is None:
        return None
    calls = {s.id for s in rec.spans
             if s.call == s.id and s.t0 >= ctx.cell.t0_ns}
    return (rec, calls) if calls else None


def decode_ms(ctx, part: str) -> Optional[float]:
    """Host ms of the window's decode steps over its `decode.steps`:
    part "sync" is the `decode.sync` spans, "issue" the rest of each
    `decode.step`."""
    got = window(ctx)
    if got is None:
        return None
    rec, calls = got
    steps = rec.counter("decode.steps", calls)
    sync = {s.parent: s.ns for s in rec.of("decode.sync", calls)}
    if not steps or not sync:
        return None
    if part == "sync":
        total = sum(sync.values())
    else:
        total = sum(s.ns - sync.get(s.id, 0)
                    for s in rec.of("decode.step", calls))
    return total / steps / 1e6


def mean_ms(ctx, name: str) -> Optional[float]:
    """Mean host ms of the window's spans `name`."""
    got = window(ctx)
    if got is None:
        return None
    ns = [s.ns for s in got[0].of(name, got[1])]
    return sum(ns) / len(ns) / 1e6 if ns else None


def idle_share(ctx, name: str) -> Optional[float]:
    """The share (%) of the traced block's spans `name` in which no device
    record ran."""
    t, rec = ctx.trace, records()
    if t is None or not t.records or rec is None:
        return None
    spans = [s for s in rec.of(name) if s.t0 >= t.t0 and s.t1 <= t.t1]
    total = sum(s.ns for s in spans)
    if not total:
        return None
    busy = merged([(s, e) for _, s, e in t.records])
    ends = [e for _, e in busy]
    covered = 0.0
    for s in spans:
        for b0, b1 in busy[bisect.bisect_right(ends, s.t0):]:
            if b0 >= s.t1:
                break
            covered += min(b1, s.t1) - max(b0, s.t0)
    return 100.0 * (1.0 - covered / total)
