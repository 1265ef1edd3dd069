"""The port's recorder of spans and counters, in memory, off by default.

    from audio_transformers_tpu_torch.core import tracing
    tracing.enable()
    ...                                  # the program runs
    records = tracing.drain()            # spans, counters, launches
    tracing.disable()
    tracing.export_chrome("trace.json", records)

The program opens spans at its layer boundaries (`with
tracing.span("decode.step"):`) and counts at the same places
(`tracing.count("pipeline.padded_rows", n)`). Only `enable()` turns the
recorder on: no environment variable or config field does. While it is
off, `span` returns one shared no-op context (it allocates nothing and
reads no clock) and `count` tests one flag.

A span records its name, start and end (`time.perf_counter_ns()`, the
host clock the benchmark's spans and its device trace are aligned to),
its parent (the innermost span open on the same thread), its thread and
its call: the id of the top-level span it belongs to, so the spans of one
`analyze_windows` call or one train step share it. A span opened on a
thread that has none open while a call is open elsewhere (autograd's
thread in the backward, which runs remat's recompute) joins that call,
with the innermost span then open in the call's own thread as its
parent. Calls are taken to run one at a time. Counters are kept per
call.

`span(name, device=...)` with a CUDA device also records a CUDA event
pair on the device's current stream; `drain` resolves the pairs after one
synchronise, never on the hot path. While a `torch.profiler` session
records, each span also enters `torch.profiler.record_function(name)`,
so the spans appear in any profiler trace. `drain` also returns the
kernel launch counters of `ops/_build.STATS` as they stand (it counts no
launch itself).
"""

from __future__ import annotations

import functools
import itertools
import json
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

_on = False
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_spans: List["Span"] = []
_events: list = []                       # (span, start event, end event)
_counts: Dict[Tuple[str, Optional[int]], int] = {}
_call: Optional[int] = None              # the open top-level span's id
_call_stack: list = []                   # the stack of its thread


@dataclass
class Span:
    name: str
    id: int
    parent: Optional[int]
    call: int
    thread: int
    t0: int                              # ns, time.perf_counter_ns()
    t1: int = 0
    device_ms: Optional[float] = None    # the CUDA event pair's time

    @property
    def ns(self) -> int:
        return self.t1 - self.t0


@dataclass
class Records:
    """What `drain` returns: the closed spans in the order they closed,
    the counters by (name, call) and the kernel launch counters."""
    spans: List[Span]
    counts: Dict[Tuple[str, Optional[int]], int]
    launches: Dict[str, int]

    def counter(self, name: str, calls=None) -> int:
        """The counter `name` summed over `calls` (ids), or over all."""
        return sum(n for (k, c), n in self.counts.items()
                   if k == name and (calls is None or c in calls))

    def of(self, name: str, calls=None) -> List[Span]:
        return [s for s in self.spans
                if s.name == name and (calls is None or s.call in calls)]

    def children(self, span: Span, name: Optional[str] = None
                 ) -> List[Span]:
        return [s for s in self.spans if s.parent == span.id
                and (name is None or s.name == name)]


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    """A span being recorded."""
    __slots__ = ("name", "device", "span", "stack", "top", "events",
                 "annotation")

    def __init__(self, name: str, device):
        self.name, self.device = name, device

    def __enter__(self):
        global _call, _call_stack
        stack = _stack()
        sid = next(_ids)
        self.top = False
        if stack:
            parent, call = stack[-1].id, stack[-1].call
        else:
            with _lock:
                if _call is None:
                    _call, _call_stack, self.top = sid, stack, True
                call = _call
                parent = (_call_stack[-1].id
                          if not self.top and _call_stack else None)
        self.span = Span(self.name, sid, parent, call, threading.get_ident(),
                         time.perf_counter_ns())
        self.annotation = None
        if torch.autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.events = None
        if self.device is not None:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(self.device))
        stack.append(self.span)
        self.stack = stack
        return self.span

    def __exit__(self, *exc):
        global _call
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        self.span.t1 = time.perf_counter_ns()
        self.stack.pop()
        with _lock:
            _spans.append(self.span)
            if self.events is not None:
                _events.append((self.span, *self.events))
            if self.top:
                _call = None
        return False


def enabled() -> bool:
    return _on


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    """Stops recording; what was recorded stays until `drain`."""
    global _on
    _on = False


def span(name: str, *, device=None):
    """A context that records the span `name` while the recorder is on;
    with a CUDA `device` (a torch.device or its string) it also records a
    CUDA event pair on that device's current stream."""
    if not _on:
        return _NOOP
    if device is not None and torch.device(device).type != "cuda":
        device = None
    return _Open(name, device)


def spanned(name: str):
    """A decorator: each call of the function is a span `name` while the
    recorder is on."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Open(name, None):
                return fn(*args, **kwargs)
        return traced
    return wrap


def count(name: str, n: int = 1) -> None:
    """Adds n to the counter `name` of the open call."""
    if not _on:
        return
    stack = _stack()
    call = stack[-1].call if stack else _call
    with _lock:
        _counts[(name, call)] = _counts.get((name, call), 0) + n


def drain() -> Records:
    """Every span closed and every count made since the last drain (and
    clears them), with each CUDA event pair's time, and the kernel launch
    counters as they stand."""
    global _spans, _events, _counts
    from audio_transformers_tpu_torch.ops import _build
    with _lock:
        spans, events, counts = _spans, _events, _counts
        _spans, _events, _counts = [], [], {}
    if events:
        torch.cuda.synchronize()
        for s, e0, e1 in events:
            s.device_ms = e0.elapsed_time(e1)
    return Records(spans, counts,
                   {k: v.launches for k, v in _build.STATS.items()})


def export_chrome(path: str, records: Optional[Records] = None) -> None:
    """Writes `records` (by default `drain()`) as Chrome-trace JSON, which
    Perfetto and chrome://tracing open: one complete event a span (times
    in us of the host clock), its id, parent, call and device time under
    "args", and the counters under "counters"."""
    records = drain() if records is None else records
    events = [{"name": s.name, "ph": "X", "pid": 0, "tid": s.thread,
               "ts": s.t0 / 1e3, "dur": s.ns / 1e3,
               "args": {"id": s.id, "parent": s.parent, "call": s.call,
                        "device_ms": s.device_ms}}
              for s in sorted(records.spans, key=lambda s: s.t0)]
    counters: Dict[str, int] = {}
    for (name, _), n in records.counts.items():
        counters[name] = counters.get(name, 0) + n
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "counters": counters, "launches": records.launches}, f)
