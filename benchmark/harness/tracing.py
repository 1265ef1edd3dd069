"""Spans around the program's layers and the device trace of a window.

`Spans` wraps, at run time, the names through which the program calls
its layers (a module attribute or an object's method) and records host
clock spans and, where asked, CUDA events around each call; `close`
restores every name. `DeviceTrace` runs `torch.profiler` over part of a
window and returns the device's records with host-clock times, aligned
by a marker kernel launched right after a synchronise.
"""

from __future__ import annotations

import bisect
import subprocess
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def busy_ms(intervals) -> float:
    """The union of [start, end) intervals (us), in ms."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def merged(intervals) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals as disjoint sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Spans:
    """Host-clock spans (and CUDA-event spans) around wrapped callables."""

    def __init__(self, events: bool):
        self.events = events and torch.cuda.is_available()
        self.host: List[Tuple[str, int, int]] = []     # name, t0, t1 (ns)
        # name -> [(t0, e0, e1)]: host start, CUDA events around the call
        self.cuda: Dict[str, list] = defaultdict(list)
        self._undo: list = []

    def wrap(self, owner, attr: str, name: str, *, cuda_events: bool = False,
             after: Optional[Callable] = None) -> None:
        """Replaces owner.attr by a wrapper that records a span `name`;
        `after(result, args, kwargs)` runs on each result."""
        orig = getattr(owner, attr)
        timed = cuda_events and self.events

        def wrapped(*args, **kwargs):
            t0 = time.perf_counter_ns()
            if timed:
                e0 = torch.cuda.Event(enable_timing=True)
                e0.record()
            out = orig(*args, **kwargs)
            if timed:
                e1 = torch.cuda.Event(enable_timing=True)
                e1.record()
                self.cuda[name].append((t0, e0, e1))
            self.host.append((name, t0, time.perf_counter_ns()))
            if after is not None:
                after(out, args, kwargs)
            return out

        setattr(owner, attr, wrapped)
        self._undo.append((owner, attr, orig))

    def hook(self, owner, attr: str, fn: Callable) -> None:
        """Replaces owner.attr by fn(orig) (for captures and planted
        faults); restored by `close` like a span."""
        orig = getattr(owner, attr)
        setattr(owner, attr, fn(orig))
        self._undo.append((owner, attr, orig))

    def close(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()

    def of(self, name: str, since: int = 0) -> List[Tuple[int, int]]:
        """(t0, t1) of the host spans `name` that began at `since` or
        later."""
        return [(t0, t1) for n, t0, t1 in self.host
                if n == name and t0 >= since]

    def host_ms(self, name: str, since: int = 0) -> List[float]:
        return [(t1 - t0) / 1e6 for t0, t1 in self.of(name, since)]

    def cuda_ms(self, name: str, since: int = 0) -> List[float]:
        return [e0.elapsed_time(e1) for t0, e0, e1 in self.cuda.get(name, [])
                if t0 >= since]

    def at(self, t_ns: float) -> str:
        """The innermost span covering host time t_ns (of nested spans,
        the latest to start), or "harness"."""
        if getattr(self, "_sorted_n", -1) != len(self.host):
            self._sorted = sorted(self.host, key=lambda s: s[1])
            self._starts = [s[1] for s in self._sorted]
            self._sorted_n = len(self.host)
        i = bisect.bisect_right(self._starts, t_ns) - 1
        for j in range(i, max(i - 64, -1), -1):
            name, t0, t1 = self._sorted[j]
            if t1 >= t_ns:
                return name
        return "harness"


class DeviceTrace:
    """torch.profiler over a block of calls: `records` are (name, start,
    end) of every device operation in host-clock ns; `window_s` the
    traced block's host-clock length."""

    def __init__(self):
        self.records: List[Tuple[str, float, float]] = []
        self.window_s = 0.0
        self.t0 = self.t1 = 0

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._mark = torch.empty(1, device="cuda")
        self.t0 = time.perf_counter_ns()
        self._mark.fill_(1.0)                 # the alignment marker
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.t1 = time.perf_counter_ns()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._read()
        return False

    def _read(self) -> None:
        from torch.autograd import DeviceType
        raw = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            if hasattr(e, "start_ns"):
                s, d = e.start_ns(), e.duration_ns()
            else:
                s, d = e.start_us() * 1e3, e.duration_us() * 1e3
            raw.append((e.name(), float(s), float(s + d)))
        raw.sort(key=lambda r: r[1])
        if not raw:
            return
        offset = raw[0][1] - self.t0        # the marker's start
        self.records = [(n, s - offset, e - offset) for n, s, e in raw[1:]]
        self.window_s = (self.t1 - self.t0) / 1e9

    # the program's kernel counters (`ops/_build.STATS`) -> the name its
    # kernel carries in the trace
    KERNELS = {"decode_cross_attention": ("dca_split",),
               "fused_greedy_step": ("greedy_step_sm90", "greedy_pass2"),
               "log_mel": ("mel_kernel",),
               "flash_attention_fwd": ("fwd_sm90", "fwd_kernel"),
               "flash_attention_bwd_dq": ("dq_sm90", "dq_kernel"),
               "flash_attention_bwd_dkv": ("dkv_sm90", "dkv_kernel")}

    def complete(self, launched: Dict[str, int]) -> bool:
        """Whether the trace holds a device record for every launch the
        program's counters saw in the traced block (the profiler drops a
        session's records now and then)."""
        if not self.records:
            return False
        return all(self.by_name(*self.KERNELS[k])[0] >= n
                   for k, n in launched.items() if k in self.KERNELS)

    def busy_s(self) -> float:
        return busy_ms([(s / 1e3, e / 1e3) for _, s, e in self.records]) / 1e3

    def by_name(self, *needles: str) -> Tuple[int, float]:
        """(launches, device seconds) of the records whose name holds any
        of `needles`."""
        hits = [(s, e) for n, s, e in self.records
                if any(k in n for k in needles)]
        return len(hits), sum(e - s for s, e in hits) / 1e9

    def in_span(self, t0: float, t1: float) -> int:
        starts = [s for _, s, _ in self.records]
        return bisect.bisect_right(starts, t1) - bisect.bisect_left(starts,
                                                                     t0)

    def top_ops(self, n: int = 10) -> List[list]:
        sums: Dict[str, float] = defaultdict(float)
        for name, s, e in self.records:
            sums[name[:160]] += (e - s) / 1e9
        return [[k, v] for k, v in sorted(sums.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, spans: Spans, n: int = 10) -> List[list]:
        """Device-idle time inside the traced block, summed by the host
        span in which each gap ends (what the host was doing while the
        device waited), the `n` largest."""
        busy = merged([(s, e) for _, s, e in self.records])
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        sums: Dict[str, float] = defaultdict(float)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                sums[spans.at(b)] += (b - a) / 1e9
        return [[k, v] for k, v in sorted(sums.items(),
                                          key=lambda kv: -kv[1])[:n]]
