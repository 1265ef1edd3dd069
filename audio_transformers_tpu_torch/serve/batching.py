"""Cross-request micro-batching for the serving path.

The reference's serving surface (streamlit_app.py / our http_server)
handles each upload independently: N concurrent users pay N separate
decodes. On TPU the decode loop is bandwidth-bound and its per-step cost
is nearly flat in batch size until well past typical concurrency, so
requests that arrive together should ride ONE padded device batch.

`MicroBatcher` is a single worker thread over a queue of
(key, windows, future) items: the first item opens a batch window of
`max_wait_ms`; everything that arrives before it closes (up to
`max_rows`) is grouped by `key` (the decode configuration — batches must
be trace-compatible), each group's windows are concatenated, and the
pipeline's `analyze_windows` runs once per group (its power-of-two
bucketing bounds jit recompiles no matter how request sizes combine).
Row results scatter back to each request's future.

Latency math: a lone request waits at most `max_wait_ms` extra
(default 10 ms against a ~100-1000 ms device pass); concurrent requests
win back a whole decode each.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Tuple

import numpy as np


class MicroBatcher:
    """Batch window-level work items across concurrent requests.

    run_windows(windows (n, W) float32, max_new_tokens=int) ->
    (texts: list[str] len n, probs: (n, C)) — the pipeline's
    `analyze_windows` (or any same-signature callable).
    """

    def __init__(self, run_windows: Callable, *, max_rows: int = 16,
                 max_wait_ms: float = 10.0):
        self._run = run_windows
        self._max_rows = max_rows
        self._max_wait = max_wait_ms / 1e3
        self._q: "queue.Queue" = queue.Queue()
        self.stats = {"requests": 0, "batches": 0, "rows": 0}
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="microbatcher")
        self._thread.start()

    # -- request side ----------------------------------------------------
    def submit(self, windows: np.ndarray, *,
               max_new_tokens: int) -> Future:
        """Enqueue (n, W) windows; resolves to (texts, probs) for exactly
        those rows, in order."""
        fut: Future = Future()
        windows = np.asarray(windows)
        if windows.ndim != 2:
            # fail in the caller's thread — a malformed item must never
            # reach the worker, where it would poison a coalesced batch
            raise ValueError(
                f"submit expects (n, W) windows, got shape {windows.shape}")
        self._q.put((int(max_new_tokens), windows, fut))
        return fut

    def runner(self, windows: np.ndarray, *, max_new_tokens: int = 64
               ) -> Tuple[list, np.ndarray]:
        """Blocking façade with the `analyze_windows` signature — pass as
        `runner=` to pipeline.analyze/transcribe so their device work
        routes through the shared queue."""
        return self.submit(windows, max_new_tokens=max_new_tokens).result()

    def close(self):
        self._q.put(None)
        self._thread.join(timeout=5)

    # -- worker side -------------------------------------------------------
    def _drain(self, first):
        """Collect items until the batch window closes or max_rows."""
        batch = [first]
        rows = first[1].shape[0]
        deadline = time.monotonic() + self._max_wait
        while rows < self._max_rows:
            timeout = deadline - time.monotonic()
            try:
                item = self._q.get(timeout=max(timeout, 0.0))
            except queue.Empty:
                break
            if item is None:
                self._q.put(None)  # re-post the shutdown sentinel
                break
            batch.append(item)
            rows += item[1].shape[0]
        return batch

    def _loop(self):
        while True:
            first = self._q.get()
            if first is None:
                return
            try:
                batch = self._drain(first)
            except Exception as e:  # pragma: no cover — defensive
                if not first[2].done():
                    first[2].set_exception(e)
                continue
            by_key = {}
            for key, windows, fut in batch:
                by_key.setdefault(key, []).append((windows, fut))
            for key, items in by_key.items():
                rows = sum(w.shape[0] for w, _ in items)
                # EVERYTHING per group stays inside the try: an exception
                # escaping this loop kills the worker thread, and every
                # pending and future request would then hang forever.
                try:
                    windows = np.concatenate([w for w, _ in items], axis=0) \
                        if len(items) > 1 else items[0][0]
                    texts, probs = self._run(windows, max_new_tokens=key)
                    if len(texts) != rows or np.shape(probs)[0] != rows:
                        raise RuntimeError(
                            f"run_windows returned {len(texts)} texts / "
                            f"{np.shape(probs)[0]} prob rows for {rows} "
                            f"submitted rows")
                    off = 0
                    for w, fut in items:
                        n = w.shape[0]
                        fut.set_result((texts[off: off + n],
                                        probs[off: off + n]))
                        off += n
                except Exception as e:  # propagate to every waiter
                    for _, fut in items:
                        if not fut.done():
                            fut.set_exception(e)
                self.stats["batches"] += 1
                self.stats["requests"] += len(items)
                self.stats["rows"] += rows
