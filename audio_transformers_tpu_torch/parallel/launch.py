"""Runs one function in several local processes that form a process group.

    launch("package.module:function", n, args, timeout=120)

starts n children of this Python, ranks 0 .. n-1, with the reference's
variables set (ATX_COORDINATOR at a free port of 127.0.0.1,
ATX_NUM_PROCESSES, ATX_PROCESS_ID), so that the function's
`parallel.distributed.initialize_if_multihost()` joins them into one
group, and torchrun's LOCAL_RANK, so that a bare "cuda" device is card
`rank` (`parallel.distributed.process_device`). Each child runs `function(*args)` (args go through JSON) and
leaves the group when it returns. When a child fails, or the deadline
passes, every child is killed and the launch raises with their output.
"""

from __future__ import annotations

import importlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(target: str, n: int, args: Sequence = (), *,
           timeout: float = 120.0, env: Optional[dict] = None) -> list:
    """Runs `target` ("module:function") in `n` processes and returns each
    child's output (stdout and stderr), in rank order. Raises
    RuntimeError when a child exits with an error and TimeoutError when
    the children outlive `timeout` seconds; either way no child is left
    running."""
    base = {**os.environ, **(env or {}),
            "ATX_COORDINATOR": f"127.0.0.1:{free_port()}",
            "ATX_NUM_PROCESSES": str(n)}
    base["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, base.get("PYTHONPATH")) if p)
    cmd = [sys.executable, "-m", "audio_transformers_tpu_torch.parallel."
           "launch", target, json.dumps(list(args))]
    logs, procs = [], []
    failure = None
    try:
        for rank in range(n):
            logs.append(tempfile.TemporaryFile(mode="w+"))
            procs.append(subprocess.Popen(
                cmd, stdout=logs[-1], stderr=subprocess.STDOUT,
                env={**base, "ATX_PROCESS_ID": str(rank),
                     "LOCAL_RANK": str(rank)}))
        deadline = time.monotonic() + timeout
        while failure is None:
            codes = [p.poll() for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failure = RuntimeError(f"{target}: rank {bad[0][0]} exited "
                                       f"with {bad[0][1]}")
            elif all(c == 0 for c in codes):
                break
            elif time.monotonic() > deadline:
                failure = TimeoutError(f"{target}: {n} processes outlived "
                                       f"{timeout} s")
            else:
                time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        outputs = []
        for log in logs:
            log.seek(0)
            outputs.append(log.read())
            log.close()
    if failure is not None:
        tails = "\n".join(f"--- rank {r} ---\n{o[-4000:]}"
                          for r, o in enumerate(outputs))
        raise type(failure)(f"{failure}\n{tails}")
    return outputs


def _child(target: str, args_json: str) -> None:
    from audio_transformers_tpu_torch.parallel import distributed

    module, name = target.split(":")
    fn = getattr(importlib.import_module(module), name)
    try:
        fn(*json.loads(args_json))
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    _child(*sys.argv[1:3])
