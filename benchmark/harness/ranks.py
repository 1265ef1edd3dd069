"""A cell on n > 1 cards: n processes, one a card, in one process group.

`launch(target, kwargs, n)` starts n children of this Python, ranks 0 ..
n-1, each running `target(**kwargs, ranks=Ranks)` ("module:function") on
card `rank` (or on the CPU, over gloo, where kwargs' device is "cpu").
The children's output goes to temporary files; when every child has
exited 0, `launch` returns rank 0's output. When one fails, or the
deadline passes, every child is killed and waited for, and `launch`
raises with the tails of their errors. A child dies with its parent
(PR_SET_PDEATHSIG), so none outlives an ended run.

`Ranks` is what a cell needs to know of the others: the program's mesh
(`program.join`), and the harness's own agreements over a gloo group on
the host (rank 0's decision to go on stepping, barriers, the largest
peak), which cost no device synchronise. On one card `SINGLE` does none
of it: every agreement returns its own argument.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ENV = "BENCHMARK_RANK"          # "rank,world,host:port" in a child


@dataclass
class Ranks:
    world: int = 1
    rank: int = 0
    mesh: object = None         # the program's Mesh; None on one card
    ctl: object = None          # a gloo group for the harness's agreements

    @classmethod
    def join(cls, world: int, rank: int, coordinator: str, device
             ) -> "Ranks":
        from benchmark.harness import program
        mesh = program.join(world, rank, coordinator, device)
        return cls(world, rank, mesh, dist.new_group(backend="gloo"))

    def _reduce(self, value: float, op: str) -> float:
        if self.world == 1:
            return value
        t = torch.tensor([value], dtype=torch.float64)
        dist.all_reduce(t, op=getattr(dist.ReduceOp, op), group=self.ctl)
        return float(t[0])

    def agree(self, flag: bool) -> bool:
        """Rank 0's `flag`, on every rank."""
        if self.world == 1:
            return flag
        t = torch.tensor([int(flag)])
        dist.broadcast(t, src=0, group=self.ctl)
        return bool(t[0])

    def all(self, flag: bool) -> bool:
        return bool(self._reduce(float(flag), "MIN"))

    def max(self, value: float) -> float:
        return self._reduce(value, "MAX")

    def sum(self, value: float) -> float:
        return self._reduce(value, "SUM")

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier(group=self.ctl)


SINGLE = Ranks()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(target: str, kwargs: dict, n: int, *,
           timeout: Optional[float] = None) -> str:
    """Runs `target` in `n` ranks; returns rank 0's standard output and
    writes the children's standard error to this process's."""
    coordinator = f"127.0.0.1:{free_port()}"
    logs, procs, failure = [], [], None
    try:
        for rank in range(n):
            out, err = (tempfile.TemporaryFile(mode="w+") for _ in "oe")
            logs.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "benchmark.harness.ranks", target,
                 json.dumps(kwargs)], stdout=out, stderr=err, cwd=ROOT,
                env={**os.environ, ENV: f"{rank},{n},{coordinator}"}))
        deadline = None if timeout is None else time.monotonic() + timeout
        while failure is None:
            codes = [p.poll() for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failure = f"rank {bad[0][0]} exited with {bad[0][1]}"
            elif all(c == 0 for c in codes):
                break
            elif deadline is not None and time.monotonic() > deadline:
                failure = f"{n} ranks outlived {timeout} s"
            else:
                time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        texts = []
        for out, err in logs:
            for f in (out, err):
                f.seek(0)
            texts.append((out.read(), err.read()))
            out.close()
            err.close()
    for rank in reversed(range(len(texts))):
        tail = texts[rank][1] if rank == 0 else texts[rank][1][-4000:]
        if tail:
            sys.stderr.write(f"--- rank {rank} ---\n{tail}")
    sys.stderr.flush()
    if failure is not None:
        raise RuntimeError(f"{target}: {failure}")
    return texts[0][0] if texts else ""


def _die_with_parent() -> None:
    try:
        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass


def _child(target: str, kwargs_json: str) -> None:
    _die_with_parent()
    sys.path.insert(0, ROOT)
    rank, world, coordinator = os.environ[ENV].split(",")
    kwargs = json.loads(kwargs_json)
    module, name = target.split(":")
    fn = getattr(importlib.import_module(module), name)
    ranks = Ranks.join(int(world), int(rank), coordinator,
                       kwargs.get("device", "cuda"))
    try:
        fn(**kwargs, ranks=ranks)
    finally:
        from benchmark.harness import program
        program.leave()


if __name__ == "__main__":
    _child(*sys.argv[1:3])
