"""One run of one cell: set-up, the window, the check, the result line.

`run` does the work on any device (the tests drive it on the CPU at a
small size); `benchmark/run.py` looks for the card first. A cell on n > 1
cards runs `run` in n ranks (`harness/ranks.py`, `run_rank`): each makes
the same weights and its own inputs, the window starts and ends on a
barrier, and rank 0 returns the result (the fullest card's peak, the
cards' mean busy time, its own trace's metrics).
"""

from __future__ import annotations

import gc
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from benchmark.harness import registry, traffic
from benchmark.harness.checks import print_checks, verdict
from benchmark.harness.counts import HBM_BYTES_PER_S, PEAK_BF16_FLOPS
from benchmark.harness.ranks import SINGLE, Ranks, launch
from benchmark.harness.tracing import Spans, card_name

BANNED = ("jax", "jaxlib", "flax", "audio_transformers_tpu")


@dataclass
class Context:
    """What a per-layer metric's reader gets."""
    cell: object                 # the kind's cell (TrainCell, AnalyzeCell)
    dims: object                 # the family's dims
    spans: Spans
    trace: object                # tracing.DeviceTrace, or None


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device="cuda", t_start: Optional[float] = None,
        root: str = registry.ROOT, bench_dir: Optional[str] = None,
        plant: Optional[Callable] = None, control: bool = False,
        ranks: Ranks = SINGLE) -> Optional[dict]:
    """The result of one run (None on a rank other than 0).
    `plant(spans, cell_kind)` may hook the program before set-up
    (`faults`); `control` adds the control's numbers
    (`result["control"]`), for reading the limits."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    if device.type == "cuda" and ranks.world > 1:
        device = torch.device("cuda", ranks.rank)
    cell_def = registry.find(workload, root, bench_dir)
    family, dims = registry.load_config(cell_def.config_file, bench_dir)
    mix = traffic.load(cell_def.traffic_file)
    kind = registry.kind_class(mix["kind"], bench_dir)
    spans = Spans(events=trace)
    if plant is not None:
        plant(spans, mix["kind"])
    try:
        cell = kind(dims, mix, seed, device, spans, trace, family=family,
                    ranks=ranks)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ranks.barrier()
        setup_s = time.perf_counter() - t_start
        win = cell.window(seconds, mix["trace_steps"] if trace else 0)
        peak = ranks.max(torch.cuda.max_memory_allocated(device)
                         if device.type == "cuda" else 0)
        found = banned_modules()
        if found:
            raise SystemExit(f"loaded after the window: {found}")
        metrics = {}
        ctx = Context(cell, dims, spans, win["trace"])
        if trace and ranks.rank == 0:
            for name, mod in cell_def.metrics.items():
                value = mod.read(ctx)
                if value is not None:
                    metrics[name] = {"value": value, "unit": mod.UNIT}
        elif not trace:
            metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
            metrics.update({m["name"]: {"value": win["rate"][0],
                                        "unit": m["unit"]}
                            for m in cell_def.end_to_end
                            if m["unit"] == win["rate"][1]})
        busy_s = None
        if trace and win["trace"] is not None:
            busy_s = ranks.sum(win["trace"].busy_s()) / ranks.world
    finally:
        spans.close()
    cell.release()
    gc.collect()
    t_ref = time.perf_counter()
    reference = cell.reference()
    control_numbers = cell.control_numbers(reference) if control else None
    if ranks.rank != 0:
        return None
    print(f"set-up {setup_s:.1f} s, window {win['window_s']:.1f} s, "
          f"reference {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    numbers = cell.numbers(reference)
    correct, checks = verdict(numbers, registry.limits(cell_def))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": ranks.world, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": win["attempted"],
           "failed": win["failed"], "metrics": metrics, "device": dev}
    if busy_s is not None:
        t = win["trace"]
        dev["busy_s"] = busy_s
        dev["window_s"] = t.window_s
        out["breakdown"] = {"device_ops": t.top_ops(),
                            "idle_gaps": t.idle_gaps(spans)}
    out["peaks"] = {"bf16_flops_per_s": PEAK_BF16_FLOPS,
                    "hbm_bytes_per_s": HBM_BYTES_PER_S,
                    "card": card_name() if device.type == "cuda" else "cpu"}
    if control:
        out["control"] = control_numbers
    out["checks"] = checks
    return out


def run_rank(out: str, ranks: Ranks, **kwargs) -> None:
    """`run` as one rank of a cell on several cards (`ranks.launch`'s
    target); rank 0 writes the result to the file `out`."""
    result = run(**kwargs, ranks=ranks)
    if result is not None:
        with open(out, "w") as f:
            json.dump(result, f)


def run_across(n: int, timeout: float = 1200.0, **kwargs) -> Optional[dict]:
    """`run` (its keyword arguments) as `n` ranks: rank 0's result, or None
    when a rank failed (its errors written to standard error). Every
    rank's clock is CLOCK_MONOTONIC, so a `t_start` from this process
    holds in each."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result.json")
        try:
            launch("benchmark.harness.cell:run_rank", dict(kwargs, out=out),
                   n, timeout=timeout)
        except RuntimeError as e:
            print(e, file=sys.stderr)
            return None
        with open(out) as f:
            return json.load(f)


def emit(result: dict) -> None:
    """The check's lines last on standard error, the result last on
    standard output."""
    print_checks(result["checks"])
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
