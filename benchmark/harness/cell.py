"""One run of one cell: set-up, the window, the check, the result line.

`run` does the work on any device (the tests drive it on the CPU at a
small size); `benchmark/run.py` looks for the card first.
"""

from __future__ import annotations

import gc
import json
import sys
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from benchmark.harness import registry, spec, traffic
from benchmark.harness.analyze_cell import AnalyzeCell
from benchmark.harness.checks import print_checks, verdict
from benchmark.harness.counts import HBM_BYTES_PER_S, PEAK_BF16_FLOPS
from benchmark.harness.tracing import Spans, card_name
from benchmark.harness.train_cell import TrainCell

KINDS = {"train": TrainCell, "analyze": AnalyzeCell}
BANNED = ("jax", "jaxlib", "flax", "audio_transformers_tpu")


@dataclass
class Context:
    """What a per-layer metric's reader gets."""
    cell: object                 # the TrainCell or AnalyzeCell
    dims: spec.Dims
    spans: Spans
    trace: object                # tracing.DeviceTrace, or None


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device="cuda", t_start: Optional[float] = None,
        root: str = registry.ROOT, bench_dir: Optional[str] = None,
        plant: Optional[Callable] = None, control: bool = False) -> dict:
    """The result of one run. `plant(spans, cell_kind)` may hook the
    program before set-up (`faults`); `control` adds the control's
    numbers (`result["control"]`), for reading the limits."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cell_def = registry.find(workload, root, bench_dir)
    dims = spec.load(cell_def.config_file)
    mix = traffic.load(cell_def.traffic_file)
    spans = Spans(events=trace)
    if plant is not None:
        plant(spans, mix["kind"])
    try:
        cell = KINDS[mix["kind"]](dims, mix, seed, device, spans, trace)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - t_start
        win = cell.window(seconds, mix["trace_steps"] if trace else 0)
        peak = (torch.cuda.max_memory_allocated(device)
                if device.type == "cuda" else 0)
        found = banned_modules()
        if found:
            raise SystemExit(f"loaded after the window: {found}")
        metrics = {}
        ctx = Context(cell, dims, spans, win["trace"])
        if trace:
            for name, mod in cell_def.metrics.items():
                value = mod.read(ctx)
                if value is not None:
                    metrics[name] = {"value": value, "unit": mod.UNIT}
        else:
            metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
            metrics.update({m["name"]: {"value": win["rate"][0],
                                        "unit": m["unit"]}
                            for m in cell_def.end_to_end
                            if m["unit"] == win["rate"][1]})
    finally:
        spans.close()
    cell.release()
    gc.collect()
    reference = cell.reference()
    numbers = cell.numbers(reference)
    correct, checks = verdict(numbers, registry.limits(cell_def))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": win["attempted"],
           "failed": win["failed"], "metrics": metrics, "device": dev}
    if trace and win["trace"] is not None:
        t = win["trace"]
        dev["busy_s"] = t.busy_s()
        dev["window_s"] = t.window_s
        out["breakdown"] = {"device_ops": t.top_ops(),
                            "idle_gaps": t.idle_gaps(spans)}
    out["peaks"] = {"bf16_flops_per_s": PEAK_BF16_FLOPS,
                    "hbm_bytes_per_s": HBM_BYTES_PER_S,
                    "card": card_name() if device.type == "cuda" else "cpu"}
    if control:
        out["control"] = cell.control_numbers(reference)
    out["checks"] = checks
    return out


def emit(result: dict) -> None:
    """The check's lines last on standard error, the result last on
    standard output."""
    print_checks(result["checks"])
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
