#!/usr/bin/env python3
"""Where the port's train step spends its time, on one CUDA card.

    python3 scripts/profile_torch_train_step.py [--batch 16] [--steps 3]

The step is chip_smoke.py's phase 11: whisper-tiny (seeded weights), bf16,
AdamW, 30 s synthetic clips, 32-id labels. For each attention path (the
flash kernels, then plain attention) it prints, after three warm-up
steps:

  - ms per step over 5 steps, host clock around synchronised work;
  - the host time to enqueue one step (host clock around the call, with
    the card idle before it);
  - under torch.profiler over `--steps` steps: the device's busy time
    per step (the union of the kernels' intervals), its idle share of
    the profiled wall time, the launches per step, and the kernels that
    take the most device time, summed by name.

The last line is one JSON object with these numbers. Needs the port's
CUDA kernels (built on first use) and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def busy_ms(events) -> float:
    """The union of [start, end) intervals, in ms."""
    total, end = 0.0, None
    for s, e in sorted(events):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def profile_path(torch, chip_smoke, port, params, attn, batch_size, steps):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from audio_transformers_tpu_torch.train.whisper_emotion import \
        batch_to_device
    w = port.WhisperConfig()
    batch = batch_to_device(chip_smoke.train_batch(batch_size, 30.0, w, 9,
                                                   seed=13), "cuda")
    step = chip_smoke._tiny_steps(torch, port, params, attn, 3e-5,
                                  batch_size)
    for _ in range(3):
        step(batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step(batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 5 * 1e3
    t0 = time.perf_counter()
    step(batch)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3 / steps
        by_name[e.name][1] += 1
    busy = busy_ms([(e.time_range.start, e.time_range.end) for e in kernels])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    del step
    torch.cuda.empty_cache()
    return {"attn": attn, "step_ms": step_ms, "enqueue_ms": enqueue_ms,
            "profiled_wall_ms_per_step": wall / steps,
            "device_busy_ms_per_step": busy / steps,
            "idle_share": 1.0 - busy / wall,
            "launches_per_step": len(kernels) / steps,
            "top_kernels_ms_per_step": [
                {"name": n[:90], "ms": ms, "launches": c / steps}
                for n, (ms, c) in top]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--steps", type=int, default=3)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_train_step: needs a CUDA device",
              file=sys.stderr)
        return 1
    import chip_smoke
    from audio_transformers_tpu_torch import core as port
    from audio_transformers_tpu_torch.core.params import init
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    params = init(port.EmotionWhisperConfig(num_emotion_classes=9),
                  torch.Generator().manual_seed(0))
    runs = []
    for attn in ("flash", "xla"):
        r = profile_path(torch, chip_smoke, port, params, attn, args.batch,
                         args.steps)
        print(f"{attn}: {r['step_ms']:.3f} ms/step, enqueue "
              f"{r['enqueue_ms']:.3f} ms, device busy "
              f"{r['device_busy_ms_per_step']:.3f} of "
              f"{r['profiled_wall_ms_per_step']:.3f} ms profiled (idle "
              f"share {r['idle_share']:.4f}), "
              f"{r['launches_per_step']:.0f} launches per step", flush=True)
        for k in r["top_kernels_ms_per_step"]:
            print(f"  {k['ms']:9.3f} ms  {k['launches']:6.1f}x  {k['name']}")
        runs.append(r)
    print(json.dumps({"card": card, "batch": args.batch, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
