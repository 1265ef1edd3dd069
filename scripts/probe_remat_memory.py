#!/usr/bin/env python3
"""Peak memory and step time of the whisper-tiny train step with remat
off and on, over a sweep of batch sizes, on one CUDA device.

    python3 scripts/probe_remat_memory.py [--batches 16 64 128 256]

Each batch size runs the step of chip_smoke's phase 25 (bf16, the flash
kernels, 30 s clips, AdamW; `chip_smoke._whisper_step`) with remat off,
then on: one warm-up step, then `--reps` steps timed by the host clock
around a synchronize, with torch.cuda.max_memory_allocated over them
(in MiB). A
batch that does not fit prints OOM. The card's name and power limit head
the output; chip_smoke's REMAT_BATCH comes from this sweep.
"""

from __future__ import annotations

import argparse
import os
import runpy
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batches", type=int, nargs="+",
                   default=[16, 64, 128, 256])
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("probe_remat_memory: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    cs = runpy.run_path(os.path.join(ROOT, "chip_smoke.py"),
                        run_name="probe_remat_memory")
    from audio_transformers_tpu_torch import core as port
    from audio_transformers_tpu_torch.core.params import init
    from audio_transformers_tpu_torch.ops import _build
    from audio_transformers_tpu_torch.train.common import batch_to_device

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _build.build_all()
    params = init(port.EmotionWhisperConfig(num_emotion_classes=9),
                  torch.Generator().manual_seed(0))
    w = port.WhisperConfig()
    for b in args.batches:
        batch = batch_to_device(cs["train_batch"](b, 30.0, w, 9, seed=13),
                                "cuda")
        for remat in (False, True):
            try:
                step, p_, _ = cs["_whisper_step"](torch, port, params, b,
                                                  remat=remat)
                ms, peak = cs["_timed_steps"](torch, step, p_, batch,
                                              reps=args.reps)
                print(f"batch {b} remat {'on' if remat else 'off'}: "
                      f"{ms:.2f} ms a step, peak {peak:.1f} MiB", flush=True)
                del step, p_
            except torch.OutOfMemoryError:
                print(f"batch {b} remat {'on' if remat else 'off'}: OOM",
                      flush=True)
            torch.cuda.empty_cache()
        del batch
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
