#!/usr/bin/env python3
"""K3's error against the float64 golden over many random clips, on one card.

    python3 scripts/probe_k3_golden.py [--draws 32]

chip_smoke.py phase 3 holds K3 (`log_mel` on the card) to the float64
golden `reference_log_mel` on one draw of four 30 s clips of white noise
(0.3 * randn), bin by bin within the larger of 2e-5 + 1e-5 |ref| (the
reference package's tolerance) and `mel_cuda.golden_error_bound` (how far
any float32 front end may lie from the golden). This script takes
`--draws` such draws (a CUDA generator seeded 0, 1, ...) and prints, for
each, the largest error of the kernel and of the plain version, its
ratio to the old tolerance alone and to the check's limit; it exits 1 if
either exceeds the limit anywhere. The last line is one JSON object.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main(argv=None) -> int:
    import torch
    p = argparse.ArgumentParser()
    p.add_argument("--draws", type=int, default=32)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_k3_golden: needs a CUDA device", file=sys.stderr)
        return 1
    from audio_transformers_tpu_torch.core import MelConfig
    from audio_transformers_tpu_torch.ops import mel
    from audio_transformers_tpu_torch.ops import mel_cuda
    cfg = MelConfig.whisper()
    rows = []
    for seed in range(args.draws):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        wav = 0.3 * torch.randn((4, 480000), generator=gen, device="cuda")
        ref = np.stack([mel.reference_log_mel(c, cfg)
                        for c in wav.cpu().numpy()])
        old = 2e-5 + 1e-5 * np.abs(ref)
        limit = np.maximum(old, mel_cuda.golden_error_bound(
            wav, cfg).cpu().numpy())
        row = {"seed": seed}
        for name, out in (("kernel", mel.log_mel(wav, cfg)),
                          ("plain", mel.log_mel_torch(wav, cfg))):
            d = np.abs(out.cpu().numpy() - ref)
            row[name] = float(d.max())
            row[f"{name}_old_ratio"] = float((d / old).max())
            row[f"{name}_ratio"] = float((d / limit).max())
        rows.append(row)
        print(f"seed {seed}: kernel {row['kernel']:.3e} "
              f"({row['kernel_old_ratio']:.3f} of 2e-5 + 1e-5 |ref|, "
              f"{row['kernel_ratio']:.3f} of the limit), plain "
              f"{row['plain']:.3e} ({row['plain_old_ratio']:.3f}, "
              f"{row['plain_ratio']:.3f})", flush=True)
    worst = max(max(r["kernel_ratio"], r["plain_ratio"]) for r in rows)
    print(json.dumps({"draws": rows, "worst_ratio": worst}))
    return 0 if worst <= 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
