#!/usr/bin/env python3
"""Where the port's greedy `analyze` spends its time, on one CUDA card.

    python3 scripts/profile_torch_analyze.py

The call is chip_smoke.py's phase 5: EmotionWhisperPipeline.analyze of a
12 s clip (one transcription window and three segment windows) at
whisper-tiny width, seeded random weights, bfloat16, greedy decoding.
After one warm-up call it prints:

  - the wall time of three calls, host clock around synchronised work;
  - under torch.profiler over one call: the device's busy time (the union
    of the kernels' intervals), its idle share of the profiled wall time,
    the launches, and the kernels that take the most device time, summed
    by name;
  - the device time and launches of each of the port's kernels that the
    call runs (K1 decode cross-attention, K2 greedy step, K3 log-mel),
    matched by kernel name, beside the wrappers' launch counters;
  - the host time of one K1 wrapper call at the path's shapes (bf16 q and
    K/V, 6 heads of 64, T = 1500; B = 1, 4, 16) and of one `log_mel` call
    (K3, 30 s windows; B = 1, 4): the host clock around 200 (K1) or 50
    (K3) calls with no sync between them, the median of five such rounds.

The last line is one JSON object with these numbers. Needs the port's
CUDA kernels (built on first use) and imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

from profile_torch_train_step import card_name, device_kernels

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

RUNS = 3
# the port's kernels on this path, by a part of their CUDA function names
PORT_KERNELS = {"decode_cross_attention": "dca_",
                "fused_greedy_step": "greedy_",
                "log_mel": "mel_kernel"}


def host_us(torch, call, calls, rounds=5):
    """Host us per call(): the host clock around `calls` calls with no
    sync between them, the median of `rounds` such rounds. The calls must
    not fill the launch queue, so that the clock reads the host's own
    work."""
    call()
    per_call = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(per_call)


def k1_host_us(torch):
    """{B: host us per K1 wrapper call} at the path's shapes, over 200
    calls (K1's device time is shorter than a call's host time)."""
    from audio_transformers_tpu_torch.ops import decode_attention as da
    gen = torch.Generator(device="cuda").manual_seed(3)
    out = {}
    for b in (1, 4, 16):
        q, k, v = (torch.randn(shape, generator=gen, device="cuda",
                               dtype=torch.bfloat16)
                   for shape in ((b, 6, 64), (b, 6, 64, 1500),
                                 (b, 6, 64, 1500)))
        out[b] = host_us(torch, lambda: da.decode_cross_attention(q, k, v),
                         200)
    return out


def k3_host_us(torch):
    """{B: host us per `log_mel` call} on the path's 30 s windows (B = 1
    and 4), over 50 calls: fewer than the launch queue holds, even with
    the earlier kernel's padding launch and the whisper floor's."""
    from audio_transformers_tpu_torch.core import MelConfig
    from audio_transformers_tpu_torch.ops import mel
    gen = torch.Generator(device="cuda").manual_seed(4)
    cfg = MelConfig.whisper()
    out = {}
    for b in (1, 4):
        wav = 0.3 * torch.randn((b, 480000), generator=gen, device="cuda")
        out[b] = host_us(torch, lambda: mel.log_mel(wav, cfg), 50)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_analyze: needs a CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from audio_transformers_tpu_torch.core import EmotionWhisperConfig
    from audio_transformers_tpu_torch.core.params import init
    from audio_transformers_tpu_torch.infer.pipeline import \
        EmotionWhisperPipeline
    from audio_transformers_tpu_torch.ops import _build
    card = card_name()
    print(card, flush=True)
    _build.build_all()
    cfg = EmotionWhisperConfig()
    params = init(cfg, torch.Generator().manual_seed(0))
    pipe = EmotionWhisperPipeline(params, cfg, device="cuda",
                                  compute_dtype=torch.bfloat16)
    clip = chip_smoke.synth_clip(12.0, 16000)
    pipe.analyze(clip, 16000)
    torch.cuda.synchronize()
    walls = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        pipe.analyze(clip, 16000)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)

    _build.reset_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.analyze(clip, 16000)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    counters = {n: s.launches for n, s in _build.STATS.items()}
    launches, busy, by_name, top = device_kernels(prof, top=15)
    port = {}
    for name, part in PORT_KERNELS.items():
        hits = [(ms, n) for k, (ms, n) in by_name.items() if part in k]
        port[name] = {"device_ms": sum(ms for ms, _ in hits),
                      "launches": sum(n for _, n in hits),
                      "counter": counters[name]}
    k1_us, k3_us = k1_host_us(torch), k3_host_us(torch)
    result = {
        "card": card, "clip_s": 12.0, "wall_ms": walls,
        "profiled_wall_ms": wall, "device_busy_ms": busy,
        "idle_share": 1.0 - busy / wall, "launches": launches,
        "port_kernels": port, "k1_host_us_per_call": k1_us,
        "k3_host_us_per_call": k3_us,
        "top_kernels": [{"name": n[:90], "ms": ms, "launches": c}
                        for n, (ms, c) in top]}
    print(f"analyze (whisper-tiny, bf16, 12 s clip): wall ms {walls}; "
          f"profiled {wall:.3f} ms, device busy {busy:.3f} ms (idle share "
          f"{result['idle_share']:.4f}), {launches:.0f} launches", flush=True)
    for name, r in port.items():
        print(f"  {name}: {r['device_ms']:.3f} ms device, "
              f"{r['launches']:.0f} launches (wrapper counter "
              f"{r['counter']})")
    print("  K1 wrapper, host us per call: " + ", ".join(
        f"B={b} {us:.2f}" for b, us in k1_us.items()))
    print("  log_mel (K3 and the whisper floor), host us per call: "
          + ", ".join(f"B={b} {us:.2f}" for b, us in k3_us.items()))
    for k in result["top_kernels"]:
        print(f"  {k['ms']:9.3f} ms  {k['launches']:6.0f}x  {k['name']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
