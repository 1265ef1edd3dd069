#!/usr/bin/env python3
"""How often torch.profiler returns a trace with no kernel in it, on one
CUDA card.

    python3 scripts/profile_trace_drops.py [--seconds S] [--cpu]

For `--seconds` (default 60) it takes one profiler session after another,
each over 20 calls of one of chip_smoke.py's profiled functions in turn
(`log_mel` and `torch.stft` on 30 s clips at B = 1, 4 and 16, the bf16
greedy step at B = 1 and 4), with a pause of 0, 20 or 300 ms before some
of them. A session with no device event is a drop; the script prints each
drop (the function, how many host-side events the same trace held, the
gap since the previous session) and, as its last line, one JSON object
with the sessions and the drops. `--cpu` adds the CPU activity to the
sessions. Kineto's CUPTI teardown between sessions is set by the caller
(`TEARDOWN_CUPTI=0` in the environment keeps CUPTI attached). Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_trace_drops: needs a CUDA device", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from audio_transformers_tpu_torch.core import MelConfig, WhisperConfig
    from audio_transformers_tpu_torch.models.whisper import decode
    from audio_transformers_tpu_torch.ops import decode_logits as dl
    from audio_transformers_tpu_torch.ops import logit_processors as lp
    from audio_transformers_tpu_torch.ops import mel
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU]
                                      if args.cpu else [])
    cfg = MelConfig.whisper()
    gen = torch.Generator(device="cuda").manual_seed(0)
    window = torch.hann_window(cfg.n_fft, device="cuda")
    fns = {}
    for b in (1, 4, 16):
        wav = 0.3 * torch.randn((b, 480000), generator=gen, device="cuda")
        fns[f"log_mel B={b}"] = lambda wav=wav: mel.log_mel(wav, cfg)
        fns[f"stft B={b}"] = lambda wav=wav: torch.stft(
            wav, cfg.n_fft, cfg.hop_length, window=window, center=True,
            pad_mode="reflect", return_complex=True)
    wc = WhisperConfig()
    v_pad = dl.pad_vocab(wc.vocab_size)
    table_t = (0.02 * torch.randn((wc.d_model, v_pad), generator=gen,
                                  device="cuda")).bfloat16()
    add = lp.suppress_vector(v_pad, decode.default_suppress_ids(wc),
                             vocab=wc.vocab_size, device="cuda")
    for b in (1, 4):
        hidden = torch.randn((b, wc.d_model), generator=gen,
                             device="cuda").bfloat16()
        fns[f"greedy step B={b}"] = lambda h=hidden: dl.fused_greedy_step(
            h, table_t, add)
    names = list(fns)
    rng = random.Random(0)
    drops, sessions = [], 0
    t0 = last_end = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        name = names[sessions % len(names)]
        fn = fns[name]
        time.sleep(rng.choice([0, 0, 0, 0.02, 0.3]))
        fn()
        torch.cuda.synchronize()
        gap = time.perf_counter() - last_end
        with profile(activities=acts) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        device = sum(1 for e in events if e.device_type == DeviceType.CUDA)
        last_end = time.perf_counter()
        if device == 0:
            drops.append({"session": sessions, "fn": name,
                          "host_events": len(events),
                          "gap_ms": round(gap * 1e3, 2)})
            print("drop", drops[-1], flush=True)
        sessions += 1
    print(json.dumps({"cpu_activity": args.cpu,
                      "TEARDOWN_CUPTI": os.environ.get("TEARDOWN_CUPTI"),
                      "seconds": time.perf_counter() - t0,
                      "sessions": sessions, "drops": len(drops),
                      "detail": drops}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
