#!/usr/bin/env python3
"""Where the port's segment-level evaluation spends its time, on one card.

    python3 scripts/profile_torch_evaluate.py

The call is chip_smoke.py's phase 18: evaluate_segment_level at
whisper-tiny width (seeded random weights, bfloat16) on 8 synthetic 30 s
clips in batches of 4, with the reference's decode (timestamps, 256 new
tokens, repetition penalty 1.1, no-repeat 3-gram). For kv_quant "none" and
"int4", each with the fallback at the reference's threshold 2.4 (byte
tokenizer) and at 1e-6 over the id bytes (every row decoded again at
temperature 0.7), after one warm-up run of the first, it prints:

  - the wall time per batch (host clock around synchronised work);
  - under torch.profiler (CUDA activity only: the host's op events of
    some 300,000 launches take minutes to process) over one run: the
    device's busy time (the union of the kernels' intervals), its idle
    share of the profiled wall time, the launches, and the device time and
    launches of K1, K2 and K3, matched by kernel name;
  - the share of the wall time spent in the fallback's re-decodes (host
    clock around each re-decoding `generate` call, synchronised).

The last line is one JSON object with these numbers. Needs the port's
CUDA kernels (built on first use) and imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

from profile_torch_train_step import card_name, device_kernels

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

BATCH, CLIPS = 4, 8
PORT_KERNELS = {"decode_cross_attention": "dca_",
                "fused_greedy_step": "greedy_",
                "log_mel": "mel_kernel"}


def run(torch, ev, decode, params, cfg, data, dcfg, tokenizer):
    """(wall s, re-decode s, re-decoded rows) of one evaluation."""
    from audio_transformers_tpu_torch.core import MelConfig
    from audio_transformers_tpu_torch.infer.pipeline import \
        DEFAULT_EMOTION_LABELS
    inner = decode.generate
    redo = [0.0, 0]

    def timed(params_, cfg_, dcfg_, enc, **kw):
        if not dcfg_.temperature:
            return inner(params_, cfg_, dcfg_, enc, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(params_, cfg_, dcfg_, enc, **kw)
        torch.cuda.synchronize()
        redo[0] += time.perf_counter() - t0
        redo[1] += enc.shape[0]
        return out
    decode.generate = timed
    try:
        with tempfile.TemporaryDirectory() as tmp:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev.evaluate_segment_level(
                params, cfg, MelConfig.whisper(), data.batcher(BATCH),
                dict(enumerate(DEFAULT_EMOTION_LABELS)), tokenizer=tokenizer,
                output_dir=tmp, dcfg=dcfg, device="cuda",
                compute_dtype=torch.bfloat16)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        decode.generate = inner
    return wall, redo[0], redo[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_evaluate: needs a CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from audio_transformers_tpu_torch.core import (DecodeConfig,
                                                   EmotionWhisperConfig)
    from audio_transformers_tpu_torch.core.params import init, to_device
    from audio_transformers_tpu_torch.data.synthetic import SyntheticSeq2Seq
    from audio_transformers_tpu_torch.infer import evaluate as ev
    from audio_transformers_tpu_torch.models.whisper import decode
    from audio_transformers_tpu_torch.ops import _build
    card = card_name()
    print(card, flush=True)
    _build.build_all()
    cfg = EmotionWhisperConfig()
    params = to_device(init(cfg, torch.Generator().manual_seed(0)), "cuda")
    data = SyntheticSeq2Seq(num_samples=CLIPS,
                            num_classes=cfg.num_emotion_classes,
                            vocab_size=cfg.whisper.vocab_size, duration=30.0,
                            seed=7)
    results = []
    for mode in ("none", "int4"):
        for threshold, tok in ((2.4, chip_smoke.ByteTokenizer()),
                               (1e-6, None)):
            dcfg = DecodeConfig(max_new_tokens=256, return_timestamps=True,
                                no_repeat_ngram_size=3,
                                repetition_penalty=1.1, kv_quant=mode,
                                compression_ratio_threshold=threshold)
            if not results:  # warm-up
                run(torch, ev, decode, params, cfg, data, dcfg, tok)
            wall, redo_s, rows = run(torch, ev, decode, params, cfg, data,
                                     dcfg, tok)
            _build.reset_stats()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                p_wall, p_redo, _ = run(torch, ev, decode, params, cfg, data,
                                        dcfg, tok)
            launches, busy, by_name, _ = device_kernels(prof)
            port = {}
            for name, part in PORT_KERNELS.items():
                hits = [(ms, n) for k, (ms, n) in by_name.items()
                        if part in k]
                port[name] = {"device_ms": sum(ms for ms, _ in hits),
                              "launches": sum(n for _, n in hits),
                              "counter": _build.STATS[name].launches}
            r = {"kv_quant": mode, "threshold": threshold,
                 "tokenizer": "bytes" if tok else "none",
                 "wall_ms_per_batch": wall * 1e3 / (CLIPS // BATCH),
                 "redecoded_rows": rows, "redecode_share": redo_s / wall,
                 "profiled_wall_ms": p_wall * 1e3,
                 "device_busy_ms": busy, "idle_share": 1 - busy / (p_wall
                                                                   * 1e3),
                 "launches": launches, "port_kernels": port}
            results.append(r)
            print(f"segment evaluation kv_quant={mode} threshold={threshold}"
                  f" ({r['tokenizer']}): {r['wall_ms_per_batch']:.1f} ms a "
                  f"batch of {BATCH}; re-decoded {rows} rows, "
                  f"{100 * r['redecode_share']:.1f}% of the wall time; "
                  f"profiled {p_wall * 1e3:.1f} ms, device busy {busy:.1f} "
                  f"ms (idle share {r['idle_share']:.4f}), {launches:.0f} "
                  f"launches; " + ", ".join(
                      f"{n} {v['device_ms']:.3f} ms / {v['launches']:.0f}"
                      for n, v in port.items()), flush=True)
    print(json.dumps({"card": card, "runs": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
