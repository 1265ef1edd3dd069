#!/usr/bin/env python3
"""K3 (the log-mel front end) on one CUDA card: this checkout's kernel
against the kernel of another checkout, in turns.

    python3 scripts/profile_k3.py [--other DIR] [--sweep]

At whisper's preset (n_fft 400, hop 160, 80 slaney bands, log10 clamp)
on 30 s clips (480000 samples) at B = 1, 4 and 16, it prints for each
kernel:

  - the device time of one call's K3 kernel (torch.profiler: the kernels
    whose name contains `mel_kernel`) and their number per call, with the
    calls back to back ("warm": the clips stay in the 50 MB L2) and with
    a 256 MB read between calls ("cold": the waveform comes from device
    memory, as the bound assumes; a read, since a write would leave the L2
    full of dirty lines that the kernel's reads must first write back);
  - the time of one call by CUDA events (median of 20): for this
    checkout the kernel's launch from the unpadded waveform, for the
    other the reflect pad and the launch, as its wrapper made them;
  - the bound: the waveform read once and the features written once
    over 3.35 TB/s (chip_smoke.k3_bound).

`--other DIR` names a checkout (an earlier commit unpacked with `git
archive`) whose `audio_transformers_tpu_torch/csrc/mel.cu` is the dense
kernel with the C entry point `log_mel_f32` (wav, wcos, wsin, fb, out,
batch, n, t_total, n_fft, hop, n_mels, use_sqrt, log_mode, stream) on the
centre-padded waveform. It is built with the same nvcc flags, its
features are held to this checkout's within chip_smoke's K3 tolerance,
and the two are timed in turns: other, this, this, other.

`--parent DIR` names a checkout whose K3 has this checkout's C
interface (the two-pass FFT kernel, e.g. the parent commit
unpacked with `git archive`): both are built with the same flags and
timed in turns (parent, this, this, parent) by device time, back to back
and after the 256 MB read, at whisper's B = 1, 4, 16 and at UrbanSound's
preset on 64 clips of 4 s of noise and on 64 clips of 3 s zero-padded to
4 s (the classifier's batch); each pair's features are held to each
other within chip_smoke's K3 tolerance plus `mel_cuda.frame_error_bound`
on the padded clips (where the parent's pairing errs), and their largest
difference is printed.

`--sweep` also times this kernel after the 256 MB read at every even
number of frames per block up to `mel_cuda.MAX_FRAMES` that fits the
plan's shared memory, in place of `mel_cuda.mel_plan`'s choice. The last
line is one JSON object with every number and the card's name and power
limit. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "scripts"))

from profile_k2 import FLUSH_BYTES, build_other, kernel_ms  # noqa: E402

BATCHES = (1, 4, 16)
SAMPLES = 480000
# the dense kernel's C entry point: wav, wcos, wsin, fb, out; batch, n,
# t_total, n_fft, hop, n_mels, use_sqrt, log_mode; stream
_OTHER_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_k3: needs a CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", default=None)
    ap.add_argument("--parent", default=None)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()

    import chip_smoke as cs
    from audio_transformers_tpu_torch.core import MelConfig
    from audio_transformers_tpu_torch.ops import _build
    from audio_transformers_tpu_torch.ops import mel
    from audio_transformers_tpu_torch.ops import mel_cuda as mc

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    _build.load("mel")
    cfg = MelConfig.whisper()
    other = None
    if args.other:
        other = build_other(_build, args.other, "mel").log_mel_f32
        other.argtypes = _OTHER_ARGTYPES
        other.restype = ctypes.c_int
        wcos, wsin, fb = mel.device_bases(cfg, torch.device("cuda"))

    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.zeros(FLUSH_BYTES // 4, device="cuda")
    if args.parent:
        result = {"card": card,
                  "parent": against_parent(torch, build_other(
                      _build, args.parent, "mel"), cs, mel, mc, _build, gen,
                      flush)}
        print(json.dumps(result))
        return 0
    t_full = SAMPLES // cfg.hop_length + 1
    result = {"card": card, "samples": SAMPLES, "reps": 50, "batches": {}}
    for b in BATCHES:
        wav = 0.3 * torch.randn((b, SAMPLES), generator=gen, device="cuda")

        def this():
            return mc._launch(wav, cfg, t_full)
        runs = {"this": this}
        if other is not None:
            out = torch.empty((b, t_full, cfg.n_mels), device="cuda")

            def run_other():
                padded = mel.prepare_waveform(wav, cfg)
                rc = other(_build.ptr(padded), _build.ptr(wcos),
                           _build.ptr(wsin), _build.ptr(fb), _build.ptr(out),
                           b, padded.shape[1], t_full, cfg.n_fft,
                           cfg.hop_length, cfg.n_mels, 0, 2,
                           _build.stream_ptr(wav))
                _build.check(rc, "the other checkout's log_mel_f32")
                return out
            got, got_other = this(), run_other()
            torch.cuda.synchronize()
            err = (got - got_other).abs().max().item()
            if err > cs.K3_TOL:
                raise RuntimeError(f"B={b}: the two kernels differ by {err}")
            runs = {"other": run_other, "this": this}
        order = ["other", "this", "this", "other"] if other else ["this"] * 2
        rec = {name: {"warm_ms": [], "cold_ms": [], "event_ms": [],
                      "kernels_per_call": None} for name in runs}
        for name in order:
            fn = runs[name]
            warm, per_call = kernel_ms(torch, fn, "mel_kernel")
            cold, _ = kernel_ms(torch, fn, "mel_kernel", flush=flush)
            rec[name]["warm_ms"].append(warm)
            rec[name]["cold_ms"].append(cold)
            rec[name]["event_ms"].append(cs.time_ms(fn))
            rec[name]["kernels_per_call"] = per_call
        bnd = cs.k3_bound(cfg, mel, b, SAMPLES)
        for name, r in rec.items():
            r["warm_median_ms"] = statistics.median(r["warm_ms"])
            r["cold_median_ms"] = statistics.median(r["cold_ms"])
            r["bound_share_cold"] = bnd[0] / r["cold_median_ms"]
            print(f"B={b:2d} {name:5s}: device warm "
                  + " ".join(f"{x:.4f}" for x in r["warm_ms"])
                  + " / cold " + " ".join(f"{x:.4f}" for x in r["cold_ms"])
                  + " ms, events " + " ".join(f"{x:.4f}" for x in r["event_ms"])
                  + f" ms, {r['kernels_per_call']:g} kernels per call; bound "
                  f"{bnd[0]:.4f} ms ({bnd[1]}): "
                  f"{100 * r['bound_share_cold']:.1f}% cold", flush=True)
        result["batches"][str(b)] = {"bound_ms": bnd[0], "bound_by": bnd[1],
                                     "frames_per_block": mc.mel_plan(
                                         b, t_full, cfg.n_fft, cfg.hop_length,
                                         torch.cuda.get_device_properties(
                                             0).multi_processor_count),
                                     **rec}
    if args.sweep:
        result["sweep"] = sweep(torch, mc, cfg, gen, flush, t_full)
    print(json.dumps(result))
    return 0


def against_parent(torch, parent_lib, cs, mel, mc, _build, gen, flush):
    """{case: {"parent"/"this": {warm, cold ms lists and medians},
    "max_diff"}}: the parent checkout's K3 (same C interface, swapped in
    as `_build`'s entry point) against this one, in turns."""
    from audio_transformers_tpu_torch.core import MelConfig
    key = ("mel", "log_mel_f32")
    this_fn = _build.function("mel", "log_mel_f32", mc._ARGTYPES)
    parent_fn = parent_lib.log_mel_f32
    parent_fn.argtypes = list(mc._ARGTYPES)
    parent_fn.restype = ctypes.c_int
    us = MelConfig.urbansound()
    cases = [(f"whisper_b{b}", MelConfig.whisper(), b, SAMPLES, SAMPLES)
             for b in BATCHES]
    cases += [("urbansound_b64", us, 64, 88200, 88200),
              ("urbansound_b64_padded_3s", us, 64, 88200, 66150)]
    out = {}
    for name, cfg, b, n, length in cases:
        wav = torch.zeros((b, n), device="cuda")
        wav[:, :length] = 0.3 * torch.randn((b, length), generator=gen,
                                            device="cuda")

        def run(fn):
            def call():
                _build._fns[key] = fn
                try:
                    return mc.log_mel_cuda(wav, cfg)
                finally:
                    _build._fns[key] = this_fn
            return call
        runs = {"parent": run(parent_fn), "this": run(this_fn)}
        got_p, got = runs["parent"](), runs["this"]()
        torch.cuda.synchronize()
        diff = (got_p - got).abs()
        limit = cs.K3_TOL
        if cfg.log_mode == "log_eps":
            power = mel.log_mel_torch(wav, cfg.replace(log_mode="none"))
            limit = limit + mc.frame_error_bound(wav, cfg, power).float()
        if not bool((diff <= limit).all()):
            raise RuntimeError(f"{name}: the parent's K3 and this one "
                               f"differ by {diff.max().item()}")
        rec = {k: {"warm_ms": [], "cold_ms": []} for k in runs}
        for k in ("parent", "this", "this", "parent"):
            rec[k]["warm_ms"].append(kernel_ms(torch, runs[k],
                                               "mel_kernel")[0])
            rec[k]["cold_ms"].append(kernel_ms(torch, runs[k], "mel_kernel",
                                               flush=flush)[0])
        for k, r in rec.items():
            r["warm_median_ms"] = statistics.median(r["warm_ms"])
            r["cold_median_ms"] = statistics.median(r["cold_ms"])
        out[name] = {**rec, "max_diff": diff.max().item(),
                     "bound_ms": cs.k3_bound(cfg, mel, b, n)[0]}
        print(f"{name}: parent warm {rec['parent']['warm_ms']} cold "
              f"{rec['parent']['cold_ms']}; this warm {rec['this']['warm_ms']}"
              f" cold {rec['this']['cold_ms']} ms; max |diff| "
              f"{diff.max().item():.3e}", flush=True)
    return out


def sweep(torch, mc, cfg, gen, flush, t_full):
    """{frames per block: {B: cold device ms}} of this kernel at each size
    that fits the plan's shared memory."""
    sizes = [f for f in range(2, mc.MAX_FRAMES + 1, 2)
             if mc.mel_layout(f, cfg.hop_length, cfg.n_fft)[1]
             <= mc._SMEM_LIMIT]
    wavs = {b: 0.3 * torch.randn((b, SAMPLES), generator=gen, device="cuda")
            for b in BATCHES}
    out = {}
    for f in sizes:
        out[f] = {b: kernel_ms(torch, lambda: mc._launch(wavs[b], cfg, t_full,
                                                         fpb=f),
                               "mel_kernel", flush=flush)[0]
                  for b in BATCHES}
        print(f"frames per block {f:2d}: cold "
              + " ".join(f"B={b} {ms:.4f}" for b, ms in out[f].items())
              + " ms", flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
