#!/usr/bin/env python3
"""K2 (the fused greedy step) on one CUDA card: this checkout's bf16
kernel against the bf16 kernel of another checkout, in turns.

    python3 scripts/profile_k2.py [--other DIR]

At whisper-tiny's shapes (D = 384, V = 51865 padded to 52224, bf16
table, the repetition-penalty mask and a no-repeat-ngram ban) and
B = 1, 4, 16 and 128, it prints for each kernel:

  - the device time of one call (torch.profiler: the summed time of the
    kernels a call launches) and the number of kernels per call, with
    the calls back to back ("warm": the 40 MB table may stay partly in
    the 50 MB L2) and with a 256 MB read between calls ("cold": the
    table comes from device memory, as the bound assumes; a read, since a
    write would leave the L2 full of dirty lines that the kernel's reads
    must first write back);
  - the time of one call by CUDA events (median of 20, host time of the
    wrapper included);
  - the bound: the table, bias, hidden rows and masks read once over
    3.35 TB/s.

`--other DIR` names a checkout (an earlier commit unpacked with `git
archive`) whose `audio_transformers_tpu_torch/csrc/decode_logits.cu`
still runs bf16 through the C entry point `fused_greedy_step` (hidden,
table_t, add, seen, ban, penalty, tlo, thi, tcap, tb, batch, dim, vocab,
dtype, partials, partials, out, stream). It is built with the same nvcc
flags, its tokens are held to this checkout's on the decidable rows, and
the two are timed in turns: other, this, this, other. The last line is
one JSON object with every number and the card's name and power limit.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

BATCHES = (1, 4, 16, 128)
REPS = 50
FLUSH_BYTES = 256 << 20


# the earlier checkout's `fused_greedy_step` entry: hidden, table_t, add,
# seen, ban; penalty; tlo, thi, tcap; tb, batch, dim, vocab, dtype;
# partials (float, int), out; stream (no vocab-shard arguments)
OTHER_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_float]
                  + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                  + [ctypes.c_void_p] * 4)


def build_other(_build, other: str, name: str = "decode_logits"
                ) -> ctypes.CDLL:
    """The other checkout's csrc/<name>.cu, built into this checkout's
    build directory."""
    csrc = os.path.join(other, "audio_transformers_tpu_torch", "csrc")
    src = os.path.join(csrc, f"{name}.cu")
    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for fname in sorted(os.listdir(csrc)):
        if fname == f"{name}.cu" or fname.endswith(".cuh"):
            with open(os.path.join(csrc, fname), "rb") as f:
                h.update(f.read())
    out = _build.BUILD_DIR / f"other-{name}-{h.hexdigest()[:16]}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc,
                        "-o", str(out), src], check=True)
    return ctypes.CDLL(str(out))


def kernel_ms(torch, fn, match, flush=None, reps=REPS):
    """(device ms per call of the kernels whose name contains `match`,
    those kernels per call), by torch.profiler over `reps` calls after a
    warm-up; with `flush`, a read of that tensor (its sum) precedes each
    call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush.sum()
            fn()
        torch.cuda.synchronize()
    ks = [e for e in prof.events() if e.device_type == DeviceType.CUDA
          and match in e.name]
    if not ks:
        raise RuntimeError(f"no kernel named *{match}* was recorded")
    return (sum(e.time_range.elapsed_us() for e in ks) / reps / 1e3,
            len(ks) / reps)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_k2: needs a CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", default=None)
    args = ap.parse_args()

    import chip_smoke as cs
    from audio_transformers_tpu_torch.core import WhisperConfig
    from audio_transformers_tpu_torch.models.whisper import decode
    from audio_transformers_tpu_torch.ops import _build
    from audio_transformers_tpu_torch.ops import decode_logits as dl
    from audio_transformers_tpu_torch.ops import logit_processors as lp

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    _build.load(dl.SOURCE[torch.bfloat16])
    other = None
    if args.other:
        other = build_other(_build, args.other).fused_greedy_step
        other.argtypes = OTHER_ARGTYPES
        other.restype = ctypes.c_int

    cfg = WhisperConfig.tiny()
    v, d = cfg.vocab_size, cfg.d_model
    v_pad = dl.pad_vocab(v)
    gen = torch.Generator(device="cuda").manual_seed(0)
    table_t = torch.zeros((d, v_pad), device="cuda", dtype=torch.bfloat16)
    table_t[:, :v] = (torch.randn((v, d), generator=gen, device="cuda")
                      * 0.02).t().bfloat16()
    add = lp.suppress_vector(v_pad, decode.default_suppress_ids(cfg),
                             vocab=v, device="cuda")
    flush = torch.zeros(FLUSH_BYTES // 4, device="cuda")
    result = {"card": card, "shape": {"D": d, "V_pad": v_pad},
              "reps": REPS, "batches": {}}
    for b in BATCHES:
        hidden = torch.randn((b, d), generator=gen, device="cuda").bfloat16()
        seen = (torch.rand((b, v_pad), generator=gen, device="cuda")
                < 0.002).to(torch.int8)
        ban = (torch.rand((b, v_pad), generator=gen, device="cuda")
               < 0.0005).to(torch.int8)
        kw = {"seen": seen, "ban": ban, "penalty": 1.15}

        def this():
            return dl.fused_greedy_step(hidden, table_t, add, **kw)
        runs = {"this": this}
        if other is not None:
            tiles = v_pad // 256
            pf = torch.empty(4 * b * tiles, device="cuda")
            pi = torch.empty(4 * b * tiles, device="cuda", dtype=torch.int32)
            out = torch.empty(b, device="cuda", dtype=torch.int32)

            def run_other():
                rc = other(_build.ptr(hidden), _build.ptr(table_t),
                           _build.ptr(add), _build.ptr(seen), _build.ptr(ban),
                           1.15, None, None, None, 0, b, d, v_pad, 1,
                           _build.ptr(pf), _build.ptr(pi), _build.ptr(out),
                           _build.stream_ptr(hidden))
                _build.check(rc, "the other checkout's fused_greedy_step")
                return out
            l = dl.processed_logits(hidden, table_t, add, **kw)
            ok = cs._k2_decidable(l, False, None)
            got, got_other = this(), run_other()
            torch.cuda.synchronize()
            if not torch.equal(got[ok], got_other[ok]):
                raise RuntimeError(f"B={b}: the two kernels' tokens differ")
            runs = {"other": run_other, "this": this}
        order = ["other", "this", "this", "other"] if other else ["this"] * 2
        rec = {name: {"warm_ms": [], "cold_ms": [], "event_ms": [],
                      "kernels_per_call": None} for name in runs}
        for name in order:
            fn = runs[name]
            warm, per_call = kernel_ms(torch, fn, "greedy_")
            cold, _ = kernel_ms(torch, fn, "greedy_", flush=flush)
            rec[name]["warm_ms"].append(warm)
            rec[name]["cold_ms"].append(cold)
            rec[name]["event_ms"].append(cs.time_ms(fn))
            rec[name]["kernels_per_call"] = per_call
        bnd = cs.bound(cs.nbytes(hidden, table_t, add, seen, ban) + 4 * b,
                       2 * b * d * v_pad, cs.BF16_FLOPS)
        for name, r in rec.items():
            r["warm_median_ms"] = statistics.median(r["warm_ms"])
            r["cold_median_ms"] = statistics.median(r["cold_ms"])
            r["bound_share_cold"] = bnd[0] / r["cold_median_ms"]
            print(f"B={b:3d} {name:5s}: device warm "
                  + " ".join(f"{x:.4f}" for x in r["warm_ms"])
                  + " / cold " + " ".join(f"{x:.4f}" for x in r["cold_ms"])
                  + " ms, events " + " ".join(f"{x:.4f}" for x in r["event_ms"])
                  + f" ms, {r['kernels_per_call']:g} kernels per call; bound "
                  f"{bnd[0]:.4f} ms ({bnd[1]}): "
                  f"{100 * r['bound_share_cold']:.1f}% cold", flush=True)
        result["batches"][str(b)] = {"bound_ms": bnd[0], "bound_by": bnd[1],
                                     **rec}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
