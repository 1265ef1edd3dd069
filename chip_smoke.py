#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (audio_transformers_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA device, nvcc, and the repository around this file. Phases,
each raising on failure:

  1. the card: name and power limit (nvidia-smi);
  2. build the hand-written CUDA kernels from csrc/ (nvcc, sm_90a), one
     nvcc per source, all started together;
  3. each serving kernel against its plain PyTorch version on the card at
     the serving path's shapes (B in {4, 16}, T=1500, V=51865 padded to
     52224, 30 s audio), with the tolerances below, and their times
     (CUDA events, median of 20 after warm-up);
  4. correctness on a small input: the port's pipeline at the test config
     in float32 on the card (kernels) equals the same pipeline on the CPU
     (plain versions);
  5. the serving path: EmotionWhisperPipeline.analyze of a 12 s clip at the
     full width of whisper-tiny (seeded random weights, bfloat16), with
     every kernel's launch counter reset just before and read just after;
  6. the HTTP server on 127.0.0.1 with the micro-batcher, answering three
     concurrent /analyze requests;
  7. the flash-attention kernels K4a/b/c against their plain versions at
     the training shapes of whisper-tiny at batch 16 (B*H = 96, d = 64:
     encoder self-attention 1500 x 1500, decoder causal self-attention
     31 x 31, cross-attention 31 x 1500), float32 and bfloat16, and their
     times in bfloat16;
  8. correctness of one train step on a small input: the test config in
     float32, kernels on the card against plain versions on the CPU;
  9. the training path: the train_whisper CLI on whisper-tiny (bfloat16,
     synthetic 30 s clips, batch 8, 10 train steps and one eval), with
     every launch counter reset just before and read just after;
  10. a fixed batch overfit for 20 constant-lr steps: the loss falls;
  11. steady-state train-step time at batch 16, flash kernels against the
     plain attention, in turns;
  12. the beam reorder K5 against its plain version on the card, on the
     whisper-tiny beam step's own buffers at L=66 (8 self K/V of
     (rows, 6, 64, 66) in bf16, or in int8 with 8 f32 scales of
     (rows, 6, 66); the (rows, 52224) int8 seen mask; (rows, 66) int64
     tokens) at rows = 64 (B=16 x N=4) and 512 (B=128 x N=4), with
     repeated parents, and their times per call (CUDA events, median of 20
     after warm-up), as for the other kernels, and the device time of the
     kernels alone (torch.profiler);
  13. correctness on a small input: a beam pipeline (num_beams=3) at the
     test config in float32 on the card equals the same pipeline on the
     CPU;
  14. the beam serving path: EmotionWhisperPipeline(num_beams=4).analyze of
     a 12 s clip at whisper-tiny width (seeded weights, bfloat16), with
     kv_quant "none" and "int8", launch counters reset around each;
  15. the HTTP server with that beam pipeline, three concurrent requests;
  16. beam decode ms per step at B=16 and B=128 (N=4, seeded random
     encoder states), the K5 reorder against its plain version (one
     index_select per buffer, patched in for the plain turns), in five
     turns each: the time of a 64-token decode less that of a 16-token
     one, over 48.

Tolerances (kernel vs plain version, on the card):
  K1 decode_cross_attention: 1e-5 abs in float32 (sum order only);
     2e-2 abs in bfloat16 (one bf16 ulp of the output).
  K2 fused_greedy_step: tokens equal on every row whose plain top-2 gap
     (and, with timestamps, the margin of the probability rule) exceeds
     1e-3; rows below that gap are reported, not compared.
  K3 log_mel: 2e-4 abs on the final features (f32 sums in another order,
     then log10).
  K4a/b/c flash attention fwd, dq, dk/dv: in float32, max|err| <= 2e-5 *
     max(1, max|plain|) (sum order only); in bfloat16, within two bf16
     ulps at the tensor's largest magnitude (the output is rounded to
     bf16, and the kernel rounds p against its running maximum where the
     plain version takes the final one).
  K5 permute_rows: bit for bit (a pure copy).
  One train step, card vs CPU (test config, float32): losses within 1e-4
     relative; gradients within 1e-3 * max(1, max|cpu|) per leaf (log-mel
     features differ by up to 2e-4); updated parameters within 2 * lr + 1e-6
     (the first Adam update is +-lr per element, so an element whose tiny
     gradient flips sign under sum-order noise moves 2 * lr apart).

The next-to-last line is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Nothing of JAX is imported.
"""

from __future__ import annotations

import io
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
import wave

HERE = os.path.dirname(os.path.abspath(__file__))

K1_TOL_F32, K1_TOL_BF16, K2_GAP, K3_TOL = 1e-5, 2e-2, 1e-3, 2e-4
K4_TOL_F32, K4_ULPS_BF16 = 2e-5, 2
REPLACES = {
    "decode_cross_attention": "audio_transformers_tpu/ops/decode_attention.py:100",
    "fused_greedy_step": "audio_transformers_tpu/ops/decode_logits.py:82",
    "log_mel": "audio_transformers_tpu/ops/mel_pallas.py:67",
    "flash_attention_fwd": "audio_transformers_tpu/ops/attention.py:42",
    "flash_attention_bwd_dq": "audio_transformers_tpu/ops/attention.py:147",
    "flash_attention_bwd_dkv": "audio_transformers_tpu/ops/attention.py:187",
    "permute_rows": "audio_transformers_tpu/ops/permute.py:45",
}
SOURCES = {
    "decode_cross_attention": "audio_transformers_tpu_torch/csrc/decode_attention.cu",
    "fused_greedy_step": "audio_transformers_tpu_torch/csrc/decode_logits.cu",
    "log_mel": "audio_transformers_tpu_torch/csrc/mel.cu",
    "flash_attention_fwd": "audio_transformers_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_bwd_dq": "audio_transformers_tpu_torch/csrc/flash_attention.cu",
    "flash_attention_bwd_dkv": "audio_transformers_tpu_torch/csrc/flash_attention.cu",
    "permute_rows": "audio_transformers_tpu_torch/csrc/permute.cu",
}
SERVING = ("decode_cross_attention", "fused_greedy_step", "log_mel")
TRAINING = ("log_mel", "flash_attention_fwd", "flash_attention_bwd_dq",
            "flash_attention_bwd_dkv")
BEAM = ("permute_rows", "log_mel")
N_BEAMS = 4
# training shapes at whisper-tiny width and batch 16: (name, Tq, Tk, causal)
K4_SHAPES = (("encoder", 1500, 1500, False), ("decoder", 31, 31, True),
             ("cross", 31, 1500, False))


def synth_clip(duration, sr, *, freq=440.0, noise=0.05, seed=0):
    """Deterministic sine + noise clip (float32)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.arange(int(duration * sr)) / sr
    return (0.5 * np.sin(2 * math.pi * freq * t)
            + noise * rng.standard_normal(len(t))).astype(np.float32)


class ByteTokenizer:
    """UTF-8 bytes offset by 8 special ids: enough to turn the test
    config's token ids into comparable text."""

    def decode(self, ids, skip_special=True):
        data = bytes(i - 8 for i in ids if 8 <= i < 264)
        return data.decode("utf-8", errors="replace")


def log(*args):
    print(*args, flush=True)


def require(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, reps=20, warmup=3):
    """Median device time of fn() in ms, by CUDA events around each call."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps=20):
    """Device time of one fn() in ms: the summed time of the kernels it
    launched, from torch.profiler over `reps` calls after a warm-up. Unlike
    time_ms, it leaves out the host time of a call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    require(kernels, "the profiler recorded no kernel")
    return sum(e.time_range.elapsed_us() for e in kernels) / reps / 1e3


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_k1(torch, da, gen, results):
    dev = "cuda"
    h, hd, t = 6, 64, 1500
    worst = 0.0
    for b in (4, 16):
        q = torch.randn((b, h, hd), generator=gen, device=dev)
        k = torch.randn((b, h, hd, t), generator=gen, device=dev)
        v = torch.randn((b, h, hd, t), generator=gen, device=dev)
        ks = k.abs().amax(dim=2) / 127.0
        vs = v.abs().amax(dim=3) / 127.0
        k8 = torch.round(k / ks[:, :, None, :]).to(torch.int8)
        v8 = torch.round(v / vs[:, :, :, None]).to(torch.int8)
        cases = [("f32", q, k, v, {}, K1_TOL_F32),
                 ("bf16", q.bfloat16(), k.bfloat16(), v.bfloat16(), {},
                  K1_TOL_BF16),
                 ("int8+bf16q", q.bfloat16(), k8, v8,
                  {"k_scale": ks, "v_scale": vs}, K1_TOL_BF16),
                 ("int8+f32q", q, k8, v8, {"k_scale": ks, "v_scale": vs},
                  K1_TOL_F32)]
        for name, qq, kk, vv, kw, tol in cases:
            got = da.decode_cross_attention(qq, kk, vv, **kw)
            want = da.decode_cross_attention_reference(qq, kk, vv, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            log(f"K1 B={b} {name:10s} max_abs_err={err:.3e} (tol {tol})")
            require(err <= tol, f"K1 {name} B={b}: {err} > {tol}")
            if name != "f32":
                worst = max(worst, err)
        # the serving path's operands: bf16 q, bf16 K/V
        qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
        ms = time_ms(lambda: da.decode_cross_attention(qb, kb, vb))
        plain = time_ms(lambda: da.decode_cross_attention_reference(qb, kb,
                                                                    vb))
        log(f"K1 B={b} bf16 time: kernel {ms:.4f} ms, plain {plain:.4f} ms")
        results.setdefault(b, {})["decode_cross_attention"] = (ms, plain)
    return worst


def _k2_decidable(l, ts, tb):
    """Rows whose token the kernel must reproduce: the plain top-2 gap in
    the region the token comes from (and the probability rule's margin,
    in ts mode) exceeds K2_GAP."""
    import torch

    def gap(x):
        top = x.topk(2, dim=-1).values
        return top[:, 0] - top[:, 1]

    if not ts:
        return gap(l) > K2_GAP
    margin = torch.logsumexp(l[:, tb:], dim=-1) - l[:, :tb].amax(dim=-1)
    region_gap = torch.where(margin > 0, gap(l[:, tb:]), gap(l))
    return (margin.abs() > K2_GAP) & (region_gap > K2_GAP)


def check_k2(torch, dl, lp, decode, cfg, gen, results):
    dev = "cuda"
    v, d = cfg.vocab_size, cfg.d_model
    v_pad = dl.pad_vocab(v)
    table = torch.randn((v, d), generator=gen, device=dev) * 0.02
    table_t = torch.zeros((d, v_pad), device=dev, dtype=torch.bfloat16)
    table_t[:, :v] = table.t().bfloat16()
    add = lp.suppress_vector(v_pad, decode.default_suppress_ids(cfg),
                             vocab=v, device=dev)
    worst, below = 0, 0
    tb = cfg.timestamp_begin_id
    for b in (4, 16):
        hidden = torch.randn((b, d), generator=gen, device=dev).bfloat16()
        seen = (torch.rand((b, v_pad), generator=gen, device=dev) < 0.002
                ).to(torch.int8)
        ban = (torch.rand((b, v_pad), generator=gen, device=dev) < 0.0005
               ).to(torch.int8)
        # histories in three timestamp states, so that both sides of the
        # probability rule occur: a closed pair (timestamps banned), a
        # lone timestamp (text banned), an earlier one (monotonic floor)
        hist = torch.randint(0, tb - 1000, (b, 20), generator=gen,
                             device=dev)
        ts_tok = torch.randint(tb, tb + 1000, (b, 2), generator=gen,
                               device=dev)
        state = torch.arange(b, device=dev) % 3
        hist[state == 0, 12:14] = ts_tok[state == 0]
        hist[state == 1, 13] = ts_tok[state == 1, 0]
        hist[state == 2, 11] = ts_tok[state == 2, 0]
        bounds = lp.timestamp_row_bounds(hist, 14, begin_index=3,
                                         timestamp_begin=tb,
                                         eos_token_id=cfg.eos_token_id)
        modes = {"penalty+ban": {"seen": seen, "ban": ban, "penalty": 1.15},
                 "ts": {"seen": seen, "ban": ban, "penalty": 1.15,
                        "ts_bounds": bounds, "timestamp_begin": tb}}
        for name, kw in modes.items():
            got = dl.fused_greedy_step(hidden, table_t, add, **kw)
            want = dl.fused_greedy_step_reference(hidden, table_t, add, **kw)
            l = dl.processed_logits(hidden, table_t, add, **kw)
            ok = _k2_decidable(l, "ts_bounds" in kw, tb)
            torch.cuda.synchronize()
            n_below = int((~ok).sum())
            diff = (got.long() - want.long()).abs()[ok]
            err = int(diff.max()) if diff.numel() else 0
            mism = int((got != want).sum())
            log(f"K2 B={b} {name:11s} tokens equal on "
                f"{int(ok.sum()) - int((diff != 0).sum())}/{int(ok.sum())} "
                f"decidable rows; rows below the {K2_GAP} gap: {n_below}; "
                f"mismatches overall: {mism}")
            require(err == 0, f"K2 {name} B={b}: tokens differ")
            worst, below = max(worst, err), below + n_below
        kw = modes["penalty+ban"]
        ms = time_ms(lambda: dl.fused_greedy_step(hidden, table_t, add, **kw))
        plain = time_ms(lambda: dl.fused_greedy_step_reference(
            hidden, table_t, add, **kw))
        log(f"K2 B={b} penalty+ban time: kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms")
        results[b]["fused_greedy_step"] = (ms, plain)
    return worst, below


def check_k3(torch, mel, mel_cfg, gen, results):
    worst = 0.0
    for b in (4, 16):
        wav = 0.3 * torch.randn((b, 480000), generator=gen, device="cuda")
        got = mel.log_mel(wav, mel_cfg)
        want = mel.log_mel_torch(wav, mel_cfg)
        torch.cuda.synchronize()
        require(got.shape == (b, 3000, mel_cfg.n_mels),
                f"K3 shape {tuple(got.shape)}")
        err = (got - want).abs().max().item()
        log(f"K3 B={b} max_abs_err={err:.3e} (tol {K3_TOL})")
        require(err <= K3_TOL, f"K3 B={b}: {err} > {K3_TOL}")
        worst = max(worst, err)
        ms = time_ms(lambda: mel.log_mel(wav, mel_cfg))
        plain = time_ms(lambda: mel.log_mel_torch(wav, mel_cfg))
        log(f"K3 B={b} time: kernel {ms:.4f} ms, plain {plain:.4f} ms")
        results[b]["log_mel"] = (ms, plain)
    return worst


# ---------------------------------------------------------------------------
# phases 4-6: the pipeline
# ---------------------------------------------------------------------------


def check_result(out, n_segments, n_classes):
    require(isinstance(out["transcription"], str), "transcription is a str")
    require(len(out["segments"]) == n_segments,
            f"{len(out['segments'])} segments, want {n_segments}")
    for seg in out["segments"]:
        require(set(seg) >= {"start", "end", "text", "emotion",
                             "emotion_probs"}, f"segment keys {set(seg)}")
        probs = list(seg["emotion_probs"].values())
        require(len(probs) == n_classes, "one probability per class")
        require(all(math.isfinite(p) and 0.0 <= p <= 1.0 for p in probs),
                "finite probabilities")
        require(abs(sum(probs) - 1.0) < 1e-3,
                f"probabilities sum to {sum(probs)}")


def check_small_reference(torch, EmotionWhisperConfig, WhisperConfig, init,
                          Pipeline, synth_clip, ByteTokenizer):
    cfg = EmotionWhisperConfig(whisper=WhisperConfig.test(),
                               num_emotion_classes=4)
    params = init(cfg, torch.Generator().manual_seed(1))
    outs = []
    for dev in ("cuda", "cpu"):
        pipe = Pipeline(params, cfg, tokenizer=ByteTokenizer(), device=dev,
                        compute_dtype=torch.float32)
        outs.append(pipe.analyze(synth_clip(3.0, 16000, seed=2), 16000,
                                 segment_duration=1.0))
    gpu, cpu = outs
    check_result(gpu, 3, 4)
    require(gpu["transcription"] == cpu["transcription"],
            "test-config transcription: card vs CPU")
    err = 0.0
    for g, c in zip(gpu["segments"], cpu["segments"]):
        require(g["text"] == c["text"], "test-config segment text")
        err = max(err, max(abs(g["emotion_probs"][k] - c["emotion_probs"][k])
                           for k in c["emotion_probs"]))
    log(f"small reference: texts equal, probs max_abs_err={err:.3e} "
        f"(tol 1e-4)")
    require(err <= 1e-4, f"test-config probabilities differ by {err}")


def _wav_bytes(audio, sr):
    import numpy as np
    buf = io.BytesIO()
    pcm = (np.clip(audio, -1, 1) * 32767.0).astype("<i2")
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def check_server(pipe, synth_clip):
    from http.server import ThreadingHTTPServer

    from audio_transformers_tpu_torch.serve.http_server import (MicroBatcher,
                                                                make_handler)

    batcher = MicroBatcher(pipe.analyze_windows, max_wait_ms=50.0)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                make_handler(pipe, 5.0, batcher=batcher))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/analyze"
    results = [None] * 3

    def post(i):
        body = _wav_bytes(synth_clip(12.0, 16000, freq=220.0 * (i + 1),
                                     seed=i), 16000)
        req = urllib.request.Request(url, data=body, method="POST")
        with urllib.request.urlopen(req, timeout=600) as r:
            results[i] = (r.status, json.loads(r.read()))

    try:
        t0 = time.perf_counter()
        posts = [threading.Thread(target=post, args=(i,)) for i in range(3)]
        for p in posts:
            p.start()
        for p in posts:
            p.join()
        wall = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
        thread.join(timeout=10)
    for i, res in enumerate(results):
        require(res is not None, f"request {i} got no answer")
        status, out = res
        require(status == 200, f"request {i}: HTTP {status}")
        check_result(out, 3, 10)
    log(f"server: 3 concurrent /analyze requests answered 200 in "
        f"{wall:.3f} s; micro-batcher stats {batcher.stats}")


# ---------------------------------------------------------------------------
# phases 7-11: the training path
# ---------------------------------------------------------------------------


def _k4_err(got, want, dtype):
    """(max abs error, limit) of a K4 output against its plain version."""
    import torch
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if dtype == torch.float32:
        return err, K4_TOL_F32 * max(1.0, scale)
    return err, K4_ULPS_BF16 * 2.0 ** (math.floor(math.log2(scale)) - 7)


def check_k4(torch, att, gen, times):
    """K4a/b/c against their plain versions; returns the worst bf16 error
    of each."""
    worst = {n: 0.0 for n in ("flash_attention_fwd",
                              "flash_attention_bwd_dq",
                              "flash_attention_bwd_dkv")}
    bh, d = 16 * 6, 64
    for name, tq, tk, causal in K4_SHAPES:
        q32 = torch.randn((bh, tq, d), generator=gen, device="cuda") / 8.0
        k32 = torch.randn((bh, tk, d), generator=gen, device="cuda")
        v32 = torch.randn((bh, tk, d), generator=gen, device="cuda")
        g32 = torch.randn((bh, tq, d), generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, g = (x.to(dtype) for x in (q32, k32, v32, g32))
            out, lse = att.flash_attention_fwd(q, k, v, causal)
            p_out, p_lse = att.flash_attention_fwd_reference(q, k, v, causal)
            # both backward versions run from the plain forward's residuals
            delta = (g.float() * p_out.float()).sum(-1)
            bwd = (q, k, v, g, p_lse, delta, causal)
            dq = att.flash_attention_bwd_dq(*bwd)
            dk, dv = att.flash_attention_bwd_dkv(*bwd)
            p_dq = att.flash_attention_bwd_dq_reference(*bwd)
            p_dk, p_dv = att.flash_attention_bwd_dkv_reference(*bwd)
            torch.cuda.synchronize()
            lse_err = (lse - p_lse).abs().max().item()
            require(lse_err <= 1e-4, f"K4a {name} lse: {lse_err}")
            for kern, got, want in (("flash_attention_fwd", out, p_out),
                                    ("flash_attention_bwd_dq", dq, p_dq),
                                    ("flash_attention_bwd_dkv", dk, p_dk),
                                    ("flash_attention_bwd_dkv", dv, p_dv)):
                err, tol = _k4_err(got, want, dtype)
                require(got.dtype == dtype and got.shape == want.shape,
                        f"{kern} {name}: dtype/shape")
                require(err <= tol, f"{kern} {name} {dtype}: {err} > {tol}")
                if dtype == torch.bfloat16:
                    worst[kern] = max(worst[kern], err)
            log(f"K4 {name} {str(dtype)[6:]:8s} max_abs_err out "
                f"{_k4_err(out, p_out, dtype)[0]:.3e} lse {lse_err:.3e} "
                f"dq {_k4_err(dq, p_dq, dtype)[0]:.3e} "
                f"dk {_k4_err(dk, p_dk, dtype)[0]:.3e} "
                f"dv {_k4_err(dv, p_dv, dtype)[0]:.3e}")
        # the training path's operands: bf16
        t = {"flash_attention_fwd": (
                time_ms(lambda: att.flash_attention_fwd(q, k, v, causal)),
                time_ms(lambda: att.flash_attention_fwd_reference(
                    q, k, v, causal))),
             "flash_attention_bwd_dq": (
                time_ms(lambda: att.flash_attention_bwd_dq(*bwd)),
                time_ms(lambda: att.flash_attention_bwd_dq_reference(*bwd))),
             "flash_attention_bwd_dkv": (
                time_ms(lambda: att.flash_attention_bwd_dkv(*bwd)),
                time_ms(lambda: att.flash_attention_bwd_dkv_reference(
                    *bwd)))}
        log(f"K4 {name} bf16 time (kernel / plain ms): " + ", ".join(
            f"{n[16:]} {a:.4f} / {b:.4f}" for n, (a, b) in t.items()))
        times[name] = t
    return worst


def train_batch(b, duration, w, n_classes, seed, max_len=32):
    """A host batch in the trainer's schema: sine-plus-noise clips, label
    rows [start, tokens..., eos, pad...] of max_len ids drawn from the
    config's vocab, one emotion class per clip."""
    import numpy as np
    rng = np.random.default_rng(seed)
    labels = np.full((b, max_len), w.pad_token_id, np.int32)
    for i in range(b):
        n = int(rng.integers(3, max_len - 2))
        seq = [w.decoder_start_token_id,
               *rng.integers(10, w.vocab_size, n).tolist(), w.eos_token_id]
        labels[i, :len(seq)] = seq
    wav = np.stack([synth_clip(duration, 16000, freq=150.0 * (i % 7 + 1),
                               seed=seed + i) for i in range(b)])
    return {"waveform": wav, "labels": labels,
            "emotion_labels": (np.arange(b) % n_classes).astype(np.int32),
            "valid": np.ones(b, bool)}


def _fresh(torch, params, device):
    from audio_transformers_tpu_torch.core import params as cp
    return cp.set_trainable(cp.map_tensors(
        params, lambda t: t.detach().to(device, torch.float32).clone()))


def check_small_train_step(torch, port, init):
    """One train step at the test config in float32: card vs CPU."""
    from audio_transformers_tpu_torch.core import params as cp
    from audio_transformers_tpu_torch.train import whisper_emotion as tw
    from audio_transformers_tpu_torch.train.optim import build_optimizer
    cfg = port.EmotionWhisperConfig(whisper=port.WhisperConfig.test(),
                                    num_emotion_classes=4)
    w, lr = cfg.whisper, 1e-4
    tcfg = port.TrainConfig(batch_size=4, compute_dtype="float32",
                            attn_impl="flash",
                            optimizer=port.OptimizerConfig(
                                name="adamw", learning_rate=lr,
                                weight_decay=0.01))
    dur = 2 * w.max_source_positions * 160 / 16000
    batch = train_batch(4, dur, w, 4, seed=5, max_len=12)
    params0 = init(cfg, torch.Generator().manual_seed(3))
    runs = {}
    for dev in ("cuda", "cpu"):
        params = _fresh(torch, params0, dev)
        opt = build_optimizer(tcfg.optimizer, params)
        step, _ = tw.make_steps(cfg, port.MelConfig.whisper(), tcfg, opt, dev)
        metrics = step(params, tw.batch_to_device(batch, dev))
        runs[dev] = ({k: v.item() for k, v in metrics.items()},
                     dict(cp.leaves_with_path(params)))
    (gm, gp), (cm, cparams) = runs["cuda"], runs["cpu"]
    for k in ("loss", "transcription_loss", "emotion_loss"):
        require(abs(gm[k] - cm[k]) <= 1e-4 * abs(cm[k]),
                f"train step {k}: card {gm[k]} vs CPU {cm[k]}")
    g_err = p_err = 0.0
    for path, t in gp.items():
        c = cparams[path]
        p_err = max(p_err, (t.detach().cpu() - c.detach()).abs().max().item())
        if c.grad is not None:
            e = (t.grad.cpu() - c.grad).abs().max().item()
            require(e <= 1e-3 * max(1.0, c.grad.abs().max().item()),
                    f"train step grad {path}: {e}")
            g_err = max(g_err, e)
    require(p_err <= 2 * lr + 1e-6, f"train step params differ by {p_err}")
    log(f"small train step (test config, f32, flash): loss card "
        f"{gm['loss']:.6f} vs CPU {cm['loss']:.6f}; grads max_abs_err "
        f"{g_err:.3e}; updated params max_abs_err {p_err:.3e} "
        f"(bound {2 * lr + 1e-6:.1e})")


def check_train_cli(torch, _build):
    """The training path at whisper-tiny width through the CLI."""
    import tempfile

    from audio_transformers_tpu_torch.cli import train_whisper
    with tempfile.TemporaryDirectory() as out_dir:
        args = ["--dataset", "synthetic", "--model_size", "tiny",
                "--compute_dtype", "bfloat16", "--batch_size", "8",
                "--num_samples", "100", "--num_epochs", "1",
                "--num_workers", "4", "--device", "cuda",
                "--output_dir", out_dir]
        torch.cuda.synchronize()
        _build.reset_stats()
        t0 = time.perf_counter()
        out = train_whisper.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = {name: (s.launches, s.plain_cuda_calls)
                 for name, s in _build.STATS.items()}
        require(os.path.exists(os.path.join(out_dir, "metrics.jsonl")),
                "metrics.jsonl written")
    log(f"train_whisper (whisper-tiny, bf16, 30 s clips, batch 8, "
        f"{out['optimizer'].count} steps + eval): {wall:.3f} s; "
        f"launches / plain-on-CUDA calls: {stats}")
    require(out["optimizer"].count == 10, "ten train steps")
    for name in TRAINING:
        require(stats[name][0] > 0,
                f"{name} was not launched on the training path")
    for name, (_, plain) in stats.items():
        require(plain == 0, f"{name}'s plain version ran on CUDA")
    for row in out["history"]:
        for key, val in row.items():
            if "loss" in key:
                require(math.isfinite(val), f"{key} = {val}")
    log(f"train_whisper history: {json.dumps(out['history'])}")
    return {name: stats[name][0] for name in TRAINING}


def _tiny_steps(torch, port, params0, attn, lr, batch_size):
    from audio_transformers_tpu_torch.train import whisper_emotion as tw
    from audio_transformers_tpu_torch.train.optim import build_optimizer
    cfg = port.EmotionWhisperConfig(num_emotion_classes=9)
    tcfg = port.TrainConfig(batch_size=batch_size, compute_dtype="bfloat16",
                            attn_impl=attn,
                            optimizer=port.OptimizerConfig(
                                name="adamw", learning_rate=lr))
    params = _fresh(torch, params0, "cuda")
    opt = build_optimizer(tcfg.optimizer, params)
    step, _ = tw.make_steps(cfg, port.MelConfig.whisper(), tcfg, opt, "cuda")
    return lambda batch: step(params, batch)


def check_overfit(torch, port, params0):
    from audio_transformers_tpu_torch.train.whisper_emotion import \
        batch_to_device
    w = port.WhisperConfig()
    batch = batch_to_device(train_batch(4, 30.0, w, 9, seed=11), "cuda")
    step = _tiny_steps(torch, port, params0, "flash", 5e-4, 4)
    losses = [step(batch)["loss"].item() for _ in range(20)]
    require(all(math.isfinite(x) for x in losses), "finite overfit losses")
    log(f"overfit (whisper-tiny, bf16, flash, one batch of 4, 20 steps at "
        f"lr 5e-4): loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    require(losses[-1] < losses[0], "the overfit loss did not fall")
    return losses[0], losses[-1]


def time_train_step(torch, port, params0):
    """Steady-state train-step ms at batch 16: plain attention vs flash
    kernels, in turns (plain, flash, flash, plain)."""
    from audio_transformers_tpu_torch.train.whisper_emotion import \
        batch_to_device
    w = port.WhisperConfig()
    batch = batch_to_device(train_batch(16, 30.0, w, 9, seed=13), "cuda")
    runs = {}
    for attn in ("xla", "flash", "flash", "xla"):
        step = _tiny_steps(torch, port, params0, attn, 3e-5, 16)
        for _ in range(2):
            step(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            step(batch)
        torch.cuda.synchronize()
        runs.setdefault(attn, []).append(
            (time.perf_counter() - t0) / 5 * 1e3)
        del step
        torch.cuda.empty_cache()
    log(f"train step (whisper-tiny, bf16, batch 16, 30 s clips), ms per "
        f"step over 5 steps, two turns each: plain attention "
        f"{runs['xla']}, flash kernels {runs['flash']}")
    return {k: statistics.mean(v) for k, v in runs.items()}


# ---------------------------------------------------------------------------
# phases 12-16: beam search
# ---------------------------------------------------------------------------


def _k5_bufs(torch, rows, mode, gen):
    """The whisper-tiny beam step's per-beam buffers at L=66: 8 self K/V
    (4 layers x k, v), in int8 mode with 8 f32 scales, then the int8 seen
    mask at the padded vocab width and the int64 token rows."""
    dev, length = "cuda", 66
    kv = [torch.randn((rows, 6, 64, length), generator=gen, device=dev)
          for _ in range(8)]
    if mode == "bf16":
        bufs = [x.bfloat16() for x in kv]
    else:
        bufs = [x.mul(40).clamp(-127, 127).to(torch.int8) for x in kv]
        bufs += [torch.rand((rows, 6, length), generator=gen, device=dev)
                 for _ in range(8)]
    bufs.append((torch.rand((rows, 52224), generator=gen, device=dev) < 0.01
                 ).to(torch.int8))
    bufs.append(torch.randint(0, 51865, (rows, length), generator=gen,
                              device=dev))
    return bufs


def check_k5(torch, pm, gen):
    """K5 against its plain version, bit for bit, and both times, at the
    beam path's row counts; returns {(rows, mode): (ms per call, plain ms
    per call, device ms, plain device ms)}. A call's time (time_ms, as for
    K1-K4) includes the wrapper's host work where the card waits for it;
    the device times are the kernels' own (the plain version's 10 or 18
    index_select kernels summed)."""
    times = {}
    for rows in (N_BEAMS * 16, N_BEAMS * 128):
        for mode in ("bf16", "int8"):
            bufs = _k5_bufs(torch, rows, mode, gen)
            # beam-structured parents: each row's parent is a beam of its
            # own batch row, so parents repeat
            perm = ((torch.arange(rows, device="cuda") // N_BEAMS) * N_BEAMS
                    + torch.randint(0, N_BEAMS, (rows,), generator=gen,
                                    device="cuda"))
            got = pm.permute_rows(bufs, perm)
            want = pm.permute_rows_reference(bufs, perm)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                require(a.dtype == b.dtype and torch.equal(a, b),
                        f"K5 {mode} rows={rows}: not bit exact")
            out, out_plain = got, want

            def kernel():
                pm.permute_rows(bufs, perm, out=out)

            def plain():
                pm.permute_rows_reference(bufs, perm, out=out_plain)
            t = (time_ms(kernel), time_ms(plain), device_ms(kernel),
                 device_ms(plain))
            moved = 2 * sum(a.nbytes for a in bufs)
            log(f"K5 rows={rows} {mode}: {len(bufs)} buffers, bit exact; "
                f"per call kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms; device "
                f"time kernel {t[2]:.4f} ms ({moved / t[2] / 1e6:.1f} GB/s "
                f"of {moved / 1e6:.1f} MB read + written), plain "
                f"{t[3]:.4f} ms")
            times[(rows, mode)] = t
            del bufs, got, want, out, out_plain
    return times


def check_small_beam(torch, EmotionWhisperConfig, WhisperConfig, init,
                     Pipeline):
    cfg = EmotionWhisperConfig(whisper=WhisperConfig.test(),
                               num_emotion_classes=4)
    params = init(cfg, torch.Generator().manual_seed(1))
    outs = []
    for dev in ("cuda", "cpu"):
        pipe = Pipeline(params, cfg, tokenizer=ByteTokenizer(), device=dev,
                        compute_dtype=torch.float32, num_beams=3)
        outs.append(pipe.analyze(synth_clip(3.0, 16000, seed=2), 16000,
                                 segment_duration=1.0))
    gpu, cpu = outs
    check_result(gpu, 3, 4)
    require(gpu["transcription"] == cpu["transcription"],
            "test-config beam transcription: card vs CPU")
    err = 0.0
    for g, c in zip(gpu["segments"], cpu["segments"]):
        require(g["text"] == c["text"], "test-config beam segment text")
        err = max(err, max(abs(g["emotion_probs"][k] - c["emotion_probs"][k])
                           for k in c["emotion_probs"]))
    log(f"small beam reference (num_beams=3): texts equal, probs "
        f"max_abs_err={err:.3e} (tol 1e-4)")
    require(err <= 1e-4, f"test-config beam probabilities differ by {err}")


def check_beam_serving(torch, _build, Pipeline, params, cfg, clip):
    """analyze through beam search at whisper-tiny width, kv_quant none and
    int8; returns ({mode: launch stats}, the "none" pipeline)."""
    runs, pipes = {}, {}
    for mode in ("none", "int8"):
        pipe = Pipeline(params, cfg, device="cuda",
                        compute_dtype=torch.bfloat16, kv_quant=mode,
                        num_beams=N_BEAMS)
        torch.cuda.synchronize()
        _build.reset_stats()
        t0 = time.perf_counter()
        out = pipe.analyze(clip, 16000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = {name: (s.launches, s.plain_cuda_calls)
                 for name, s in _build.STATS.items()}
        log(f"beam analyze (num_beams={N_BEAMS}, kv_quant={mode}, "
            f"whisper-tiny, bf16, 12 s clip, first call): {wall:.3f} s; "
            f"launches / plain-on-CUDA calls: {stats}")
        check_result(out, 3, cfg.num_emotion_classes)
        for name, (_, plain) in stats.items():
            require(plain == 0, f"{name}'s plain version ran on CUDA "
                                f"(beam, {mode})")
        for name in BEAM:
            require(stats[name][0] > 0,
                    f"{name} was not launched on the beam path ({mode})")
        log(f"beam analyze ({mode}): K1 decode_cross_attention launches "
            f"{stats['decode_cross_attention'][0]}, K2 fused_greedy_step "
            f"launches {stats['fused_greedy_step'][0]} (the beam path "
            f"calls neither)")
        t0 = time.perf_counter()
        pipe.analyze(clip, 16000)
        torch.cuda.synchronize()
        log(f"beam analyze ({mode}, same clip, second call): "
            f"{time.perf_counter() - t0:.3f} s")
        runs[mode], pipes[mode] = stats, pipe
    del pipes["int8"]
    return runs, pipes["none"]


def time_beam_steps(torch, beam, pm, cfg, params):
    """Beam decode ms per step at N=4, B in {16, 128}: the K5 reorder
    ("k5") against its plain version ("plain", one index_select per
    buffer, patched into the beam module for its turns), five turns each
    in the order plain, k5, k5, plain, ... (ABBA); each turn times a
    64-token and a 16-token decode of the same seeded encoder states, and
    the step time is their difference over 48. Returns the median turn of
    each."""
    from audio_transformers_tpu_torch.core import DecodeConfig
    from audio_transformers_tpu_torch.core.params import to_device
    w = cfg.whisper
    p = to_device(params["whisper"], "cuda")
    reorders = {"k5": beam.permute_rows, "plain": pm.permute_rows_reference}
    result = {}
    for b in (16, 128):
        enc = torch.randn((b, w.max_source_positions, w.d_model),
                          generator=torch.Generator().manual_seed(b)
                          ).to("cuda", torch.bfloat16)

        def decode(impl, new):
            dcfg = DecodeConfig(max_new_tokens=new, num_beams=N_BEAMS,
                                repetition_penalty=1.15,
                                no_repeat_ngram_size=3)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            beam.permute_rows = reorders[impl]
            try:
                out = beam.generate_beam(p, w, dcfg, enc)
            finally:
                beam.permute_rows = reorders["k5"]
            torch.cuda.synchronize()
            return time.perf_counter() - t0, out

        toks = {impl: decode(impl, 64)[1]["tokens"] for impl in reorders}
        require(torch.equal(toks["k5"], toks["plain"]),
                f"beam B={b}: K5 and plain reorders give other tokens")
        turns = {"k5": [], "plain": []}
        for impl in ("plain", "k5", "k5", "plain") * 2 + ("plain", "k5"):
            t64, _ = decode(impl, 64)
            t16, _ = decode(impl, 16)
            turns[impl].append((t64 - t16) / 48 * 1e3)
        log(f"beam decode B={b} N={N_BEAMS} (L=66, whisper-tiny, bf16): ms "
            f"per step, five turns each: K5 reorder {turns['k5']}, plain "
            f"index_select {turns['plain']}")
        result[b] = {k: statistics.median(v) for k, v in turns.items()}
        del enc
        torch.cuda.empty_cache()
    return result


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        import audio_transformers_tpu_torch as port
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 1
    if not os.path.abspath(port.__file__).startswith(HERE + os.sep):
        print("chip_smoke: imported a port from outside this checkout",
              file=sys.stderr)
        return 1

    from audio_transformers_tpu_torch import core as port_core
    from audio_transformers_tpu_torch.core import (EmotionWhisperConfig,
                                                   MelConfig, WhisperConfig)
    from audio_transformers_tpu_torch.core.params import init
    from audio_transformers_tpu_torch.infer.pipeline import \
        EmotionWhisperPipeline
    from audio_transformers_tpu_torch.models.whisper import beam, decode
    from audio_transformers_tpu_torch.ops import _build
    from audio_transformers_tpu_torch.ops import attention as att
    from audio_transformers_tpu_torch.ops import decode_attention as da
    from audio_transformers_tpu_torch.ops import decode_logits as dl
    from audio_transformers_tpu_torch.ops import logit_processors as lp
    from audio_transformers_tpu_torch.ops import mel
    from audio_transformers_tpu_torch.ops import permute as pm

    # the plain versions are the oracle: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(smi[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, "
        f"device {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {', '.join(_build.KERNEL_SOURCES)} in "
        f"{time.perf_counter() - t0:.1f} s")

    # 3. kernels vs plain versions at the serving shapes
    cfg = EmotionWhisperConfig()
    w = cfg.whisper
    require((w.d_model, w.encoder_layers, w.decoder_layers, w.num_heads,
             w.vocab_size, w.max_source_positions)
            == (384, 4, 4, 6, 51865, 1500), "whisper-tiny geometry")
    gen = torch.Generator(device="cuda").manual_seed(0)
    times = {}
    err = {"decode_cross_attention": check_k1(torch, da, gen, times)}
    err["fused_greedy_step"], below = check_k2(torch, dl, lp, decode, w, gen,
                                               times)
    err["log_mel"] = check_k3(torch, mel, MelConfig.whisper(), gen, times)

    # 4. correctness on a small input: card (kernels) vs CPU (plain)
    check_small_reference(torch, EmotionWhisperConfig, WhisperConfig, init,
                          EmotionWhisperPipeline, synth_clip, ByteTokenizer)

    # 5. the serving path at whisper-tiny width
    params = init(cfg, torch.Generator().manual_seed(0))
    pipe = EmotionWhisperPipeline(params, cfg, device="cuda",
                                  compute_dtype=torch.bfloat16)
    clip = synth_clip(12.0, 16000)
    torch.cuda.synchronize()
    _build.reset_stats()
    t0 = time.perf_counter()
    out = pipe.analyze(clip, 16000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = {name: (s.launches, s.plain_cuda_calls)
             for name, s in _build.STATS.items()}
    log(f"analyze (whisper-tiny, bf16, 12 s clip, first call): {wall:.3f} s; "
        f"launches / plain-on-CUDA calls: {stats}")
    check_result(out, 3, cfg.num_emotion_classes)
    for name, (launches, plain) in stats.items():
        require(plain == 0, f"{name}'s plain version ran on CUDA")
    for name in SERVING:
        require(stats[name][0] > 0,
                f"{name} was not launched on the serving path")
    t0 = time.perf_counter()
    pipe.analyze(clip, 16000)
    torch.cuda.synchronize()
    log(f"analyze (same clip, second call): {time.perf_counter() - t0:.3f} s")

    # 6. the HTTP server
    check_server(pipe, synth_clip)
    del pipe
    torch.cuda.empty_cache()

    # 7. K4 against its plain versions at the training shapes
    k4_times = {}
    err.update(check_k4(torch, att, gen, k4_times))

    # 8. one train step at the test config: card vs CPU
    check_small_train_step(torch, port_core, init)

    # 9. the training path at whisper-tiny width, through the CLI
    train_launches = check_train_cli(torch, _build)

    # 10-11. overfit on one batch; steady-state step time, flash vs plain
    params = init(EmotionWhisperConfig(num_emotion_classes=9),
                  torch.Generator().manual_seed(0))
    check_overfit(torch, port_core, params)
    step_ms = time_train_step(torch, port_core, params)
    log(f"train step mean ms (batch 16): plain attention "
        f"{step_ms['xla']:.3f}, flash kernels {step_ms['flash']:.3f}")
    del params
    torch.cuda.empty_cache()

    # 12. K5 against its plain version at the beam step's buffers
    k5_times = check_k5(torch, pm, gen)
    err["permute_rows"] = 0.0

    # 13. a beam pipeline at the test config: card vs CPU
    check_small_beam(torch, EmotionWhisperConfig, WhisperConfig, init,
                     EmotionWhisperPipeline)

    # 14. the beam serving path at whisper-tiny width, kv_quant none, int8
    params = init(cfg, torch.Generator().manual_seed(0))
    beam_runs, pipe = check_beam_serving(torch, _build,
                                         EmotionWhisperPipeline, params, cfg,
                                         clip)

    # 15. the HTTP server with the beam pipeline
    check_server(pipe, synth_clip)
    del pipe
    torch.cuda.empty_cache()

    # 16. beam decode ms per step, K5 against the plain reorder
    beam_ms = time_beam_steps(torch, beam, pm, cfg, params)

    kernels = []
    for name in SERVING:
        ms, plain = times[4][name]
        ms16, plain16 = times[16][name]
        entry = {"name": name, "route": "cuda", "source": SOURCES[name],
                 "replaces": REPLACES[name], "launches": stats[name][0],
                 "max_abs_err": err[name], "ms": ms, "plain_ms": plain,
                 "ms_b16": ms16, "plain_ms_b16": plain16}
        if name in train_launches:
            entry["launches_training"] = train_launches[name]
        kernels.append(entry)
    for name in TRAINING[1:]:
        ms, plain = k4_times["encoder"][name]
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCES[name], "replaces": REPLACES[name],
                        "launches": train_launches[name],
                        "max_abs_err": err[name], "ms": ms, "plain_ms": plain,
                        **{f"{k}_ms": k4_times[k][name][0]
                           for k in ("decoder", "cross")},
                        **{f"{k}_plain_ms": k4_times[k][name][1]
                           for k in ("decoder", "cross")}})
    kernels.append({
        "name": "permute_rows", "route": "cuda",
        "source": SOURCES["permute_rows"],
        "replaces": REPLACES["permute_rows"],
        "launches": beam_runs["none"]["permute_rows"][0],
        "launches_int8": beam_runs["int8"]["permute_rows"][0],
        "max_abs_err": err["permute_rows"],
        "ms": k5_times[(64, "bf16")][0], "plain_ms": k5_times[(64, "bf16")][1],
        **{f"{key}_{rows}{'' if mode == 'bf16' else '_int8'}": k5_times[
            (rows, mode)][i]
           for rows in (64, 512) for mode in ("bf16", "int8")
           for i, key in enumerate(("ms", "plain_ms", "device_ms",
                                    "plain_device_ms"))},
        "beam_step_ms": {str(b): v["k5"] for b, v in beam_ms.items()},
        "beam_step_plain_ms": {str(b): v["plain"]
                               for b, v in beam_ms.items()}})
    log(f"K2 rows below the top-2 gap {K2_GAP} (not compared): {below}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
