#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (audio_transformers_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA device, nvcc, and the repository around this file. Phases,
each raising on failure:

  1. the card: name and power limit (nvidia-smi);
  2. build the three hand-written CUDA kernels from csrc/ (nvcc, sm_90a);
  3. each kernel against its plain PyTorch version on the card at the
     serving path's shapes (B in {4, 16}, T=1500, V=51865 padded to
     52224, 30 s audio), with the tolerances below, and their times
     (CUDA events, median of 20 after warm-up);
  4. correctness on a small input: the port's pipeline at the test config
     in float32 on the card (kernels) equals the same pipeline on the CPU
     (plain versions);
  5. the main path: EmotionWhisperPipeline.analyze of a 12 s clip at the
     full width of whisper-tiny (seeded random weights, bfloat16), with
     every kernel's launch counter reset just before and read just after;
  6. the HTTP server on 127.0.0.1 with the micro-batcher, answering three
     concurrent /analyze requests.

Tolerances (kernel vs plain version, on the card):
  K1 decode_cross_attention: 1e-5 abs in float32 (sum order only);
     2e-2 abs in bfloat16 (one bf16 ulp of the output).
  K2 fused_greedy_step: tokens equal on every row whose plain top-2 gap
     (and, with timestamps, the margin of the probability rule) exceeds
     1e-3; rows below that gap are reported, not compared.
  K3 log_mel: 2e-4 abs on the final features (f32 sums in another order,
     then log10).

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
REPLACES = {
    "decode_cross_attention": "audio_transformers_tpu/ops/decode_attention.py:100",
    "fused_greedy_step": "audio_transformers_tpu/ops/decode_logits.py:82",
    "log_mel": "audio_transformers_tpu/ops/mel_pallas.py:67",
}
SOURCES = {
    "decode_cross_attention": "audio_transformers_tpu_torch/csrc/decode_attention.cu",
    "fused_greedy_step": "audio_transformers_tpu_torch/csrc/decode_logits.cu",
    "log_mel": "audio_transformers_tpu_torch/csrc/mel.cu",
}


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

    from audio_transformers_tpu_torch.core import (EmotionWhisperConfig,
                                                   MelConfig, WhisperConfig)
    from audio_transformers_tpu_torch.core.params import init
    from audio_transformers_tpu_torch.infer.pipeline import \
        EmotionWhisperPipeline
    from audio_transformers_tpu_torch.models.whisper import decode
    from audio_transformers_tpu_torch.ops import _build
    from audio_transformers_tpu_torch.ops import decode_attention as da
    from audio_transformers_tpu_torch.ops import decode_logits as dl
    from audio_transformers_tpu_torch.ops import logit_processors as lp
    from audio_transformers_tpu_torch.ops import mel

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

    # 5. the main path at whisper-tiny width
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
        require(launches > 0, f"{name} was not launched on the main path")
        require(plain == 0, f"{name}'s plain version ran on CUDA")
    t0 = time.perf_counter()
    pipe.analyze(clip, 16000)
    torch.cuda.synchronize()
    log(f"analyze (same clip, second call): {time.perf_counter() - t0:.3f} s")

    # 6. the HTTP server
    check_server(pipe, synth_clip)

    kernels = []
    for name in _build.STATS:
        ms, plain = times[4][name]
        ms16, plain16 = times[16][name]
        kernels.append({"name": name, "route": "cuda",
                        "source": SOURCES[name], "replaces": REPLACES[name],
                        "launches": stats[name][0],
                        "max_abs_err": err[name], "ms": ms,
                        "plain_ms": plain, "ms_b16": ms16,
                        "plain_ms_b16": plain16})
    log(f"K2 rows below the top-2 gap {K2_GAP} (not compared): {below}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
