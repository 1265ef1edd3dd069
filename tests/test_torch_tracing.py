"""The port's recorder (`core/tracing.py`) on the CPU, at
WhisperConfig.test()'s widths in float32.

Off, `span` is one shared no-op and nothing is recorded. On, a greedy
`generate` records `decode.generate` > `decode.prepare`, `cross_kv` and
one `decode.step` a loop iteration > `decode.blocks`, `decode.logits`,
`decode.sync`; `decode.steps` counts the decoder steps; tokens and hidden
states are bit-equal on and off; a remat train step records one
`block.recompute` a block inside `train.backward`; `analyze_windows`
counts its padded rows; `export_chrome` writes what was recorded.
"""

import json
import sys
import threading
import tracemalloc

import numpy as np
import pytest
import torch

from audio_transformers_tpu_torch.core import params as cp
from audio_transformers_tpu_torch.core import tracing
from audio_transformers_tpu_torch.core.config import (DecodeConfig,
                                                      EmotionWhisperConfig,
                                                      MelConfig,
                                                      OptimizerConfig,
                                                      TrainConfig,
                                                      WhisperConfig)
from audio_transformers_tpu_torch.infer.pipeline import EmotionWhisperPipeline
from audio_transformers_tpu_torch.models.whisper import decode as dec
from audio_transformers_tpu_torch.models.whisper import model as wm
from audio_transformers_tpu_torch.train import optim
from audio_transformers_tpu_torch.train import whisper_emotion as tw

TINY = EmotionWhisperConfig(whisper=WhisperConfig.test(),
                            num_emotion_classes=4)
W = TINY.whisper
CHAIN = dict(max_new_tokens=8, repetition_penalty=1.15,
             no_repeat_ngram_size=3)


@pytest.fixture(autouse=True)
def _recorder_off():
    """Every test starts and ends with the recorder off and empty."""
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


@pytest.fixture(scope="module")
def params():
    return cp.init(TINY, torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def enc(params):
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, 2 * W.max_source_positions, W.n_mels)).astype(np.float32))
    with torch.no_grad():
        return wm.encode(params["whisper"], W, mel)


def _recorded(fn):
    tracing.enable()
    try:
        out = fn()
    finally:
        tracing.disable()
    return out, tracing.drain()


def _peak_bytes(make_span) -> int:
    """The traced memory's peak above its start over 1000 spans and
    counts."""
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        start, _ = tracemalloc.get_traced_memory()
        for _ in range(1000):
            with make_span("decode.step"):
                tracing.count("decode.steps")
        return tracemalloc.get_traced_memory()[1] - start
    finally:
        tracemalloc.stop()


def test_off_records_nothing_and_returns_the_shared_noop():
    assert not tracing.enabled()
    noop = tracing.span("a")
    assert tracing.span("b", device="cpu") is noop
    # the loop's own allocations, with one context built beforehand
    assert _peak_bytes(tracing.span) <= _peak_bytes(lambda name: noop)
    rec = tracing.drain()
    assert rec.spans == [] and rec.counts == {}


@pytest.mark.parametrize("route", ["fused", "xla", "sampled"])
def test_generate_is_bit_equal_on_and_off(params, enc, route):
    dcfg = DecodeConfig(logits_impl="xla" if route == "xla" else "fused",
                        temperature=0.7 if route == "sampled" else 0.0,
                        **CHAIN)

    def run():
        gen = torch.Generator().manual_seed(3)
        return dec.generate(params["whisper"], W, dcfg, enc, generator=gen)
    off = run()
    on, rec = _recorded(run)
    assert rec.of("decode.step")
    for k in ("tokens", "hiddens", "lengths"):
        assert torch.equal(off[k], on[k]), k


def test_generate_spans_nest_and_count_the_steps(params, enc, monkeypatch):
    fed = []
    step = wm.apply_decoder_step

    def counted(*a, **kw):
        fed.append(1)
        return step(*a, **kw)
    monkeypatch.setattr(wm, "apply_decoder_step", counted)
    _, rec = _recorded(lambda: dec.generate(params["whisper"], W,
                                            DecodeConfig(**CHAIN), enc))
    (gen,) = rec.of("decode.generate")
    assert gen.parent is None and gen.call == gen.id
    by_id = {s.id: s for s in rec.spans}
    assert {s.name for s in rec.children(gen)} == {
        "cross_kv", "decode.prepare", "decode.step", "decode.blocks"}
    steps = rec.of("decode.step")
    assert len(steps) == len(fed) - 1 > 0
    for s in steps:
        kids = sorted(rec.children(s), key=lambda k: k.t0)
        assert [k.name for k in kids] == ["decode.blocks", "decode.logits",
                                          "decode.sync"]
        assert all(s.t0 <= k.t0 <= k.t1 <= s.t1 for k in kids)
    assert all(s.call == gen.id for s in rec.spans)
    assert len(rec.of("decode.blocks")) == len(fed)
    assert rec.counter("decode.steps") == len(fed)
    assert rec.counter("decode.steps", {gen.id}) == len(fed)
    assert by_id[rec.of("decode.prepare")[0].parent] is gen
    assert rec.of("decode.prepare")[0].device_ms is None   # no CUDA here


def test_remat_backward_records_one_recompute_a_block():
    rng = np.random.default_rng(1)
    labels = rng.integers(5, W.vocab_size, (2, 9))
    labels[:, 0] = W.decoder_start_token_id
    batch = {"waveform": torch.from_numpy(rng.standard_normal(
                 (2, 2 * W.max_source_positions * 160)).astype(np.float32)
                 * 0.1),
             "labels": torch.from_numpy(labels).long(),
             "emotion_labels": torch.tensor([1, 3])}
    tcfg = TrainConfig(batch_size=2, compute_dtype="float32", remat=True,
                       attn_impl="xla",
                       optimizer=OptimizerConfig(name="adamw",
                                                 learning_rate=1e-3))
    p = cp.set_trainable(cp.init(TINY, torch.Generator().manual_seed(0)))
    opt = optim.build_optimizer(tcfg.optimizer, p)
    step, _ = tw.make_steps(TINY, MelConfig.whisper(), tcfg, opt, "cpu")
    _, rec = _recorded(lambda: [step(p, batch) for _ in range(2)])
    by_id = {s.id: s for s in rec.spans}
    tops = rec.of("train.step")
    assert len(tops) == 2 and all(t.parent is None for t in tops)
    for top in tops:
        assert sorted(k.name for k in rec.children(top)) == [
            "train.backward", "train.forward", "train.loss",
            "train.optimizer"]
        (back,) = rec.children(top, "train.backward")
        recomputes = [s for s in rec.of("block.recompute")
                      if s.call == top.id]
        assert len(recomputes) == W.encoder_layers + W.decoder_layers
        for s in recomputes:
            assert by_id[s.parent] is back
            assert back.t0 <= s.t0 <= s.t1 <= back.t1
    (fwd,) = rec.children(tops[0], "train.forward")
    assert {k.name for k in rec.children(fwd)} >= {"log_mel", "encode"}
    assert not rec.of("train.grad_average")


def test_analyze_windows_counts_its_padded_rows(params):
    pipe = EmotionWhisperPipeline(params, TINY, device="cpu",
                                  compute_dtype=torch.float32)
    windows = np.random.default_rng(2).standard_normal(
        (3, pipe._window)).astype(np.float32) * 0.1
    _, rec = _recorded(lambda: pipe.analyze_windows(windows,
                                                    max_new_tokens=4))
    (top,) = rec.of("pipeline.analyze_windows")
    assert rec.counter("pipeline.rows", {top.id}) == 3
    assert rec.counter("pipeline.padded_rows", {top.id}) == 1   # bucket 4
    names = {s.name for s in rec.spans if s.call == top.id}
    assert {"log_mel", "encode", "cross_kv", "decode.generate",
            "emotion_head"} <= names


def test_a_span_on_another_thread_joins_the_open_call():
    """As autograd's thread does in a backward on the card."""
    got = []
    tracing.enable()
    with tracing.span("train.step") as top:
        with tracing.span("train.backward") as back:
            t = threading.Thread(target=lambda: got.append(
                tracing.span("block.recompute").__enter__()))
            t.start()
            t.join(timeout=10)
    tracing.disable()
    assert not t.is_alive() and len(got) == 1
    assert got[0].call == top.id and got[0].parent == back.id


def test_threads_lose_no_span_and_no_count():
    """Many threads recording into one open call, the interpreter
    switching threads as often as it can."""
    n_threads, n = 16, 300
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    tracing.enable()
    try:
        with tracing.span("train.step") as top:
            def work():
                for _ in range(n):
                    with tracing.span("block.recompute"):
                        tracing.count("ops.nvcc_builds")
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
        tracing.disable()
    assert not any(t.is_alive() for t in threads)
    rec = tracing.drain()
    spans = rec.of("block.recompute")
    assert len(spans) == n_threads * n
    assert len({s.id for s in spans}) == len(spans)
    assert all(s.call == top.id for s in spans)
    assert rec.counter("ops.nvcc_builds", {top.id}) == n_threads * n


def test_export_chrome_writes_the_spans(params, enc, tmp_path):
    _, rec = _recorded(lambda: dec.generate(params["whisper"], W,
                                            DecodeConfig(**CHAIN), enc))
    path = tmp_path / "trace.json"
    tracing.export_chrome(str(path), rec)
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    assert sorted(e["name"] for e in events) == sorted(
        s.name for s in rec.spans)
    by_id = {e["args"]["id"]: e for e in events}
    for e in events:
        parent = e["args"]["parent"]
        if parent is not None:
            p = by_id[parent]
            assert p["ts"] <= e["ts"]
            assert e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 1e-3
    assert doc["counters"]["decode.steps"] == rec.counter("decode.steps")
    assert set(doc["launches"]) >= {"fused_greedy_step", "log_mel"}
