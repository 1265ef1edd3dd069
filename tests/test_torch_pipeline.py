"""The whole serving slice of the PyTorch port against the JAX pipeline on
the CPU, at WhisperConfig.test() with the same (bridged) weights, in
float32: texts equal (ByteTokenizer), emotion probabilities <= 1e-5. And
the port's HTTP entry point answering over real HTTP."""

import io
import json
import threading
import urllib.request
import wave
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_transformers_tpu.core.config import (EmotionWhisperConfig,
                                                WhisperConfig)
from audio_transformers_tpu.data.tokenizer import ByteTokenizer
from audio_transformers_tpu.infer import pipeline as jpipe
from audio_transformers_tpu.models.whisper import emotion as jemo
from audio_transformers_tpu.serve.batching import MicroBatcher
from audio_transformers_tpu.utils.audio import synth_clip
from audio_transformers_tpu_torch.core import params as cp
from audio_transformers_tpu_torch.infer.pipeline import EmotionWhisperPipeline
from audio_transformers_tpu_torch.serve import http_server

TINY = EmotionWhisperConfig(whisper=WhisperConfig.test(),
                            num_emotion_classes=4)
LABELS = {0: "happy", 1: "sad", 2: "calm", 3: "angry"}
PROB_TOL = 1e-5


@pytest.fixture(scope="module")
def pipes():
    jp = jemo.init(jax.random.PRNGKey(0), TINY)
    tok = ByteTokenizer()
    jax_pipe = jpipe.EmotionWhisperPipeline(
        jp, TINY, idx_to_label=LABELS, tokenizer=tok,
        compute_dtype=jnp.float32)
    port = EmotionWhisperPipeline(
        cp.from_jax_params(jax.tree.map(np.asarray, jp)), TINY,
        idx_to_label=LABELS, tokenizer=tok, device="cpu",
        compute_dtype=torch.float32)
    return jax_pipe, port


def _clip(seed, duration):
    return synth_clip(duration, 16000, freq=220.0 + 110 * seed, seed=seed)


@pytest.mark.parametrize("duration,seg", [(1.6, 1.0), (3.1, 0.75)])
def test_analyze_matches_jax(pipes, duration, seg):
    jax_pipe, port = pipes
    wav = _clip(int(duration), duration)
    want = jax_pipe.analyze(wav, 16000, segment_duration=seg,
                            max_new_tokens=16)
    got = port.analyze(wav, 16000, segment_duration=seg, max_new_tokens=16)
    assert got["transcription"] == want["transcription"]
    assert len(got["segments"]) == len(want["segments"])
    for g, w in zip(got["segments"], want["segments"]):
        assert set(g) == set(w)
        assert (g["start"], g["end"], g["text"], g["emotion"]) \
            == (w["start"], w["end"], w["text"], w["emotion"])
        assert g["emotion_probs"].keys() == w["emotion_probs"].keys()
        for k in w["emotion_probs"]:
            assert abs(g["emotion_probs"][k] - w["emotion_probs"][k]) \
                <= PROB_TOL


def test_analyze_windows_bucketing_matches_jax(pipes):
    # 5 windows at max_batch 2: buckets of 2, 2 and a zero-padded 1
    jax_pipe, port = pipes
    rng = np.random.default_rng(3)
    windows = (0.3 * rng.standard_normal((5, port._window))) \
        .astype(np.float32)
    jt, jprobs = jax_pipe.analyze_windows(windows, max_new_tokens=12,
                                          max_batch=2)
    texts, probs = port.analyze_windows(windows, max_new_tokens=12,
                                        max_batch=2)
    assert texts == jt
    assert probs.dtype == np.float32 and probs.shape == (5, 4)
    np.testing.assert_allclose(probs, jprobs, atol=PROB_TOL, rtol=0)


def test_resampled_input_matches_jax(pipes):
    jax_pipe, port = pipes
    wav = synth_clip(1.0, 8000, seed=4)
    assert port.transcribe(wav, 8000, max_new_tokens=10) \
        == jax_pipe.transcribe(wav, 8000, max_new_tokens=10)


def test_runner_and_max_batch_conflict(pipes):
    _, port = pipes
    with pytest.raises(ValueError):
        port.analyze(_clip(0, 1.0), 16000, max_batch=2,
                     runner=port.analyze_windows)


def _wav_bytes(audio: np.ndarray, sr: int) -> bytes:
    buf = io.BytesIO()
    pcm = (np.clip(audio, -1, 1) * 32767.0).astype("<i2")
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    # the port's entry point, loading a saved (bridged) parameter tree
    path = tmp_path_factory.mktemp("params") / "tiny.pt"
    torch.save(cp.init(TINY, torch.Generator().manual_seed(1)), path)
    pipe = http_server.build_pipeline(config="test", params_path=str(path))
    assert pipe.compute_dtype == torch.float32
    assert pipe.cfg.num_emotion_classes == 4
    batcher = MicroBatcher(pipe.analyze_windows, max_wait_ms=50.0)
    httpd = ThreadingHTTPServer(
        ("127.0.0.1", 0),
        http_server.make_handler(pipe, segment_duration=1.0, batcher=batcher))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", pipe, batcher
    httpd.shutdown()
    batcher.close()


def test_server_health(server):
    url, _, _ = server
    with urllib.request.urlopen(f"{url}/health", timeout=30) as r:
        assert json.loads(r.read()) == {"status": "ok"}


def test_server_analyze_concurrent(server):
    url, pipe, batcher = server
    clips = [_clip(i, 1.6) for i in range(3)]
    results = [None] * 3

    def post(i):
        req = urllib.request.Request(f"{url}/analyze",
                                     data=_wav_bytes(clips[i], 16000),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            results[i] = (r.status, json.loads(r.read()))

    threads = [threading.Thread(target=post, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, (status, out) in enumerate(results):
        assert status == 200
        assert isinstance(out["transcription"], str)
        assert len(out["segments"]) == 2
        seg = out["segments"][0]
        assert set(seg) >= {"start", "end", "text", "emotion",
                            "emotion_probs"}
        assert abs(sum(seg["emotion_probs"].values()) - 1.0) < 1e-4
        # the micro-batched answer equals a direct call on the same audio
        pcm = np.frombuffer(_wav_bytes(clips[i], 16000)[44:], "<i2")
        direct = pipe.analyze(pcm.astype(np.float32) / 32768.0, 16000,
                              segment_duration=1.0)
        for a, b in zip(out["segments"], direct["segments"]):
            for k in a["emotion_probs"]:
                assert abs(a["emotion_probs"][k] - b["emotion_probs"][k]) \
                    < 1e-5
    assert batcher.stats["requests"] >= 6
