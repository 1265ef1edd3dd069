"""The encoder's self-attention route when the port serves, on the CPU at
WhisperConfig.test()'s widths.

`model.resolve_encoder_attn` picks "flash" (K4a) only for bfloat16 on
CUDA; on the CPU its choice is the "xla" route bit for bit, so the CPU
runs the arithmetic the JAX parity tests hold. `encode`'s "auto" stays
"xla". Each `encode` call counts its route with the recorder on; the
three serving callers (the pipeline, the evaluation's batch decode, the
omni connector) pass the resolved route, while the training pass keeps
"auto" as "xla". On the CPU the flash route runs K4a's plain versions,
which hold the "xla" route within float32 sum order (1e-5 of the largest
state).
"""

import numpy as np
import pytest
import torch

from audio_transformers_tpu_torch.core import params as cp
from audio_transformers_tpu_torch.core import tracing
from audio_transformers_tpu_torch.core.config import (DecodeConfig,
                                                      EmotionWhisperConfig,
                                                      MelConfig, OmniConfig,
                                                      WhisperConfig)
from audio_transformers_tpu_torch.infer import evaluate as ev
from audio_transformers_tpu_torch.infer.omni import OmniPipeline, seeded
from audio_transformers_tpu_torch.infer.pipeline import EmotionWhisperPipeline
from audio_transformers_tpu_torch.models.whisper import emotion as emo
from audio_transformers_tpu_torch.models.whisper import model as wm

TINY = EmotionWhisperConfig(whisper=WhisperConfig.test(),
                            num_emotion_classes=4)
W = TINY.whisper
FLASH_TOL = 1e-5


@pytest.fixture(autouse=True)
def _recorder_off():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


@pytest.fixture(scope="module")
def params():
    return cp.init(TINY, torch.Generator().manual_seed(0))


def _mel(dtype, batch=2, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((batch, 2 * W.max_source_positions, W.n_mels),
                       generator=g).to(dtype)


def _routes(records):
    return (records.counter("encode.attn.flash"),
            records.counter("encode.attn.xla"))


@pytest.mark.parametrize("device,dtype,want", [
    ("cuda", torch.bfloat16, "flash"),
    (torch.device("cuda", 1), torch.bfloat16, "flash"),
    ("cuda", torch.float32, "xla"),
    ("cuda", torch.float16, "xla"),
    ("cpu", torch.bfloat16, "xla"),
    ("cpu", torch.float32, "xla")])
def test_resolve_encoder_attn(device, dtype, want):
    assert wm.resolve_encoder_attn(device, dtype) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_routes_are_xla_bit_for_bit(params, dtype):
    tree = cp.map_tensors(params, lambda t: t.to(dtype))
    mel = _mel(dtype)
    with torch.inference_mode():
        resolved = wm.encode(tree["whisper"], W, mel, attn_impl=(
            wm.resolve_encoder_attn(mel.device, mel.dtype)))
        auto = wm.encode(tree["whisper"], W, mel, attn_impl="auto")
        xla = wm.encode(tree["whisper"], W, mel, attn_impl="xla")
        default = wm.encode(tree["whisper"], W, mel)
    assert resolved.dtype == dtype
    assert torch.equal(resolved, xla) and torch.equal(auto, xla)
    assert torch.equal(default, xla)


def test_flash_route_on_the_cpu_holds_xla(params):
    mel = _mel(torch.float32)
    with torch.inference_mode():
        flash = wm.encode(params["whisper"], W, mel, attn_impl="flash")
        xla = wm.encode(params["whisper"], W, mel, attn_impl="xla")
    assert float((flash - xla).abs().max()) \
        <= FLASH_TOL * float(xla.abs().max())


@pytest.mark.parametrize("impl,want", [("xla", (0, 2)), ("flash", (2, 0)),
                                       ("auto", (0, 2))])
def test_each_call_counts_its_route(params, impl, want):
    tracing.enable()
    with torch.inference_mode():
        for _ in range(2):
            wm.encode(params["whisper"], W, _mel(torch.float32, batch=1),
                      attn_impl=impl)
    assert _routes(tracing.drain()) == want


def test_recorder_off_counts_nothing(params):
    with torch.inference_mode():
        wm.encode(params["whisper"], W, _mel(torch.float32, batch=1),
                  attn_impl="flash")
    tracing.enable()
    assert _routes(tracing.drain()) == (0, 0)


def _flash_everywhere(monkeypatch):
    """Resolves the serving route to "flash" for any input, so that a
    caller that passes the resolved route shows on the flash counter (K4a's
    plain versions run on the CPU)."""
    monkeypatch.setattr(wm, "resolve_encoder_attn", lambda device, dtype:
                        "flash")


def _pipeline_windows(params):
    pipe = EmotionWhisperPipeline(params, TINY, device="cpu",
                                  compute_dtype=torch.float32)
    windows = (0.3 * np.random.default_rng(3).standard_normal(
        (3, pipe._window))).astype(np.float32)
    return pipe.analyze_windows(windows, max_new_tokens=4, max_batch=2)


def _evaluate_batch(params):
    mel_cfg = MelConfig.whisper(n_mels=W.n_mels)
    samples = 2 * W.max_source_positions * mel_cfg.hop_length
    wav = (0.3 * np.random.default_rng(4).standard_normal(
        (2, samples))).astype(np.float32)
    return ev._decode_batch(params, TINY, mel_cfg,
                            DecodeConfig(max_new_tokens=4), wav,
                            (W.decoder_start_token_id,), torch.float32,
                            torch.device("cpu"))


def _omni_audio(_):
    cfg = OmniConfig.test()
    pipe = OmniPipeline(seeded(cfg, 3), cfg, device="cpu", encoder_bucket=2)
    rng = np.random.default_rng(7)
    audio = [0.1 * rng.standard_normal(int(pipe.window * f)).astype(
        np.float32) for f in (0.6, 1.4)]
    return pipe.audio_embeddings(audio)


@pytest.mark.parametrize("caller,calls", [(_pipeline_windows, 2),
                                          (_evaluate_batch, 1),
                                          (_omni_audio, 2)])
def test_serving_callers_take_the_resolved_route(params, monkeypatch,
                                                 caller, calls):
    tracing.enable()
    caller(params)
    assert _routes(tracing.drain()) == (0, calls)
    _flash_everywhere(monkeypatch)
    tracing.enable()
    caller(params)
    assert _routes(tracing.drain()) == (calls, 0)


def test_serving_flash_route_gives_the_xla_tokens(params, monkeypatch):
    """The pipeline's texts and probabilities through the flash route's
    plain versions against the "xla" route, in float32 on the CPU."""
    texts, probs = _pipeline_windows(params)
    _flash_everywhere(monkeypatch)
    flash_texts, flash_probs = _pipeline_windows(params)
    assert flash_texts == texts
    np.testing.assert_allclose(flash_probs, probs, atol=FLASH_TOL, rtol=0)


def test_training_pass_keeps_auto_as_xla(params, monkeypatch):
    _flash_everywhere(monkeypatch)
    ids = torch.zeros((1, 4), dtype=torch.long)
    tracing.enable()
    emo.forward_train(params, TINY, _mel(torch.float32, batch=1), ids)
    assert _routes(tracing.drain()) == (0, 1)


def test_encode_auto_ignores_the_serving_rule(params, monkeypatch):
    """"auto" means "xla" in `encode` whatever `resolve_encoder_attn`
    would pick: the rule acts only where a serving caller asks it."""
    _flash_everywhere(monkeypatch)
    mel = _mel(torch.float32, batch=1)
    tracing.enable()
    with torch.inference_mode():
        auto = wm.encode(params["whisper"], W, mel, attn_impl="auto")
        xla = wm.encode(params["whisper"], W, mel, attn_impl="xla")
    assert _routes(tracing.drain()) == (0, 2)
    assert torch.equal(auto, xla)
