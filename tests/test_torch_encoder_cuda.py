"""The serving encoder's attention routes on the card: "flash" (K4a,
`ops/attention.flash_attention`) against "xla" (float32 logits, softmax,
bf16 probabilities) at whisper-large-v3's widths (d 1280, 20 heads of 64,
FFN 5120, 128 mel bands, vocabulary 51866) cut to 2 encoder and 2 decoder
layers, on 4 speech-like 30 s windows (5-30 s of voice, zero-padded) in
bfloat16. Every test needs a CUDA device and nvcc and skips without them;
the file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_encoder_cuda.py

Tolerances:
  - encoder states: the relative RMS of flash less xla at most
    ROUTE_TOL = 1e-2 (measured 3.24e-3 on an H100: both routes round q,
    k, v, p and the output to bf16, K4a p against its running row maximum,
    and the 2 layers' residual stream carries the difference); against
    the float32 "xla" encoder on the same weights, flash's relative RMS at
    most 1.5x xla's (measured 5.011e-3 against 5.007e-3).
  - the route `resolve_encoder_attn` picks for bf16 CUDA input, as the
    serving callers pass it, is the flash route bit for bit.
  - one `analyze_windows` call: each row's tokens equal through both
    routes, or differ first at a near-tie: a position where the two
    candidates' processed logits (repetition penalty on the seen ids) lie
    within NEAR_TIE = 0.05 of each other on both routes' own decoder
    states (measured: no row differed, the emotion probabilities by at
    most 1.1e-4).
"""

import dataclasses

import numpy as np
import pytest
import torch

from audio_transformers_tpu_torch.core import params as cp
from audio_transformers_tpu_torch.core import tracing
from audio_transformers_tpu_torch.core.config import (EmotionWhisperConfig,
                                                      MelConfig,
                                                      WhisperConfig)
from audio_transformers_tpu_torch.infer.pipeline import EmotionWhisperPipeline
from audio_transformers_tpu_torch.models.whisper import model as wm
from audio_transformers_tpu_torch.ops.mel import log_mel

pytestmark = pytest.mark.cuda

ROUTE_TOL = 1e-2
F32_RATIO = 1.5
NEAR_TIE = 0.05
PENALTY = 1.15          # analyze_windows' repetition penalty
SR = 16000
SECONDS = (5.0, 12.5, 21.0, 30.0)

CFG = EmotionWhisperConfig(
    whisper=dataclasses.replace(WhisperConfig.large_v3(), encoder_layers=2,
                                decoder_layers=2),
    num_emotion_classes=10)
W = CFG.whisper


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def speech_like(seconds: float, seed: int) -> np.ndarray:
    """A 30 s window holding `seconds` of voice-like audio: a gliding
    fundamental with 12 decaying harmonics under syllable envelopes of
    about 4 Hz, and a little noise; zeros after."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    f0 = 110.0 + 60.0 * rng.random() + 20.0 * np.sin(
        2 * np.pi * 0.3 * t + rng.random() * 6.3)
    phase = 2 * np.pi * np.cumsum(f0) / SR
    voice = sum(np.sin(k * phase) / k for k in range(1, 13))
    syllables = np.clip(np.sin(2 * np.pi * (3.5 + rng.random()) * t
                               + rng.random() * 6.3), 0.0, None) ** 2
    out = np.zeros(30 * SR, np.float32)
    out[:n] = 0.1 * voice * syllables + 0.005 * rng.standard_normal(n)
    return out


@pytest.fixture(scope="module")
def model(cuda):
    params = cp.init(CFG, torch.Generator().manual_seed(0))
    windows = np.stack([speech_like(s, i) for i, s in enumerate(SECONDS)])
    mel_cfg = MelConfig.whisper(n_mels=W.n_mels)
    with torch.inference_mode():
        mel = log_mel(torch.from_numpy(windows).to(cuda), mel_cfg)
    return params, windows, mel


def _rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def test_flash_encoder_holds_xla(cuda, model):
    params, _, mel = model
    # float32 weights, each cast to the input's dtype at its use, as the
    # pipeline serves them
    p = cp.to_device(params, cuda)["whisper"]
    half = mel.to(torch.bfloat16)
    with torch.inference_mode():
        ref = wm.encode(p, W, mel, attn_impl="xla")
        xla = wm.encode(p, W, half, attn_impl="xla")
        tracing.enable()
        try:
            flash = wm.encode(p, W, half, attn_impl="flash")
            resolved = wm.encode(p, W, half, attn_impl=(
                wm.resolve_encoder_attn(half.device, half.dtype)))
        finally:
            rec = tracing.drain()
            tracing.disable()
    route, err_xla, err_flash = (_rel_rms(flash, xla), _rel_rms(xla, ref),
                                 _rel_rms(flash, ref))
    print(f"flash vs xla {route:.3e}; against float32: xla {err_xla:.3e}, "
          f"flash {err_flash:.3e}")
    assert flash.dtype == torch.bfloat16
    assert route <= ROUTE_TOL
    assert err_flash <= F32_RATIO * err_xla
    assert torch.equal(resolved, flash)
    assert rec.counter("encode.attn.flash") == 2
    assert rec.counter("encode.attn.xla") == 0


def _processed(params, hidden, seen_ids):
    """The raw logits of one decoder state with the repetition penalty on
    the ids seen before it, float32."""
    table = params["whisper"]["decoder"]["embed"]["table"]
    logits = hidden.float() @ table.to(hidden.dtype).float().t()
    seen = torch.tensor(sorted(seen_ids), device=logits.device)
    picked = logits[seen]
    logits[seen] = torch.where(picked > 0, picked / PENALTY,
                               picked * PENALTY)
    return logits


def _decode(pipe, windows, route, monkeypatch):
    """One analyze_windows call through `route`: its texts, probabilities
    and the decode's tokens, lengths and hidden states."""
    outs = []
    decode = pipe._decode

    def keep(group, dcfg):
        out = decode(group, dcfg)
        outs.append(out)
        return out
    monkeypatch.setattr(pipe, "_decode", keep)
    monkeypatch.setattr(wm, "resolve_encoder_attn", lambda device, dtype:
                        route)
    texts, probs = pipe.analyze_windows(windows, max_new_tokens=48,
                                        max_batch=4)
    monkeypatch.undo()
    (out,) = outs
    return probs, out


def test_analyze_windows_tokens_agree_but_at_near_ties(cuda, model,
                                                       monkeypatch):
    params, windows, _ = model
    pipe = EmotionWhisperPipeline(params, CFG, device="cuda",
                                  compute_dtype=torch.bfloat16)
    dev_params = pipe.params
    xla_probs, xla = _decode(pipe, windows, "xla", monkeypatch)
    flash_probs, flash = _decode(pipe, windows, "flash", monkeypatch)
    p_len = xla["prompt_len"]
    ties = []
    for row in range(len(SECONDS)):
        a = xla["tokens"][row].tolist()
        b = flash["tokens"][row].tolist()
        la, lb = int(xla["lengths"][row]), int(flash["lengths"][row])
        if a[:la] == b[:lb]:
            continue
        j = next(i for i in range(p_len, max(la, lb)) if a[i] != b[i])
        seen = set(a[:j])
        px = _processed(dev_params, xla["hiddens"][row, j - 1], seen)
        pf = _processed(dev_params, flash["hiddens"][row, j - 1], seen)
        gap_x = float(px[a[j]] - px[b[j]])
        gap_f = float(pf[b[j]] - pf[a[j]])
        rms = float(px.pow(2).mean().sqrt())
        ties.append((row, j, a[j], b[j], gap_x, gap_f, rms))
    print(f"rows differing: {ties}; probabilities max diff "
          f"{float(np.abs(xla_probs - flash_probs).max()):.3e}")
    for row, j, ta, tb, gap_x, gap_f, _ in ties:
        assert abs(gap_x) <= NEAR_TIE and abs(gap_f) <= NEAR_TIE, (
            f"row {row} position {j}: xla picks {ta}, flash {tb}, gaps "
            f"{gap_x:.4f} / {gap_f:.4f} are no near-tie")
