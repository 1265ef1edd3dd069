"""Host-side audio utilities: mono mixdown, resampling, padding, wav IO.

These mirror the per-sample preprocessing the reference does inside its
torch Dataset (reference: urban_sounds/dataset.py:25-52 — mono mean,
resample, pad/trim to fixed duration, peak normalize) but operate on numpy
and are vectorizable; the mel transform itself runs on the TPU
(ops/mel.py), not here.
"""

from __future__ import annotations

import math
import wave
from fractions import Fraction

import numpy as np


def to_mono(audio: np.ndarray) -> np.ndarray:
    """(channels, n) or (n, channels) or (n,) -> (n,). Channel-mean, like
    the reference (urban_sounds/dataset.py:31-34)."""
    a = np.asarray(audio, dtype=np.float32)
    if a.ndim == 1:
        return a
    if a.ndim == 2:
        # channels-first if first dim is small
        return a.mean(axis=0) if a.shape[0] <= 8 else a.mean(axis=1)
    raise ValueError(f"unsupported audio shape {a.shape}")


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase windowed-sinc resampler (capability equivalent of
    torchaudio.transforms.Resample; reference: urban_sounds/dataset.py:37-39).
    Uses scipy's polyphase implementation with a Kaiser window."""
    if orig_sr == target_sr:
        return np.asarray(audio, dtype=np.float32)
    from scipy.signal import resample_poly
    frac = Fraction(target_sr, orig_sr)
    out = resample_poly(np.asarray(audio, dtype=np.float64),
                        frac.numerator, frac.denominator)
    return out.astype(np.float32)


def pad_or_trim(audio: np.ndarray, target_len: int) -> np.ndarray:
    a = np.asarray(audio, dtype=np.float32)
    if len(a) < target_len:
        return np.pad(a, (0, target_len - len(a)))
    return a[:target_len]


def peak_normalize(audio: np.ndarray) -> np.ndarray:
    peak = np.max(np.abs(audio))
    return audio / peak if peak > 0 else audio


def preprocess_clip(audio: np.ndarray, orig_sr: int, *, target_sr: int,
                    duration: float, normalize: bool = True) -> np.ndarray:
    """Full reference-equivalent clip preprocessing chain."""
    a = to_mono(audio)
    a = resample(a, orig_sr, target_sr)
    a = pad_or_trim(a, int(target_sr * duration))
    if normalize:
        a = peak_normalize(a)
    return a


# ---------------------------------------------------------------------------
# wav IO (stdlib only; soundfile/librosa are not in this environment)
# ---------------------------------------------------------------------------


def _pcm_to_float(raw: bytes, width: int) -> np.ndarray:
    """Interleaved little-endian PCM bytes -> float32 in [-1, 1). The ONE
    place wav sample-width conversion lives (read_wav and
    decode_audio_bytes both delegate here)."""
    if width == 2:
        return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    if width == 4:
        return np.frombuffer(raw, dtype="<i4").astype(np.float32) \
            / 2147483648.0
    if width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        x = (b[:, 0].astype(np.int32)
             | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 2].astype(np.int32) << 16))
        x = (x ^ 0x800000) - 0x800000  # sign-extend 24-bit
        return x.astype(np.float32) / 8388608.0
    if width == 1:
        return (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                - 128.0) / 128.0
    raise ValueError(f"unsupported wav sample width {width}")


def _decode_wav_bytes(data: bytes) -> tuple[np.ndarray, int]:
    """RIFF/WAVE bytes -> (float32 audio, sr). Non-PCM encodings the
    stdlib refuses (e.g. IEEE float, fmt=3) fall back to the native
    decoder when built; every failure surfaces as ValueError so serving
    can map it to a clean 4xx instead of a wave-module traceback."""
    import io
    try:
        with wave.open(io.BytesIO(data), "rb") as w:
            sr = w.getframerate()
            ch = w.getnchannels()
            width = w.getsampwidth()
            raw = w.readframes(w.getnframes())
    except wave.Error as e:
        from audio_transformers_tpu_torch.data import native_loader as nl
        if nl.available():
            return nl.decode_audio(data)
        raise ValueError(f"unsupported wav encoding: {e}") from e
    a = _pcm_to_float(raw, width)
    if ch > 1:
        a = a.reshape(-1, ch).T
    return a, sr


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a PCM wav file -> (float32 mono-or-multichannel array, sr)."""
    with open(path, "rb") as f:
        return _decode_wav_bytes(f.read())


def sniff_container(data: bytes) -> str:
    """Best-effort container name from magic bytes (for error messages)."""
    if data[:4] == b"RIFF":
        return "wav" if data[8:12] == b"WAVE" else "riff"
    if data[:4] == b"fLaC":
        return "flac"
    if data[:3] == b"ID3" or data[:2] in (b"\xff\xfb", b"\xff\xf3",
                                          b"\xff\xf2", b"\xff\xfa"):
        return "mp3"
    if data[:4] == b"OggS":
        return "ogg"
    if data[4:8] == b"ftyp":
        return "m4a"
    return "unknown"


def _thirdparty_decode(data: bytes):
    """Optional soundfile/librosa fallback for containers the first-party
    tier does not cover (mp3/ogg/m4a — the reference decodes these via
    librosa, whisper_finetune/streamlit_app.py:64-68). Returns
    (audio, sr) or None when neither library is importable or neither can
    decode the bytes. Never raises."""
    import io
    try:
        import soundfile as sf
    except ImportError:
        sf = None
    if sf is not None:
        try:
            a, sr = sf.read(io.BytesIO(data), dtype="float32",
                            always_2d=False)
            return (a.T if a.ndim == 2 else a), int(sr)
        except Exception:
            pass
    try:
        import librosa
    except ImportError:
        return None
    try:
        a, sr = librosa.load(io.BytesIO(data), sr=None, mono=False)
        return np.asarray(a, dtype=np.float32), int(sr)
    except Exception:
        return None


def thirdparty_formats_available() -> bool:
    """True when an optional decode library (soundfile or librosa) is
    importable, i.e. mp3/ogg/m4a uploads can be served. Drives honest
    format advertisement in both servers. find_spec, not import: a mere
    availability probe must not pay librosa's numba/scipy import chain
    at server startup."""
    import importlib.util
    import sys

    for mod in ("soundfile", "librosa"):
        if mod in sys.modules:  # injected fakes have no spec on disk
            return True
        try:
            if importlib.util.find_spec(mod) is not None:
                return True
        except (ImportError, ValueError):
            continue
    return False


def decode_audio_bytes(data: bytes) -> tuple[np.ndarray, int]:
    """Decode an in-memory audio container -> (float32 audio, sr).

    First-party tier: wav (stdlib PCM widths 1/2/3/4; IEEE-float via the
    native decoder) and FLAC (native/audiodec/flac.cpp — the reference
    gets flac through librosa/libsndfile,
    whisper_finetune/streamlit_app.py:64-68). Other containers
    (mp3/ogg/m4a) decode through soundfile/librosa when installed —
    the reference's own path — and otherwise raise ValueError with the
    sniffed container name, so serving surfaces report a clear 415
    instead of a wave-module crash."""
    if data[:4] == b"RIFF" and data[8:12] == b"WAVE":
        return _decode_wav_bytes(data)
    if data[:4] == b"fLaC":
        from audio_transformers_tpu_torch.data import native_loader as nl
        return nl.decode_flac(data)
    got = _thirdparty_decode(data)
    if got is not None:
        return got
    raise ValueError(
        f"unsupported audio container ({sniff_container(data)}): wav and "
        f"flac decode natively; install soundfile or librosa for "
        f"mp3/ogg/m4a")


def read_audio(path: str) -> tuple[np.ndarray, int]:
    """Read a wav or flac file -> (float32 audio, sr). See
    decode_audio_bytes for format support."""
    with open(path, "rb") as f:
        return decode_audio_bytes(f.read())


def write_wav(path: str, audio: np.ndarray, sr: int):
    a = np.clip(np.asarray(audio, dtype=np.float32), -1.0, 1.0)
    pcm = (a * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1 if pcm.ndim == 1 else pcm.shape[0])
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.T.tobytes() if pcm.ndim > 1 else pcm.tobytes())


def synth_clip(duration: float, sr: int, *, freq: float = 440.0,
               noise: float = 0.05, seed: int = 0) -> np.ndarray:
    """Deterministic sine+noise clip, the same self-test fixture idea the
    reference uses (reference: whisper_finetune/inference.py:243-258)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(duration * sr)) / sr
    wav = (0.5 * np.sin(2 * math.pi * freq * t)
           + noise * rng.standard_normal(len(t)))
    return wav.astype(np.float32)
