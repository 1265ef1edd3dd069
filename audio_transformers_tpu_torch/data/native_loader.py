"""ctypes bindings for the native audio loader (native/audiodec).

The native tier replaces what the reference delegated to torch's C++
DataLoader workers + torchaudio's C++ DSP (reference:
urban_sounds/dataset.py:37-39,98-99): wav decode, polyphase resampling, and
a multi-threaded prefetch pool delivering fixed-length clips in submission
order. Falls back to the pure-numpy path (utils/audio.py) when the shared
library hasn't been built (`make -C native/audiodec`).

The port's copy of the reference package's bindings: the decoders (what
`utils/audio.decode_audio_bytes` reaches), `resample`, and the prefetch
pool with its ordered stream `iter_clips` (what `data/urbansound.py`'s
local source reaches).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "native",
                         "audiodec", "libaudiodec.so")
_lib = None


def _load(build_if_missing: bool = True):
    global _lib
    if _lib is not None:
        return _lib
    path = os.path.abspath(_LIB_PATH)
    if not os.path.exists(path) and build_if_missing:
        src_dir = os.path.dirname(path)
        if os.path.exists(os.path.join(src_dir, "Makefile")):
            try:
                subprocess.run(["make", "-C", src_dir], check=True,
                               capture_output=True)
            except Exception as e:
                raise OSError(f"libaudiodec build failed: {e}")
    lib = ctypes.CDLL(path)

    for fname in ("adc_decode_wav", "adc_decode_flac", "adc_decode_audio"):
        fn = getattr(lib, fname)
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32)]
    lib.adc_resample.restype = ctypes.c_int64
    lib.adc_resample.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.adc_resample_out_len.restype = ctypes.c_int64
    lib.adc_resample_out_len.argtypes = [ctypes.c_int64, ctypes.c_int32,
                                         ctypes.c_int32]
    lib.adc_pad_normalize.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int]
    lib.adc_pool_create.restype = ctypes.c_void_p
    lib.adc_pool_create.argtypes = [ctypes.c_int, ctypes.c_int32,
                                    ctypes.c_int64, ctypes.c_int,
                                    ctypes.c_int]
    lib.adc_pool_submit.restype = ctypes.c_int
    lib.adc_pool_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_int64]
    lib.adc_pool_pop.restype = ctypes.c_int
    lib.adc_pool_pop.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_float),
                                 ctypes.POINTER(ctypes.c_int64)]
    lib.adc_pool_pending.restype = ctypes.c_int
    lib.adc_pool_pending.argtypes = [ctypes.c_void_p]
    lib.adc_pool_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except OSError:
        return False


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


_MAX_SAMPLES_CAP = 48000 * 600  # 10 min @ 48 kHz, the documented cutoff


def _bound_samples(data: bytes) -> int:
    """Decoded-length bound from the container headers, so the scratch
    buffer is proportional to the clip instead of a fixed 110 MB
    (mirrors decoded_len_bound in native/audiodec/audiodec.cpp):
      wav:  mono samples <= byte count (>= 1 byte per sample)
      flac: STREAMINFO total_samples (highly-compressed streams exceed
            their byte size; 0 = unknown -> full cap)"""
    if data[:4] == b"fLaC":
        if len(data) >= 42 and (data[4] & 0x7F) == 0:
            b = data[8:]
            total = ((b[13] & 0x0F) << 32) | int.from_bytes(b[14:18], "big")
            if total > 0:
                return min(total, _MAX_SAMPLES_CAP)
        return _MAX_SAMPLES_CAP
    return min(max(len(data), 1), _MAX_SAMPLES_CAP)


def _decode(fname: str, data: bytes, max_samples: Optional[int]
            ) -> Tuple[np.ndarray, int]:
    lib = _load()
    if max_samples is None:
        max_samples = _bound_samples(data)
    out = np.empty(max_samples, np.float32)
    sr = ctypes.c_int32(0)
    n = getattr(lib, fname)(data, len(data), _fptr(out), max_samples,
                            ctypes.byref(sr))
    if n < 0:
        raise ValueError(f"{fname}: unsupported or corrupt stream")
    return out[:n].copy(), int(sr.value)


def decode_wav(data: bytes, max_samples: Optional[int] = None
               ) -> Tuple[np.ndarray, int]:
    return _decode("adc_decode_wav", data, max_samples)


def decode_flac(data: bytes, max_samples: Optional[int] = None
                ) -> Tuple[np.ndarray, int]:
    """First-party native FLAC decode -> (float32 mono, sample_rate)."""
    return _decode("adc_decode_flac", data, max_samples)


def decode_audio(data: bytes, max_samples: Optional[int] = None
                 ) -> Tuple[np.ndarray, int]:
    """Container-sniffing decode (RIFF wav or fLaC) -> mono float32."""
    return _decode("adc_decode_audio", data, max_samples)


def resample(audio: np.ndarray, in_rate: int, out_rate: int) -> np.ndarray:
    lib = _load()
    audio = np.ascontiguousarray(audio, np.float32)
    cap = lib.adc_resample_out_len(len(audio), in_rate, out_rate)
    out = np.empty(int(cap), np.float32)
    n = lib.adc_resample(_fptr(audio), len(audio), in_rate, out_rate,
                         _fptr(out), cap)
    if n < 0:
        raise ValueError("adc_resample failed")
    return out[:n]


class PrefetchPool:
    """Ordered multi-threaded wav-file prefetch: submit paths, pop
    fixed-length preprocessed clips."""

    def __init__(self, *, num_threads: int = 4, target_rate: int,
                 target_len: int, normalize: bool = True,
                 capacity: int = 64):
        self._lib = _load()
        self.target_len = target_len
        self._pool = self._lib.adc_pool_create(
            num_threads, target_rate, target_len, int(normalize), capacity)
        if not self._pool:
            raise OSError("adc_pool_create failed")

    def _handle(self):
        # after close() the pool pointer is NULL; passing it through
        # ctypes would segfault the interpreter instead of raising
        if not self._pool:
            raise ValueError("pool is closed")
        return self._pool

    def submit(self, path: str, tag: int = 0) -> bool:
        return self._lib.adc_pool_submit(
            self._handle(), path.encode(), tag) == 0

    def pop(self) -> Tuple[np.ndarray, int, bool]:
        out = np.empty(self.target_len, np.float32)
        tag = ctypes.c_int64(0)
        rc = self._lib.adc_pool_pop(self._handle(), _fptr(out),
                                    ctypes.byref(tag))
        if rc == -2:
            raise IndexError("pool empty")
        return out, int(tag.value), rc == 0

    def pending(self) -> int:
        return self._lib.adc_pool_pending(self._handle())

    def close(self):
        if self._pool:
            self._lib.adc_pool_destroy(self._pool)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def iter_clips(paths: Sequence[str], *, target_rate: int, target_len: int,
               num_threads: int = 4, normalize: bool = True
               ) -> Iterator[Tuple[int, np.ndarray, bool]]:
    """Stream (index, clip, ok) over wav files with prefetch overlap."""
    with PrefetchPool(num_threads=num_threads, target_rate=target_rate,
                      target_len=target_len, normalize=normalize) as pool:
        submitted = 0
        popped = 0
        n = len(paths)
        while popped < n:
            while submitted < n and pool.submit(paths[submitted], submitted):
                submitted += 1
            clip, tag, ok = pool.pop()
            popped += 1
            yield tag, clip, ok
