"""Build and load the hand-written CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on first
use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

(no PyTorch headers, so a build takes seconds), then loaded with `ctypes`.
The output lands in `audio_transformers_tpu_torch/_build/`, keyed by a hash
of the sources and flags, so an edited source is rebuilt and an unchanged
one is loaded as it is. The sources are compiled without
`--use_fast_math`: the decode kernels rely on IEEE division and on
`finfo(float32).min` overflowing to -inf exactly as the reference does.

Every kernel also has a `KernelStats` entry: `launches` counts the
wrapper's kernel launches, `plain_cuda_calls` counts calls of the kernel's
plain PyTorch version on a CUDA tensor (the main path never makes one).
With the recorder on (`core/tracing.py`), a first load or `build_all` is an
`ops.build` span and each nvcc run adds to the counter `ops.nvcc_builds`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Dict

from audio_transformers_tpu_torch.core import tracing

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
KERNEL_SOURCES = ("decode_attention", "decode_logits", "decode_logits_sm90",
                  "mel", "flash_attention", "flash_attention_sm90",
                  "permute")


@dataclass
class KernelStats:
    launches: int = 0
    plain_cuda_calls: int = 0


STATS: Dict[str, KernelStats] = {
    "decode_cross_attention": KernelStats(),
    "fused_greedy_step": KernelStats(),
    "fused_greedy_step_partials": KernelStats(),
    "log_mel": KernelStats(),
    "flash_attention_fwd": KernelStats(),
    "flash_attention_bwd_dq": KernelStats(),
    "flash_attention_bwd_dkv": KernelStats(),
    "permute_rows": KernelStats(),
}


def reset_stats() -> None:
    for s in STATS.values():
        s.launches = 0
        s.plain_cuda_calls = 0


def count_plain(name: str, t) -> None:
    """Called by each kernel's plain version: records a run on the card."""
    if t.is_cuda:
        STATS[name].plain_cuda_calls += 1


_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin)")
    return path


def _sources(name: str):
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start_compile(name: str, out: Path):
    """Starts nvcc for csrc/<name>.cu; `_finish_compile` waits for it."""
    tracing.count("ops.nvcc_builds")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return name, out, tmp, proc


def _finish_compile(job) -> None:
    name, out, tmp, proc = job
    _, err = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{err}")
    os.replace(tmp, out)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, compiled if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            with tracing.span("ops.build"):
                path = library_path(name)
                if not path.exists():
                    _finish_compile(_start_compile(name, path))
                lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def build_all() -> None:
    """Compiles every missing library, one nvcc per source, all started
    together, then loads them all."""
    with _lock, tracing.span("ops.build"):
        jobs = [_start_compile(name, library_path(name))
                for name in KERNEL_SOURCES
                if name not in _libs and not library_path(name).exists()]
        try:
            for job in jobs:
                _finish_compile(job)
        finally:
            for job in jobs:
                if job[3].poll() is None:
                    job[3].kill()
                    job[3].wait()
    for name in KERNEL_SOURCES:
        load(name)


_fns: Dict[tuple, ctypes._CFuncPtr] = {}


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point `symbol` of csrc/<name>.cu, with its argument
    types declared (c_void_p for every pointer and the stream) and an int
    (cudaError_t) result."""
    key = (name, symbol)
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def check(rc: int, what: str) -> None:
    """Raise on the cudaError_t a C entry point returned."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_ptr(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device pointer; None passes a null pointer."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())
