"""Single-query (decode-step) cross-attention as a hand-written CUDA kernel.

Replaces the TPU kernel `decode_cross_attention` (`audio_transformers_tpu/
ops/decode_attention.py`, `_kernel`). It runs in every decoder layer at
every decode step, over the cross K/V that `precompute_cross_attention`
built once per clip in the time-minor (B, H, hd, T) layout.

Bound on the H100: device-memory bandwidth. Each call reads all of K and
V once (whisper-tiny, T=1500, bf16: 384 KB per (b, h), 37 MB at B=16)
and does 4 * hd FLOPs per key, far below the compute roofline. The kernel
(`csrc/decode_attention.cu`) is flash-decoding: `split_plan` cuts the
keys of each (b, h) into chunks, so that even B=1 (6 heads) fills the
card; one block per (chunk, b, h) streams its chunk of every channel
through shared memory with 16-byte copies, two sub-tiles in flight, keeps
an online softmax and leaves a partial (m, l, acc) in float32 scratch,
and the last block of a (b, h) to finish merges the partials in split
order, in the same launch. It finds out through a counter per (b, h) that
the wrapper allocates once per device and stream, with the partials'
scratch, and the merging block resets. No score row is held for all of T, so T is not bounded by shared
memory. Launches captured in a CUDA graph take scratch of the graph's own
(`graph_scratch`).

int8 mode folds the per-key `k_scale` into the logit row and the
per-channel `v_scale` into the output row; q and the probabilities are
never quantized. int4 mode (chosen by a 4-D `k_scale`, as in the
reference) reads K and V nibble-packed along time, (B, H, hd, T/2) int8,
with the K scales split even/odd as (B, H, 2, T/2): half of int8's bytes.
The kernel walks its packed columns (bytes) as it walks int8's and takes
each sub-tile's even keys, then its odd ones, with the same folding.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from audio_transformers_tpu_torch.ops import _build

# kv-dtype codes of csrc/common.cuh; "int4" is int8 storage, two keys a byte
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, "int4": 3}
# q, k, v, k_scale, v_scale, out, part, count; bh, hd, t_len, t_valid,
# chunk, splits; scale; q dtype, kv dtype; stream
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
_MAX_HEAD_DIM = 128        # the block's ring of K and V sub-tiles
_MAX_GRID_Y = 65535
# a sub-tile is 16 lanes x 16 bytes of keys per channel row
_SUB_TILE_BYTES = 16 * 16
# the H100's 132 SMs, two blocks each
_TARGET_BLOCKS = 2 * 132
# floats per channel of the kernel's ring (2 stages x K and V x 17 16-byte
# segments), in which the merge stages every split's hd + 2 floats at once
_RING_FLOATS_PER_CHANNEL = 2 * 2 * 17 * 4
# the scratch of each (device, stream): the split counters (int32, zero
# between launches) and the partials (float32)
_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


@functools.lru_cache(maxsize=None)
def split_plan(bh: int, t: int, itemsize: int, hd: int) -> Tuple[int, int]:
    """(chunk, splits) of K1 for bh (b, h) rows of hd channels over t
    columns of `itemsize` bytes (keys; in int4 mode packed bytes, two keys
    each, so that a chunk starts on an even key): columns [i * chunk,
    (i + 1) * chunk) of every channel go to split i < splits, the last one
    ragged. A chunk is a whole number of the kernel's sub-tiles (256 bytes
    of a channel row: 128 bf16 keys, 256 int8, 512 int4); each row
    gets about two blocks per SM of the H100 between its splits, or one
    sub-tile per split where T is too short for that, and at most the
    splits whose partials the merge stages at once (263 at hd = 64)."""
    tile = _SUB_TILE_BYTES // itemsize
    tiles = -(-t // tile)
    cap = _RING_FLOATS_PER_CHANNEL * hd // (hd + 2)
    per = max(1, tiles // -(-_TARGET_BLOCKS // bh), -(-tiles // cap))
    chunk = per * tile
    return chunk, -(-t // chunk)


def _scratch(device: torch.device, stream: int, bh: int,
             n_part: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(counters, partials) of (device, stream), with at least bh and
    n_part entries: made once (the counters zeroed) and grown when a call
    needs more. Launches on one stream run one after another, so they
    share them; the kernel leaves the counters zero."""
    key = (device.index, stream)
    count, part = _SCRATCH.get(key, (None, None))
    if count is None or count.numel() < bh:
        count = torch.zeros(max(bh, 1024), dtype=torch.int32, device=device)
    if part is None or part.numel() < n_part:
        part = torch.empty(max(n_part, 1 << 16), dtype=torch.float32,
                           device=device)
    _SCRATCH[key] = (count, part)
    return count, part


@contextlib.contextmanager
def graph_scratch(device: torch.device, stream):
    """While a CUDA graph captures on `stream`: K1's launches there take
    scratch that belongs to the graph (allocated in its memory pool at
    the first launch, the counters zeroed at each replay), not the
    stream's. The graph replays on another stream, while eager launches
    may go on using the stream's scratch."""
    key = (device.index, stream.cuda_stream)
    kept = _SCRATCH.pop(key, None)
    try:
        yield
    finally:
        _SCRATCH.pop(key, None)
        if kept is not None:
            _SCRATCH[key] = kept


def pack_int4(x: torch.Tensor) -> torch.Tensor:
    """Pack 4-bit values in [-8, 7] along the minor (time) axis: byte t
    holds position 2t in the low nibble and 2t+1 in the high nibble. The
    minor axis must be even. Returns int8 of half the minor length."""
    lo = x[..., 0::2].to(torch.int32) & 0xF
    hi = x[..., 1::2].to(torch.int32) & 0xF
    return ((hi << 4) | lo).to(torch.uint8).view(torch.int8)


def unpack_int4(x: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_int4: int8 bytes -> int32 values, minor axis
    doubled, sign-extended from 4 bits."""
    b = x.to(torch.int32) & 0xFF
    lo = ((b & 0xF) ^ 8) - 8
    hi = ((b >> 4) ^ 8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(*x.shape[:-1],
                                                 2 * x.shape[-1])


def decode_cross_attention_reference(q, k, v, *, k_scale=None, v_scale=None,
                                     scale=None,
                                     t_valid: Optional[int] = None
                                     ) -> torch.Tensor:
    """Plain PyTorch version: q (B, H, hd), k and v (B, H, hd, T); int8
    k/v with k_scale (B, H, T) and v_scale (B, H, hd); int4 k/v packed as
    (B, H, hd, T/2) with k_scale (B, H, 2, T/2), unpacked and their scales
    interleaved first, as the reference's oracle does. Keys at t >=
    t_valid (default all) are left out. float32 math, output in q's
    dtype."""
    _build.count_plain("decode_cross_attention", q)
    hd = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if k_scale is not None and k_scale.dim() == 4:
        k, v = unpack_int4(k), unpack_int4(v)
        # (B, H, 2, T/2) even/odd scales -> interleaved (B, H, T)
        k_scale = k_scale.transpose(2, 3).reshape(*k_scale.shape[:2], -1)
    if t_valid is not None:
        k, v = k[..., :t_valid], v[..., :t_valid]
        k_scale = None if k_scale is None else k_scale[..., :t_valid]
    kf = k.float()
    vf = v.float()
    if k_scale is not None:
        kf = kf * k_scale[:, :, None, :].float()
        vf = vf * v_scale[:, :, :, None].float()
    s = torch.einsum("bhd,bhdt->bht", q.float(), kf) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bht,bhdt->bhd", p, vf).to(q.dtype)


def _check(q, k, v, k_scale, v_scale, t_valid, int4):
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[:3] != q.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: want (B,H,hd), (B,H,hd,T) x2")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q dtype {q.dtype} (want float32 or bfloat16)")
    if k.dtype != v.dtype or k.dtype not in _DTYPES:
        raise TypeError(f"k/v dtypes {k.dtype}/{v.dtype}")
    quant = k_scale is not None
    if quant != (k.dtype == torch.int8) or quant != (v_scale is not None):
        raise ValueError("int8 and int4 k/v need k_scale and v_scale, and "
                         "only they")
    b, h, hd, t = k.shape
    # int4: t packed bytes hold 2t keys; the K scales split even/odd
    ks_shape = (b, h, 2, t) if int4 else (b, h, t)
    if quant and (k_scale.shape != ks_shape or v_scale.shape != (b, h, hd)
                  or k_scale.dtype != torch.float32
                  or v_scale.dtype != torch.float32):
        raise ValueError(f"k_scale must be {ks_shape} and v_scale "
                         f"(B,H,hd), both float32")
    t_len = 2 * t if int4 else t
    if not 0 < t_valid <= t_len:
        raise ValueError(f"t_valid {t_valid} outside (0, {t_len}]")
    if not 0 < hd <= _MAX_HEAD_DIM or b * h > _MAX_GRID_Y \
            or hd * t * k.element_size() >= 2 ** 31:
        raise ValueError(f"head dim {hd}, B*H {b * h} or T {t} out of range")
    for name, x in (("q", q), ("k", k), ("v", v), ("k_scale", k_scale),
                    ("v_scale", v_scale)):
        if x is not None and (not x.is_cuda or x.device != q.device
                              or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous tensor on "
                             f"{q.device}")
    if (k.data_ptr() - v.data_ptr()) % 16:
        raise ValueError("k and v must lie equally far from a 16-byte "
                         "boundary")


def decode_cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None,
                           t_valid: Optional[int] = None) -> torch.Tensor:
    """Single-query attention over precomputed time-minor keys/values.

    q (B, H, hd); k and v (B, H, hd, T). For int8 k/v pass k_scale
    (B, H, T) and v_scale (B, H, hd), both float32; for int4 k/v packed
    (B, H, hd, T/2) int8 (`pack_int4`) pass k_scale (B, H, 2, T/2), the
    even keys' scales then the odd ones', and v_scale (B, H, hd): the
    rank of k_scale selects int4, as in the reference. Keys at t >=
    t_valid (default T) are ignored. Returns (B, H, hd) in q's dtype.
    CUDA tensors run the kernel; CPU tensors run
    `decode_cross_attention_reference`."""
    int4 = k_scale is not None and k_scale.dim() == 4
    t_len = k.shape[-1]
    t_keys = 2 * t_len if int4 else t_len
    t_valid = t_keys if t_valid is None else int(t_valid)
    if not q.is_cuda:
        return decode_cross_attention_reference(
            q, k, v, k_scale=k_scale, v_scale=v_scale, scale=scale,
            t_valid=None if t_valid == t_keys else t_valid)
    _check(q, k, v, k_scale, v_scale, t_valid, int4)
    b, h, hd = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    # int4 splits its packed columns: the bytes that hold a valid key
    cols = (t_valid + 1) // 2 if int4 else t_valid
    chunk, splits = split_plan(b * h, cols, k.element_size(), hd)
    out = torch.empty_like(q)
    stream = _build.stream_ptr(q)
    count, part = _scratch(q.device, stream.value, b * h,
                           b * h * splits * (hd + 2))
    fn = _build.function("decode_attention", "decode_cross_attention",
                         _ARGTYPES)
    rc = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v),
            _build.ptr(k_scale), _build.ptr(v_scale), _build.ptr(out),
            _build.ptr(part), _build.ptr(count), b * h, hd, t_len, t_valid,
            chunk, splits, scale, _DTYPES[q.dtype],
            _DTYPES["int4" if int4 else k.dtype], stream)
    _build.check(rc, "decode_cross_attention")
    _build.count_launch("decode_cross_attention")
    return out
