"""Single-query (decode-step) cross-attention as a hand-written CUDA kernel.

Replaces the TPU kernel `decode_cross_attention` (`audio_transformers_tpu/
ops/decode_attention.py`, `_kernel`). It runs in every decoder layer at
every decode step, over the cross K/V that `precompute_cross_attention`
built once per clip in the time-minor (B, H, hd, T) layout.

Bound on the H100: device-memory bandwidth. Each call reads all of K and
V once (whisper-tiny, T=1500, bf16: 384 KB per (b, h), 37 MB at B=16)
and does 4 * hd FLOPs per key, far below the compute roofline. The kernel
(`csrc/decode_attention.cu`) runs one block per (b, h); in the time-minor
layout the 32 lanes of a warp read 32 consecutive keys of one channel, so
both contractions are coalesced, and the scores never leave shared memory.
With one block per (b, h) only B*H blocks are in flight (96 at B=16 on
132 SMs): splitting T across blocks is the next step.

int8 mode folds the per-key `k_scale` into the logit row and the
per-channel `v_scale` into the output row; q and the probabilities are
never quantized. int4 waits (it raises).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from audio_transformers_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_SMEM_LIMIT = 48 * 1024
# q, k, v, k_scale, v_scale, out; bh, hd, t_len, t_valid; scale;
# q dtype, kv dtype; stream
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


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
                                     scale=None) -> torch.Tensor:
    """Plain PyTorch version: q (B, H, hd), k and v (B, H, hd, T); int8
    k/v with k_scale (B, H, T) and v_scale (B, H, hd). float32 math,
    output in q's dtype."""
    _build.count_plain("decode_cross_attention", q)
    hd = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kf = k.float()
    vf = v.float()
    if k_scale is not None:
        kf = kf * k_scale[:, :, None, :].float()
        vf = vf * v_scale[:, :, :, None].float()
    s = torch.einsum("bhd,bhdt->bht", q.float(), kf) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bht,bhdt->bhd", p, vf).to(q.dtype)


def _check(q, k, v, k_scale, v_scale, t_valid):
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
        raise ValueError("int8 k/v need k_scale and v_scale, and only they")
    b, h, hd, t = k.shape
    if quant and (k_scale.shape != (b, h, t) or v_scale.shape != (b, h, hd)
                  or k_scale.dtype != torch.float32
                  or v_scale.dtype != torch.float32):
        raise ValueError("k_scale must be (B,H,T) and v_scale (B,H,hd), "
                         "both float32")
    if not 0 < t_valid <= t:
        raise ValueError(f"t_valid {t_valid} outside (0, {t}]")
    if 4 * (hd + 32 + t_valid) > _SMEM_LIMIT:
        raise ValueError(f"T={t_valid} too long for the kernel's shared "
                         "memory")
    for name, x in (("q", q), ("k", k), ("v", v), ("k_scale", k_scale),
                    ("v_scale", v_scale)):
        if x is not None and (not x.is_cuda or x.device != q.device
                              or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous tensor on "
                             f"{q.device}")


def decode_cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None,
                           t_valid: Optional[int] = None) -> torch.Tensor:
    """Single-query attention over precomputed time-minor keys/values.

    q (B, H, hd); k and v (B, H, hd, T). For int8 k/v pass k_scale
    (B, H, T) and v_scale (B, H, hd), both float32. Keys at t >= t_valid
    (default T) are ignored. Returns (B, H, hd) in q's dtype. CUDA tensors
    run the kernel; CPU tensors run `decode_cross_attention_reference`."""
    if k_scale is not None and k_scale.dim() == 4:
        raise NotImplementedError("int4 cross K/V is not ported yet")
    t_len = k.shape[-1]
    t_valid = t_len if t_valid is None else int(t_valid)
    if not q.is_cuda:
        if t_valid != t_len:
            k, v = k[..., :t_valid], v[..., :t_valid]
            k_scale = None if k_scale is None else k_scale[..., :t_valid]
        return decode_cross_attention_reference(
            q, k, v, k_scale=k_scale, v_scale=v_scale, scale=scale)
    _check(q, k, v, k_scale, v_scale, t_valid)
    b, h, hd = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    fn = _build.function("decode_attention", "decode_cross_attention",
                         _ARGTYPES)
    rc = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v),
            _build.ptr(k_scale), _build.ptr(v_scale), _build.ptr(out),
            b * h, hd, t_len, t_valid, scale, _DTYPES[q.dtype],
            _DTYPES[k.dtype], _build.stream_ptr(q))
    _build.check(rc, "decode_cross_attention")
    _build.STATS["decode_cross_attention"].launches += 1
    return out
