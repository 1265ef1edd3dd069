"""Fused vocab projection + logit processors + argmax for greedy decode,
as a hand-written CUDA kernel (`csrc/decode_logits.cu`).

Replaces the TPU kernel `fused_greedy_step` (`audio_transformers_tpu/ops/
decode_logits.py`, `_kernel`). Every greedy decode step takes its token
from here: the tied projection hidden @ table^T, the additive suppress
vector, the seen-mask repetition penalty, the int8 no-repeat-ngram ban and
(optionally) the whisper timestamp rules, then the argmax. The (B, V)
logits never reach device memory.

Bound on the H100: device-memory bandwidth. One call reads the bf16
table (384 x 52224, 40 MB) once per group of 8 rows, plus the two int8
masks (B x 52224 bytes each); the projection is 2 * B * 384 FLOPs per
vocab id, tiny next to the tensor cores' rate. The kernel runs in two
passes: pass 1 gives each block one 256-id vocab tile and 8 rows, keeps
the rows' hidden vectors in shared memory and the 8 dot products per
thread in registers, applies the processors in registers and reduces the
tile to per-row partials (max, argmax and, for timestamps, the timestamp
max, argmax and sum of exp, and the text max); pass 2 merges the tiles'
partials per row. Ties go to the lowest index, inside a tile and across
tiles, as `torch.argmax` does.

Semantics match `fused_greedy_step_reference` (the plain version here)
and the reference package's kernel and XLA chain: suppression is applied
before the penalty (a suppressed logit saturates at NEG_INF, and a seen
one times the penalty overflows to -inf, as in the reference), positive
seen logits are divided and negative ones multiplied in float32, and the
ban comes last.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from audio_transformers_tpu_torch.ops import _build
from audio_transformers_tpu_torch.ops.logit_processors import (
    NEG_INF, repetition_penalty)

TILE_V = 256   # vocab ids per block; must match csrc/decode_logits.cu
ROWS = 8       # rows per block; must match csrc/decode_logits.cu
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 48 * 1024
# hidden, table_t, add, seen, ban; penalty; tlo, thi, tcap; tb, batch,
# dim, vocab, dtype; partials (float, int), out; stream
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_float] + [ctypes.c_void_p] * 3
             + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4)


def pad_vocab(v: int, block_v: int = 1024) -> int:
    """The padded vocab width the fused step expects its (.., V) operands
    (transposed table, additive vector, seen/ban masks) to carry."""
    return -(-v // block_v) * block_v


def _validate(hidden, table_t, add_vec, seen, ban, penalty, ts_bounds,
              timestamp_begin):
    b, d = hidden.shape
    if table_t.dim() != 2 or table_t.shape[0] != d:
        raise ValueError(f"table_t {tuple(table_t.shape)} vs hidden "
                         f"{tuple(hidden.shape)}: want (D, V_pad)")
    v_pad = table_t.shape[1]
    if add_vec.numel() != v_pad:
        raise ValueError(f"add_vec has {add_vec.numel()} entries, want "
                         f"{v_pad}")
    for name, m in (("seen", seen), ("ban", ban)):
        if m is not None and (m.shape != (b, v_pad) or m.dtype != torch.int8):
            raise ValueError(f"{name} must be int8 (B, V_pad)")
    if seen is not None and penalty == 1.0:
        raise ValueError("seen mask given but penalty is 1.0")
    if penalty != 1.0 and seen is None:
        raise ValueError("penalty != 1.0 requires the seen mask")
    if (ts_bounds is None) != (timestamp_begin is None):
        raise ValueError("ts_bounds and timestamp_begin go together")
    if ts_bounds is not None and not 0 < timestamp_begin < v_pad:
        raise ValueError(f"timestamp_begin {timestamp_begin} outside the "
                         f"padded vocab {v_pad}")


def processed_logits(hidden, table_t, add_vec, *, seen=None, ban=None,
                     penalty=1.0, ts_bounds=None,
                     timestamp_begin=None) -> torch.Tensor:
    """The (B, V_pad) float32 logits after every processor, before the
    token pick: the plain version's first half."""
    l = hidden.float() @ table_t.float()
    l = l + add_vec.reshape(1, -1).float()
    if seen is not None:
        l = repetition_penalty(l, seen, penalty)
    if ban is not None:
        l = l.masked_fill(ban != 0, NEG_INF)
    if ts_bounds is not None:
        tlo, thi, tcap = (x.long()[:, None] for x in ts_bounds)
        g = torch.arange(l.shape[1], device=l.device)[None, :]
        tb = int(timestamp_begin)
        l = l.masked_fill((g < tlo) | ((g >= tb) & (g < thi)) | (g > tcap),
                          NEG_INF)
    return l


def fused_greedy_step_reference(hidden, table_t, add_vec, *, seen=None,
                                ban=None, penalty=1.0, ts_bounds=None,
                                timestamp_begin=None) -> torch.Tensor:
    """Plain PyTorch version on the same padded operands; (B,) int32."""
    _build.count_plain("fused_greedy_step", hidden)
    l = processed_logits(hidden, table_t, add_vec, seen=seen, ban=ban,
                         penalty=penalty, ts_bounds=ts_bounds,
                         timestamp_begin=timestamp_begin)
    if ts_bounds is None:
        return l.argmax(dim=-1).to(torch.int32)
    tb = int(timestamp_begin)
    force = torch.logsumexp(l[:, tb:], dim=-1) > l[:, :tb].amax(dim=-1)
    arg_ts = tb + l[:, tb:].argmax(dim=-1)
    return torch.where(force, arg_ts, l.argmax(dim=-1)).to(torch.int32)


def fused_greedy_step(hidden: torch.Tensor, table_t: torch.Tensor,
                      add_vec: torch.Tensor, *,
                      seen: Optional[torch.Tensor] = None,
                      ban: Optional[torch.Tensor] = None,
                      penalty: float = 1.0,
                      ts_bounds=None,
                      timestamp_begin: Optional[int] = None) -> torch.Tensor:
    """One greedy next-token step. Returns (B,) int32 token ids.

    hidden  (B, D)       float32 or bfloat16
    table_t (D, V_pad)   the transposed tied embedding in hidden's dtype,
                         vocab padded (pad_vocab)
    add_vec (1, V_pad)   float32 additive mask (NEG_INF at suppressed ids
                         and the padded tail)
    seen    (B, V_pad)   int8 0/1 ids in the history (penalty != 1 only)
    ban     (B, V_pad)   int8 0/1 no-repeat-ngram bans for this step
    ts_bounds            three (B,) int32 (lp.timestamp_row_bounds); with
                         timestamp_begin, applies the whisper timestamp
                         rules including the probability rule.
    CUDA tensors run the kernel; CPU tensors run the plain version."""
    _validate(hidden, table_t, add_vec, seen, ban, penalty, ts_bounds,
              timestamp_begin)
    if not hidden.is_cuda:
        return fused_greedy_step_reference(
            hidden, table_t, add_vec, seen=seen, ban=ban, penalty=penalty,
            ts_bounds=ts_bounds, timestamp_begin=timestamp_begin)
    b, d = hidden.shape
    v_pad = table_t.shape[1]
    if hidden.dtype not in _DTYPES or table_t.dtype != hidden.dtype:
        raise TypeError(f"hidden/table dtypes {hidden.dtype}/"
                        f"{table_t.dtype}: want one of float32, bfloat16")
    if v_pad % TILE_V:
        raise ValueError(f"V_pad={v_pad} is not a multiple of {TILE_V}")
    if 4 * ROWS * (d + TILE_V) > _SMEM_LIMIT:
        raise ValueError(f"D={d} too wide for the kernel's shared memory")
    bounds = [None] * 3 if ts_bounds is None else [
        x.to(device=hidden.device, dtype=torch.int32).contiguous()
        for x in ts_bounds]
    add = add_vec.reshape(-1)
    for name, x in (("hidden", hidden), ("table_t", table_t), ("add", add),
                    ("seen", seen), ("ban", ban)):
        if x is not None and (not x.is_cuda or x.device != hidden.device
                              or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous tensor on "
                             f"{hidden.device}")
    if add.dtype != torch.float32:
        raise TypeError("add_vec must be float32")
    n_tiles = v_pad // TILE_V
    planes = 1 if ts_bounds is None else 4
    pf = torch.empty((planes, b, n_tiles), dtype=torch.float32,
                     device=hidden.device)
    pi = torch.empty((2, b, n_tiles), dtype=torch.int32, device=hidden.device)
    out = torch.empty((b,), dtype=torch.int32, device=hidden.device)
    fn = _build.function("decode_logits", "fused_greedy_step", _ARGTYPES)
    rc = fn(_build.ptr(hidden), _build.ptr(table_t), _build.ptr(add),
            _build.ptr(seen), _build.ptr(ban), float(penalty),
            *(_build.ptr(x) for x in bounds),
            int(timestamp_begin or 0), b, d, v_pad, _DTYPES[hidden.dtype],
            _build.ptr(pf), _build.ptr(pi), _build.ptr(out),
            _build.stream_ptr(hidden))
    _build.check(rc, "fused_greedy_step")
    _build.STATS["fused_greedy_step"].launches += 1
    return out
