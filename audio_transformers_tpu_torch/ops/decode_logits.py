"""Fused vocab projection + logit processors + argmax for greedy decode,
as hand-written CUDA kernels.

Replaces the TPU kernel `fused_greedy_step` (`audio_transformers_tpu/ops/
decode_logits.py`, `_kernel`). Every greedy decode step takes its token
from here: the tied projection hidden @ table^T, the additive suppress
vector, the seen-mask repetition penalty, the int8 no-repeat-ngram ban and
(optionally) the whisper timestamp rules, then the argmax. The (B, V)
logits never reach device memory.

`SOURCE` maps the operands' dtype to the kernel's source:

- bfloat16, the serving path's dtype: `csrc/decode_logits_sm90.cu`, one
  launch on Hopper's tensor cores. Bound on the H100: device-memory
  bandwidth (the 384 x 52224 table of whisper-tiny is 40 MB; the
  projection is 2 * B * D FLOPs per vocab id). `greedy_plan` splits the
  vocab into 16-id units over one block per SM and the batch into row
  groups of 8-128; in each block a producer warp streams the block's
  share of the table through a ring in shared memory (one bulk copy per
  table row), and 8 warps compute the projection with mma.sync (vocab as
  the M side, a group's rows as N),
  applies the processors and reduces each row to partials, and the last
  block of a row group merges them in the same launch. The partials and
  the merge counters are scratch kept per (device, stream).
- float32, the parity route: `csrc/decode_logits.cu`, an FMA kernel in
  two passes (one block per 256-id tile and 8 rows, then a merge per
  row). Its partials are made for each call: another thread's launches
  on the same stream may fall between the two passes.

The vocab-shard mode (`vocab_offset`, `partials=True`; tensor
parallelism, where each rank holds the table's columns [v0, v0 + V_pad/t))
runs the same launch over a shard and stops before the pick: per row it
returns the partials the kernel keeps (`PARTS`), its ids global, and the
ranks merge every shard's with `merge_partials`, the pick GSPMD's
vocab-sharded argmax made in the reference.

Ties go to the lowest index, inside a block and across blocks, as
`torch.argmax` does. Semantics match `fused_greedy_step_reference` (the
plain version here) and the reference package's kernel and XLA chain:
suppression is applied before the penalty (a suppressed logit saturates
at NEG_INF, and a seen one times the penalty overflows to -inf, as in the
reference), positive seen logits are divided and negative ones multiplied
in float32, and the ban comes last.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from types import MappingProxyType
from typing import Dict, Optional, Tuple

import torch

from audio_transformers_tpu_torch.ops import _build
from audio_transformers_tpu_torch.ops.logit_processors import (
    NEG_INF, repetition_penalty)

# dtype -> the kernel source (csrc/<name>.cu) that runs it
SOURCE = MappingProxyType({torch.bfloat16: "decode_logits_sm90",
                           torch.float32: "decode_logits"})
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# float32 route (csrc/decode_logits.cu)
TILE_V = 256   # vocab ids per block
ROWS = 8       # rows per block
_SMEM_LIMIT = 48 * 1024
# hidden, table_t, add, seen, ban; penalty; tlo, thi, tcap; tb, batch,
# dim, vocab, dtype; partials (float, int), out; vocab offset, row
# partials out; stream
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_float] + [ctypes.c_void_p] * 3
             + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3 + [ctypes.c_int]
             + [ctypes.c_void_p] * 2)

# bfloat16 route (csrc/decode_logits_sm90.cu); the sizes must match it
UNIT_V = 16                      # vocab ids per unit of the split
STAGE_ROWS = 32                  # table rows per stage of the ring
STAGES = 4                       # stages of the ring
# rows of a group -> units per warp of a tile (the kernel's Shape<rows / 8>)
GROUP_UPW = MappingProxyType({8: 4, 16: 4, 32: 4, 64: 2, 128: 1})
GROUP_ROWS = tuple(GROUP_UPW)
SMEM_MAX = 232448 - 1024
H100_SMS = 132
# hidden, table_t, add, seen, ban; penalty; tlo, thi, tcap; tb, batch,
# dim, vocab, rows, blocks; partials (float, int), counters, out; vocab
# offset, row partials out; stream
_SM90_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_float]
                  + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                  + [ctypes.c_void_p] * 4 + [ctypes.c_int]
                  + [ctypes.c_void_p] * 2)
# the row partials of the vocab-shard mode, float32 columns: the max and
# its global id; in timestamp mode then the timestamp max and its id, the
# timestamp sum of exp relative to that max, and the text max. An empty
# region (no timestamp or no text id in the shard) is (-inf, NO_ID).
PARTS = ("max", "argmax", "ts_max", "ts_argmax", "ts_sum", "text_max")
NO_ID = float(2 ** 31)   # (float) INT_MAX in the kernels
# the scratch of each (device, stream): the merge counters (int32, zero
# between launches) and the partials (float32, int32)
_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, ...]] = {}


@dataclass(frozen=True)
class GreedyPlan:
    """How the bf16 kernel splits one call: `blocks` blocks over the vocab
    (each a contiguous run of 16-id units, `block_ids`), `groups` row
    groups of `rows` rows (the table is read once per group), and the
    dynamic shared memory each block uses."""
    blocks: int
    rows: int
    groups: int
    smem: int


def sm90_smem_bytes(rows: int, dim: int) -> int:
    """Shared memory of a block of the bf16 kernel: the ring of table
    stages (32 rows of a tile of 8 warps x `upw` units, plus 16 bytes a
    row), the group's hidden rows (D padded to 32, plus 16 bytes a row)
    and the float32 logits tile (the tile's ids plus 4 a row)."""
    tile = 8 * GROUP_UPW[rows] * UNIT_V
    dp = -(-dim // STAGE_ROWS) * STAGE_ROWS
    return (STAGES * STAGE_ROWS * (2 * tile + 16) + rows * (2 * dp + 16)
            + rows * (tile + 4) * 4)


@functools.lru_cache(maxsize=None)
def greedy_plan(batch: int, dim: int, v_pad: int,
                n_sm: int = H100_SMS) -> GreedyPlan:
    """The bf16 kernel's split of a (batch, dim) x (dim, v_pad) call on a
    card of `n_sm` SMs: one block per SM (at most one per unit), and the
    smallest row group that holds the batch and whose block fits in shared
    memory, else the largest that fits."""
    if dim < 8 or dim % 8 or v_pad < UNIT_V or v_pad % UNIT_V:
        raise ValueError(f"D={dim} must be a multiple of 8 and V_pad="
                         f"{v_pad} of {UNIT_V}")
    fits = [r for r in GROUP_ROWS if sm90_smem_bytes(r, dim) <= SMEM_MAX]
    if not fits:
        raise ValueError(f"D={dim} too wide for the kernel's shared memory")
    rows = next((r for r in fits if r >= batch), fits[-1])
    return GreedyPlan(blocks=min(n_sm, v_pad // UNIT_V), rows=rows,
                      groups=-(-batch // rows),
                      smem=sm90_smem_bytes(rows, dim))


def block_ids(plan: GreedyPlan, v_pad: int, block: int) -> range:
    """The vocab ids that block `block` of the plan reduces (the kernel
    computes the same bounds)."""
    units = v_pad // UNIT_V
    return range(block * units // plan.blocks * UNIT_V,
                 (block + 1) * units // plan.blocks * UNIT_V)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of CUDA device `index` (the bf16 kernel's grid)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _scratch(device: torch.device, stream: int, n_count: int,
             n_part: int) -> Tuple[torch.Tensor, ...]:
    """(counters, float partials, int partials) of (device, stream), with
    at least n_count counters and n_part partials each: made once (the
    counters zeroed) and grown when a call needs more. Launches on one
    stream run one after another, so they share them; the kernel leaves
    the counters zero."""
    key = (device.index, stream)
    count, pf, pi = _SCRATCH.get(key, (None, None, None))
    if count is None or count.numel() < n_count:
        count = torch.zeros(max(n_count, 64), dtype=torch.int32,
                            device=device)
    if pf is None or pf.numel() < n_part:
        n = max(n_part, 1 << 16)
        pf = torch.empty(n, dtype=torch.float32, device=device)
        pi = torch.empty(n, dtype=torch.int32, device=device)
    _SCRATCH[key] = (count, pf, pi)
    return count, pf, pi


def pad_vocab(v: int, block_v: int = 1024) -> int:
    """The padded vocab width the fused step expects its (.., V) operands
    (transposed table, additive vector, seen/ban masks) to carry."""
    return -(-v // block_v) * block_v


def _validate(hidden, table_t, add_vec, seen, ban, penalty, ts_bounds,
              timestamp_begin, vocab_offset=0, partials=False):
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
    if vocab_offset < 0 or vocab_offset % UNIT_V:
        raise ValueError(f"vocab_offset {vocab_offset} is not a non-negative "
                         f"multiple of {UNIT_V}")
    # a shard may lie wholly below or above timestamp_begin (a global id);
    # unsharded it must split the vocab
    if ts_bounds is not None and not (
            timestamp_begin > 0 if partials
            else 0 < timestamp_begin < v_pad):
        raise ValueError(f"timestamp_begin {timestamp_begin} outside the "
                         f"padded vocab {v_pad}")


def processed_logits(hidden, table_t, add_vec, *, seen=None, ban=None,
                     penalty=1.0, ts_bounds=None, timestamp_begin=None,
                     vocab_offset=0) -> torch.Tensor:
    """The (B, V_pad) float32 logits after every processor, before the
    token pick: the plain version's first half. Column j is vocab id
    vocab_offset + j."""
    l = hidden.float() @ table_t.float()
    l = l + add_vec.reshape(1, -1).float()
    if seen is not None:
        l = repetition_penalty(l, seen, penalty)
    if ban is not None:
        l = l.masked_fill(ban != 0, NEG_INF)
    if ts_bounds is not None:
        tlo, thi, tcap = (x.long()[:, None] for x in ts_bounds)
        g = vocab_offset + torch.arange(l.shape[1], device=l.device)[None, :]
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


def fused_greedy_step_partials_reference(
        hidden, table_t, add_vec, *, seen=None, ban=None, penalty=1.0,
        ts_bounds=None, timestamp_begin=None,
        vocab_offset=0) -> torch.Tensor:
    """Plain version of the vocab-shard mode: the (B, 2) or, with
    timestamps, (B, 6) float32 row partials (`PARTS`) of the shard whose
    first column is id `vocab_offset`; the masks are the shard's columns,
    the bounds and timestamp_begin global ids."""
    _build.count_plain("fused_greedy_step_partials", hidden)
    l = processed_logits(hidden, table_t, add_vec, seen=seen, ban=ban,
                         penalty=penalty, ts_bounds=ts_bounds,
                         timestamp_begin=timestamp_begin,
                         vocab_offset=vocab_offset)
    b, w = l.shape

    def arg(x, start):   # (max, lowest id of the max) of columns x
        if x.shape[1] == 0:
            return (torch.full((b,), float("-inf"), device=l.device),
                    torch.full((b,), NO_ID, device=l.device))
        m, i = x.max(dim=-1)
        return m, (vocab_offset + start + i).float()

    m, mi = arg(l, 0)
    if ts_bounds is None:
        return torch.stack([m, mi], dim=1)
    c = min(max(int(timestamp_begin) - vocab_offset, 0), w)
    mts, its = arg(l[:, c:], c)
    sts = (torch.exp(l[:, c:] - mts[:, None]).sum(dim=-1) if c < w
           else torch.zeros(b, device=l.device))
    mtx = (l[:, :c].amax(dim=-1) if c > 0
           else torch.full((b,), float("-inf"), device=l.device))
    return torch.stack([m, mi, mts, its, sts, mtx], dim=1)


def merge_partials(parts: torch.Tensor) -> torch.Tensor:
    """(t, B, K) row partials of t vocab shards (`PARTS`, any order) ->
    (B,) int32 tokens: the largest max and the lowest id among equal ones;
    with timestamps (K = 6) the timestamp sums merged as log-sum-exp, and
    the timestamp pick where that exceeds the text max, as the unsharded
    kernel decides."""
    m, idx = parts[..., 0], parts[..., 1]
    top = m.amax(dim=0)
    tok = torch.where(m == top, idx, float("inf")).amin(dim=0)
    if parts.shape[-1] == 6:
        mts, its, sts, mtx = (parts[..., k] for k in (2, 3, 4, 5))
        top_ts = mts.amax(dim=0)
        its_top = torch.where(mts == top_ts, its, float("inf")).amin(dim=0)
        none = top_ts == float("-inf")
        scaled = torch.where(mts == float("-inf"), 0.0,
                             sts * torch.exp(mts - top_ts.masked_fill(
                                 none, 0.0)))
        lse = torch.where(none, float("-inf"),
                          top_ts + torch.log(scaled.sum(dim=0)))
        tok = torch.where(lse > mtx.amax(dim=0), its_top, tok)
    return tok.to(torch.int32)


def fused_greedy_step(hidden: torch.Tensor, table_t: torch.Tensor,
                      add_vec: torch.Tensor, *,
                      seen: Optional[torch.Tensor] = None,
                      ban: Optional[torch.Tensor] = None,
                      penalty: float = 1.0,
                      ts_bounds=None,
                      timestamp_begin: Optional[int] = None,
                      vocab_offset: int = 0,
                      partials: bool = False) -> torch.Tensor:
    """One greedy next-token step. Returns (B,) int32 token ids, or with
    `partials` the (B, 2) / (B, 6) float32 row partials (`PARTS`) of a
    vocab shard whose first column is id `vocab_offset` (`merge_partials`
    joins the shards').

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
    In the vocab-shard mode table_t, add_vec, seen and ban are the shard's
    columns; ts_bounds and timestamp_begin stay global ids.
    CUDA tensors run the kernel; CPU tensors run the plain version."""
    _validate(hidden, table_t, add_vec, seen, ban, penalty, ts_bounds,
              timestamp_begin, vocab_offset, partials)
    if vocab_offset and not partials:
        raise ValueError("a vocab shard (vocab_offset) returns partials")
    if not hidden.is_cuda:
        kw = dict(seen=seen, ban=ban, penalty=penalty, ts_bounds=ts_bounds,
                  timestamp_begin=timestamp_begin)
        if partials:
            return fused_greedy_step_partials_reference(
                hidden, table_t, add_vec, vocab_offset=vocab_offset, **kw)
        return fused_greedy_step_reference(hidden, table_t, add_vec, **kw)
    b, d = hidden.shape
    v_pad = table_t.shape[1]
    if hidden.dtype not in SOURCE or table_t.dtype != hidden.dtype:
        raise TypeError(f"hidden/table dtypes {hidden.dtype}/"
                        f"{table_t.dtype}: want one of float32, bfloat16")
    source = SOURCE[hidden.dtype]
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
        if (x is not None and source == "decode_logits_sm90"
                and x.data_ptr() % 16):
            raise ValueError(f"{name} must be 16-byte aligned")
    if add.dtype != torch.float32:
        raise TypeError("add_vec must be float32")
    stream = _build.stream_ptr(hidden)
    if partials:
        out = torch.empty((b, 2 if ts_bounds is None else 6),
                          dtype=torch.float32, device=hidden.device)
        tail = (None, int(vocab_offset), _build.ptr(out))
    else:
        out = torch.empty((b,), dtype=torch.int32, device=hidden.device)
        tail = (_build.ptr(out), 0, None)
    common = (_build.ptr(hidden), _build.ptr(table_t), _build.ptr(add),
              _build.ptr(seen), _build.ptr(ban), float(penalty),
              *(_build.ptr(x) for x in bounds), int(timestamp_begin or 0),
              b, d, v_pad)
    if source == "decode_logits_sm90":
        plan = greedy_plan(b, d, v_pad, sm_count(hidden.device.index))
        count, pf, pi = _scratch(hidden.device, stream.value, plan.groups,
                                 4 * b * plan.blocks)
        fn = _build.function(source, "fused_greedy_step_sm90",
                             _SM90_ARGTYPES)
        rc = fn(*common, plan.rows, plan.blocks, _build.ptr(pf),
                _build.ptr(pi), _build.ptr(count), *tail, stream)
    else:
        if v_pad % TILE_V:
            raise ValueError(f"V_pad={v_pad} is not a multiple of {TILE_V}")
        if 4 * ROWS * (d + TILE_V) > _SMEM_LIMIT:
            raise ValueError(f"D={d} too wide for the kernel's shared "
                             f"memory")
        n = 4 * b * (v_pad // TILE_V)
        pf = torch.empty(n, dtype=torch.float32, device=hidden.device)
        pi = torch.empty(n, dtype=torch.int32, device=hidden.device)
        fn = _build.function(source, "fused_greedy_step", _ARGTYPES)
        rc = fn(*common, _DTYPES[hidden.dtype], _build.ptr(pf),
                _build.ptr(pi), *tail, stream)
    name = "fused_greedy_step_partials" if partials else "fused_greedy_step"
    _build.check(rc, name)
    _build.count_launch(name)
    return out
