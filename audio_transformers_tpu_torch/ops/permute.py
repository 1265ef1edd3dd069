"""Row gather of several buffers in one launch: the beam-search reorder.

Replaces the TPU kernel `permute_rows_pallas` (`audio_transformers_tpu/
ops/permute.py`, `_copy_kernel`): out[j][i] = bufs[j][perm[i]] for every
buffer j, whatever its rank and dtype. Beam search reorders every per-beam
buffer by the chosen parents once per decode step (HF `_reorder_cache`):
each layer's self K/V (and their scales in int8 mode), the seen mask and
the token rows.

Bound on the H100: device-memory bytes; it is a pure copy, bit exact for
every dtype. The kernel (`csrc/permute.cu`) runs one block per (row,
buffer) pair, which loads its own perm[i] and copies the row with 16-byte
words where source and destination are 16-aligned alike, bytes otherwise.
All buffers of one call share one launch (up to `MAX_ENTRIES`; longer
lists take several), in place of one `index_select` per buffer.

Parents repeat, so the copy is out of place: `out` (allocated when not
given) must not overlap any source, and the wrapper refuses it if it does.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from audio_transformers_tpu_torch.ops import _build

MAX_ENTRIES = 64   # buffers per launch; must match csrc/permute.cu
# srcs, dsts, row_bytes (host arrays); n; perm; rows; stream
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p,
                                      ctypes.c_int, ctypes.c_void_p])


def permute_rows_reference(bufs: Sequence[torch.Tensor], perm: torch.Tensor,
                           out: Optional[Sequence[torch.Tensor]] = None
                           ) -> List[torch.Tensor]:
    """Plain PyTorch version: one `index_select(0, perm)` per buffer."""
    _build.count_plain("permute_rows", perm)
    out = _outputs(bufs, perm, out)
    for a, o in zip(bufs, out):
        torch.index_select(a, 0, perm, out=o)
    return out


def _check_disjoint(bufs, out) -> None:
    """Raises if any output's bytes overlap any source's: one sweep over
    the byte ranges sorted by start (all tensors lie on one device), in
    place of a check of every pair."""
    spans = sorted([(t.data_ptr(), t.data_ptr() + t.nbytes, kind)
                    for kind, ts in enumerate((bufs, out))
                    for t in ts if t.nbytes])
    ends = [-1, -1]          # furthest end so far of sources, of outputs
    for start, end, kind in spans:
        if start < ends[1 - kind]:
            raise ValueError("an output overlaps a source buffer: the row "
                             "gather must be out of place")
        ends[kind] = max(ends[kind], end)


def _outputs(bufs, perm, out) -> List[torch.Tensor]:
    """Checks the operands; allocates the outputs when `out` is None."""
    if not bufs:
        raise ValueError("no buffers to permute")
    rows = bufs[0].shape[0] if bufs[0].dim() else -1
    if perm.dim() != 1 or perm.shape[0] != rows:
        raise ValueError(f"perm {tuple(perm.shape)} for {rows} rows")
    if perm.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"perm dtype {perm.dtype} (want int32 or int64)")
    for a in bufs:
        if a.dim() == 0 or a.shape[0] != rows:
            raise ValueError(f"buffer {tuple(a.shape)}: every buffer needs "
                             f"{rows} leading rows")
        if a.device != perm.device or not a.is_contiguous():
            raise ValueError(f"buffers must be contiguous tensors on "
                             f"{perm.device}")
    if out is None:
        return [torch.empty_like(a) for a in bufs]
    out = list(out)
    if len(out) != len(bufs):
        raise ValueError(f"{len(out)} outputs for {len(bufs)} buffers")
    for a, o in zip(bufs, out):
        if o.shape != a.shape or o.dtype != a.dtype \
                or o.device != a.device or not o.is_contiguous():
            raise ValueError(f"output {tuple(o.shape)} {o.dtype} does not "
                             f"match buffer {tuple(a.shape)} {a.dtype}")
    _check_disjoint(bufs, out)
    return out


def permute_rows(bufs: Sequence[torch.Tensor], perm: torch.Tensor,
                 out: Optional[Sequence[torch.Tensor]] = None
                 ) -> List[torch.Tensor]:
    """out[j][i] = bufs[j][perm[i]] for every buffer (all with the same
    leading row count, any rank and dtype), into `out` when given (the
    caller's second set of buffers) or into new tensors. perm (rows,) int32
    or int64 with values in [0, rows); repeats allowed. CUDA tensors run
    the kernel; CPU tensors run `permute_rows_reference`."""
    if not perm.is_cuda:
        return permute_rows_reference(bufs, perm, out)
    out = _outputs(bufs, perm, out)
    perm = perm.to(torch.int64).contiguous()
    rows = perm.shape[0]
    fn = _build.function("permute", "permute_rows", _ARGTYPES)
    stream = _build.stream_ptr(perm)
    for lo in range(0, len(bufs), MAX_ENTRIES):
        src, dst = bufs[lo:lo + MAX_ENTRIES], out[lo:lo + MAX_ENTRIES]
        n = len(src)
        srcs = (ctypes.c_void_p * n)(*[a.data_ptr() for a in src])
        dsts = (ctypes.c_void_p * n)(*[o.data_ptr() for o in dst])
        nbytes = (ctypes.c_longlong * n)(
            *[a.nbytes // rows if rows else 0 for a in src])
        rc = fn(srcs, dsts, nbytes, n, _build.ptr(perm), rows, stream)
        _build.check(rc, "permute_rows")
        _build.count_launch("permute_rows")
    return out
