"""K6: the grouped SwiGLU expert GEMM of a mixture of experts.

    y[r] = (silu(x[r] Wg[e]^T) * (x[r] Wu[e]^T)) Wd[e]^T

for every row r of expert e's run [offsets[e], offsets[e + 1]) of rows
sorted by expert; rows at or past offsets[E] (slots of the null expert,
or not kept) are zero. It replaces no TPU kernel: the JAX package has no
mixture of experts. It was added for Uni-MoE-2.0-Omni's routed experts
(`models/unimoe/model.py`), which hold 91% of a layer's bytes.

The offsets stay on the device: the kernel's blocks read them, so a
routed layer never waits for the host. CUDA tensors (bfloat16, D and F
multiples of 128) run `csrc/expert_gemm_sm90.cu`, two launches (gate/up
with the SwiGLU, then down; the (M, F) intermediate goes through device
memory in bf16); CPU tensors run `expert_swiglu_reference`, which
computes every expert on every row and keeps each row's own, in the
kernel's arithmetic (float32 sums, the intermediate rounded to the
activation dtype). Bound and design: the source's header.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from audio_transformers_tpu_torch.ops import _build

Tensor = torch.Tensor
SOURCE = "expert_gemm_sm90"
# x, wg, wu, off, h; m, d, f, experts; stream
_UP_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# h, wd, off, y; m, d, f, experts, bn; stream
_DOWN_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# rows of a call up to which the down projection's output tiles are 64
# columns wide (more blocks for the few rows of a decode step)
NARROW_ROWS = 1024


def expert_swiglu_reference(x: Tensor, offsets: Tensor, w_gate: Tensor,
                            w_up: Tensor, w_down: Tensor) -> Tensor:
    """Plain version of K6 (any dtype): each expert over every row, each
    row keeping its own expert's output (zero past offsets[E])."""
    _build.count_plain("expert_gate_up", x)
    _build.count_plain("expert_down", x)
    n_exp = w_gate.shape[0]
    rows = torch.arange(x.shape[0], device=x.device)
    own = torch.searchsorted(offsets[1:].to(rows.dtype), rows, right=True)
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    xf = x.float()
    for e in range(n_exp):
        h = (F.silu(xf @ w_gate[e].float().t())
             * (xf @ w_up[e].float().t())).to(x.dtype)
        ye = h.float() @ w_down[e].float().t()
        y = torch.where((own == e)[:, None], ye, y)
    return y.to(x.dtype)


def _check(x, offsets, w_gate, w_up, w_down) -> None:
    m, d = x.shape
    n_exp, f, d_in = w_gate.shape
    if d_in != d or w_up.shape != w_gate.shape \
            or w_down.shape != (n_exp, d, f):
        raise ValueError(f"x {tuple(x.shape)}, w_gate {tuple(w_gate.shape)}"
                         f", w_up {tuple(w_up.shape)}, w_down "
                         f"{tuple(w_down.shape)}: want (M, D), (E, F, D) x2 "
                         f"and (E, D, F)")
    if offsets.shape != (n_exp + 1,) or offsets.dtype != torch.int32:
        raise ValueError(f"offsets {tuple(offsets.shape)} {offsets.dtype}: "
                         f"want ({n_exp + 1},) int32")
    if x.dtype != torch.bfloat16 or any(
            w.dtype != torch.bfloat16 for w in (w_gate, w_up, w_down)):
        raise TypeError("the kernel takes bfloat16 rows and weights")
    if d % 128 or f % 128 or m == 0:
        raise ValueError(f"D={d} and F={f} must be multiples of 128, M > 0")
    for t in (x, offsets, w_gate, w_up, w_down):
        if not t.is_cuda or t.device != x.device or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"every operand must be a contiguous, 16-byte "
                             f"aligned tensor on {x.device}")


def expert_swiglu(x: Tensor, offsets: Tensor, w_gate: Tensor, w_up: Tensor,
                  w_down: Tensor) -> Tensor:
    """x (M, D) rows sorted by expert, offsets (E + 1,) int32 on x's device
    (offsets[0] = 0, non-decreasing, offsets[E] <= M), w_gate and w_up
    (E, F, D), w_down (E, D, F) -> y (M, D) in x's dtype."""
    if not x.is_cuda:
        return expert_swiglu_reference(x, offsets, w_gate, w_up, w_down)
    _check(x, offsets, w_gate, w_up, w_down)
    m, d = x.shape
    n_exp, f, _ = w_gate.shape
    h = torch.empty((m, f), dtype=x.dtype, device=x.device)
    y = torch.zeros_like(x)
    stream = _build.stream_ptr(x)
    up = _build.function(SOURCE, "expert_gate_up", _UP_ARGS)
    rc = up(_build.ptr(x), _build.ptr(w_gate), _build.ptr(w_up),
            _build.ptr(offsets), _build.ptr(h), m, d, f, n_exp, stream)
    _build.check(rc, "expert_gate_up")
    _build.count_launch("expert_gate_up")
    down = _build.function(SOURCE, "expert_down", _DOWN_ARGS)
    rc = down(_build.ptr(h), _build.ptr(w_down), _build.ptr(offsets),
              _build.ptr(y), m, d, f, n_exp, 64 if m <= NARROW_ROWS else 128,
              stream)
    _build.check(rc, "expert_down")
    _build.count_launch("expert_down")
    return y
