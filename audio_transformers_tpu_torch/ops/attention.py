"""Flash attention, forward and backward, as hand-written CUDA kernels.

Replaces the TPU kernels of `audio_transformers_tpu/ops/attention.py`:

  K4a `flash_attention_fwd`      <- `_fwd_kernel`: out and the per-row
      logsumexp `lse`, by an online softmax over key tiles;
  K4b `flash_attention_bwd_dq`   <- `_bwd_dq_kernel`: p = exp(s - lse),
      ds = p * (dO v^T - delta), dq = ds k;
  K4c `flash_attention_bwd_dkv`  <- `_bwd_dkv_kernel`: dv = p^T dO,
      dk = ds^T q.

Each kernel has two routes, chosen by dtype and by nothing else
(`SOURCE`): bfloat16 (the training path) runs K4a/K4b/K4c on the tensor
cores, `wgmma` kernels in `csrc/flash_attention_sm90.cu`; float32 runs
the float32 FMA kernels of `csrc/flash_attention.cu`, which hold the 2e-5
parity with the reference. Each source says what bounds its kernels on
the H100 and how they are laid out. `flash_attention` joins them in one
`torch.autograd.Function` that saves (q, k, v, out, lse) instead of the
probabilities, so residual memory is O(B*H*Tq), as in the reference. The softmax scale is folded into
q outside the Function, in q's dtype, and autograd chains it.

Every kernel has a plain PyTorch version beside it, with the same
arguments. A wrapper runs the plain version for a tensor on the CPU (the
CPU tests go through the Function that way) and the kernel for a CUDA
tensor; on CUDA it launches or raises, and never falls back.
"""

from __future__ import annotations

import ctypes
import math
from types import MappingProxyType
from typing import Optional, Tuple

import torch

from audio_transformers_tpu_torch.ops import _build

Tensor = torch.Tensor
NEG_INF = torch.finfo(torch.float32).min
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128
_MAX_GRID_Y = 65535
# fwd: q, k, v, out, lse; dq: q, k, v, dO, lse, delta, dq; dkv: ..., dk, dv;
# then bh, t_q, t_k, d, causal, dtype, stream
_TAIL = [ctypes.c_int] * 6 + [ctypes.c_void_p]
_FWD_ARGS = [ctypes.c_void_p] * 5 + _TAIL
_DQ_ARGS = [ctypes.c_void_p] * 7 + _TAIL
_DKV_ARGS = [ctypes.c_void_p] * 8 + _TAIL
# the source of all three kernels, by dtype (same C signatures); read
# only, so that no importer can reroute them
SOURCE = MappingProxyType({torch.float32: "flash_attention",
                           torch.bfloat16: "flash_attention_sm90"})


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _causal_keep(t_q: int, t_k: int, device) -> Tensor:
    """(Tq, Tk) True where key position <= query position."""
    return (torch.arange(t_k, device=device)[None, :]
            <= torch.arange(t_q, device=device)[:, None])


def _scores(q: Tensor, k: Tensor, causal: bool) -> Tensor:
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if causal:
        s = s.masked_fill(~_causal_keep(q.shape[1], k.shape[1], q.device),
                          NEG_INF)
    return s


def flash_attention_fwd_reference(q: Tensor, k: Tensor, v: Tensor,
                                  causal: bool) -> Tuple[Tensor, Tensor]:
    """Plain version of K4a: q (BH, Tq, d), k and v (BH, Tk, d), q already
    scaled -> (out (BH, Tq, d) in q's dtype, lse (BH, Tq) float32). p is
    rounded to v's dtype before P.V, as the TPU kernel rounds it."""
    _build.count_plain("flash_attention_fwd", q)
    s = _scores(q, k, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return out.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _bwd_ds(q, k, v, dout, lse, delta, causal):
    """(p, ds) in float32, masked entries 0."""
    s = _scores(q, k, causal)
    p = torch.exp(s - lse[..., None])
    if causal:
        p = p * _causal_keep(q.shape[1], k.shape[1], q.device)
    dov = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    return p, p * (dov - delta[..., None])


def flash_attention_bwd_dq_reference(q: Tensor, k: Tensor, v: Tensor,
                                     dout: Tensor, lse: Tensor, delta: Tensor,
                                     causal: bool) -> Tensor:
    """Plain version of K4b: dq (BH, Tq, d) in q's dtype; ds is rounded to
    k's dtype before ds.k."""
    _build.count_plain("flash_attention_bwd_dq", q)
    _, ds = _bwd_ds(q, k, v, dout, lse, delta, causal)
    return torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype)


def flash_attention_bwd_dkv_reference(q: Tensor, k: Tensor, v: Tensor,
                                      dout: Tensor, lse: Tensor,
                                      delta: Tensor, causal: bool
                                      ) -> Tuple[Tensor, Tensor]:
    """Plain version of K4c: (dk, dv), each (BH, Tk, d) in k's and v's
    dtype; p is rounded to dO's dtype before dv, ds to q's before dk."""
    _build.count_plain("flash_attention_bwd_dkv", q)
    p, ds = _bwd_ds(q, k, v, dout, lse, delta, causal)
    dv = torch.matmul(p.to(dout.dtype).float().transpose(-1, -2),
                      dout.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_reference(q: Tensor, k: Tensor, v: Tensor, *,
                        causal: bool = False,
                        scale: Optional[float] = None) -> Tensor:
    """Unfused attention with the same semantics, (B, H, T, d) layout
    (the reference's `attention_reference`)."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~_causal_keep(q.shape[2], k.shape[2], q.device),
                          NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(q: Tensor, k: Tensor, v: Tensor, *rest: Tensor) -> None:
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: want (BH,Tq,d), (BH,Tk,d) x2")
    bh, t_q, d = q.shape
    if t_q == 0 or k.shape[1] == 0:
        raise ValueError("empty query or key sequence")
    if not 0 < d <= _MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} outside (0, {_MAX_HEAD_DIM}]")
    if bh > _MAX_GRID_Y:
        raise ValueError(f"B*H = {bh} exceeds {_MAX_GRID_Y}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype} "
                        "(want one of float32, bfloat16)")
    for x in (q, k, v, *rest):
        if not x.is_cuda or x.device != q.device or not x.is_contiguous():
            raise ValueError(f"every operand must be a contiguous tensor on "
                             f"{q.device}")


def _check_bwd(q, dout, lse, delta):
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError("dO must have q's shape and dtype")
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != q.shape[:2] or x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 (BH, Tq)")


def _dims(q, k, causal):
    bh, t_q, d = q.shape
    return (bh, t_q, k.shape[1], d, int(bool(causal)), _DTYPES[q.dtype],
            _build.stream_ptr(q))


def flash_attention_fwd(q: Tensor, k: Tensor, v: Tensor,
                        causal: bool) -> Tuple[Tensor, Tensor]:
    """K4a: (out, lse) for q (BH, Tq, d) (scaled), k and v (BH, Tk, d)
    (the source by `SOURCE`)."""
    if not q.is_cuda:
        return flash_attention_fwd_reference(q, k, v, causal)
    _check(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    fn = _build.function(SOURCE[q.dtype], "flash_attention_fwd", _FWD_ARGS)
    rc = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
            _build.ptr(lse), *_dims(q, k, causal))
    _build.check(rc, "flash_attention_fwd")
    _build.count_launch("flash_attention_fwd")
    return out, lse


def flash_attention_bwd_dq(q: Tensor, k: Tensor, v: Tensor, dout: Tensor,
                           lse: Tensor, delta: Tensor,
                           causal: bool) -> Tensor:
    """K4b: dq (BH, Tq, d) in q's dtype (the source by `SOURCE`)."""
    if not q.is_cuda:
        return flash_attention_bwd_dq_reference(q, k, v, dout, lse, delta,
                                                causal)
    _check(q, k, v, dout, lse, delta)
    _check_bwd(q, dout, lse, delta)
    dq = torch.empty_like(q)
    fn = _build.function(SOURCE[q.dtype], "flash_attention_bwd_dq",
                         _DQ_ARGS)
    rc = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(dout),
            _build.ptr(lse), _build.ptr(delta), _build.ptr(dq),
            *_dims(q, k, causal))
    _build.check(rc, "flash_attention_bwd_dq")
    _build.count_launch("flash_attention_bwd_dq")
    return dq


def flash_attention_bwd_dkv(q: Tensor, k: Tensor, v: Tensor, dout: Tensor,
                            lse: Tensor, delta: Tensor,
                            causal: bool) -> Tuple[Tensor, Tensor]:
    """K4c: (dk, dv), each (BH, Tk, d) in k's dtype (the source by
    `SOURCE`)."""
    if not q.is_cuda:
        return flash_attention_bwd_dkv_reference(q, k, v, dout, lse, delta,
                                                 causal)
    _check(q, k, v, dout, lse, delta)
    _check_bwd(q, dout, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _build.function(SOURCE[q.dtype], "flash_attention_bwd_dkv",
                         _DKV_ARGS)
    rc = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(dout),
            _build.ptr(lse), _build.ptr(delta), _build.ptr(dk),
            _build.ptr(dv), *_dims(q, k, causal))
    _build.check(rc, "flash_attention_bwd_dkv")
    _build.count_launch("flash_attention_bwd_dkv")
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """(BH, T, d) flash attention over pre-scaled q; the reference's
    `_flash` custom_vjp."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        g = g.to(q.dtype).contiguous()
        # delta_i = rowsum(dO_i * out_i) in float32 (plain torch, as the
        # reference leaves it to XLA)
        delta = (g.float() * out.float()).sum(dim=-1)
        dq = flash_attention_bwd_dq(q, k, v, g, lse, delta, ctx.causal)
        dk, dv = flash_attention_bwd_dkv(q, k, v, g, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = False,
                    scale: Optional[float] = None) -> Tensor:
    """q (B, H, Tq, d), k and v (B, H, Tk, d) -> (B, H, Tq, d) in q's
    dtype. Differentiable in q, k and v."""
    b, h, t_q, d = q.shape
    t_k = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    # the scale rounded to q's dtype, as the reference multiplies; a
    # zero-dim CPU tensor is a scalar to a CUDA op, where one made on the
    # card would cost a host-to-device copy and a stream sync
    q = q * torch.tensor(scale, dtype=q.dtype)
    out = _FlashAttention.apply(q.reshape(b * h, t_q, d).contiguous(),
                                k.reshape(b * h, t_k, d).contiguous(),
                                v.reshape(b * h, t_k, d).contiguous(),
                                bool(causal))
    return out.reshape(b, h, t_q, d)
