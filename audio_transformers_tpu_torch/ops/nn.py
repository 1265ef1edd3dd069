"""Neural-net primitives on PyTorch tensors.

The public functions keep the reference package's layouts
(`audio_transformers_tpu/ops/nn.py`): activations are channels-last
`(B, T, C)`. Parameters are in PyTorch's own layouts (linear `w` is
`(out, in)`, conv `w` is `(Cout, Cin, K)`); `core.params` converts from
and to the JAX trees. Matmuls run in the activation dtype; layer-norm
statistics and bias adds run in float32, as in the reference.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
NEG_INF = torch.finfo(torch.float32).min


def gelu(x: Tensor) -> Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def linear(params: dict, x: Tensor) -> Tensor:
    y = F.linear(x, params["w"].to(x.dtype))
    if "b" in params:
        y = y.float() + params["b"].float()
    return y.to(x.dtype)


def conv1d(params: dict, x: Tensor, *, stride: int = 1,
           padding: int = 0) -> Tensor:
    """x: (B, T, Cin) -> (B, T', Cout)."""
    y = F.conv1d(x.transpose(1, 2), params["w"].to(x.dtype), stride=stride,
                 padding=padding).transpose(1, 2)
    if "b" in params:
        y = y.float() + params["b"].float()
    return y.to(x.dtype)


def layer_norm(params: dict, x: Tensor, *, eps: float = 1e-5) -> Tensor:
    y = F.layer_norm(x.float(), (x.shape[-1],), params["scale"].float(),
                     params["bias"].float(), eps)
    return y.to(x.dtype)


def embedding_lookup(params: dict, ids: Tensor) -> Tensor:
    return params["table"][ids]


def sinusoidal_embeddings(length: int, dim: int,
                          max_timescale: float = 10000.0) -> Tensor:
    """Whisper sinusoids: concat(sin, cos) over channels, (length, dim) f32."""
    half = dim // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32)
                      * (math.log(max_timescale) / max(half - 1, 1)))
    args = torch.arange(length, dtype=torch.float32)[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def causal_mask(t: int, device=None) -> Tensor:
    """(1, 1, t, t) True on and below the diagonal."""
    return torch.ones((t, t), dtype=torch.bool,
                      device=device).tril()[None, None]


def multihead_attention(params: dict, q_in: Tensor, kv_in: Tensor, *,
                        num_heads: int, mask: Optional[Tensor] = None,
                        impl: str = "xla", causal: bool = False) -> Tensor:
    """Self- or cross-attention, q_in (B, Tq, D), kv_in (B, Tk, D).

    impl="xla" is matmul + float32 softmax (the reference's XLA
    formulation), with `mask` (broadcastable to (B, H, Tq, Tk), True =
    keep) or `causal`. impl="flash" projects straight to the head-major
    (B, H, T, hd) layout and runs the flash-attention kernels
    (`ops.attention.flash_attention`, forward and backward); it takes no
    mask beyond `causal`."""
    b, tq, d = q_in.shape
    hd = d // num_heads

    def heads(lin, x):   # (B, T, D) -> (B, H, T, hd)
        return linear(lin, x).reshape(b, -1, num_heads, hd).transpose(1, 2)

    q, k, v = (heads(params["q"], q_in), heads(params["k"], kv_in),
               heads(params["v"], kv_in))
    if impl == "flash":
        if mask is not None:
            raise NotImplementedError(
                "flash path supports only causal masking; pass impl='xla' "
                "for arbitrary masks")
        from audio_transformers_tpu_torch.ops.attention import \
            flash_attention
        out = flash_attention(q, k, v, causal=causal)     # (B, H, Tq, hd)
        return linear(params["o"], out.transpose(1, 2).reshape(b, tq, d))
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}")
    if causal and mask is None:
        mask = causal_mask(tq, q_in.device)
    # float32 logits, as the reference's preferred_element_type=f32
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        / math.sqrt(hd)
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype), v)              # (B, H, Tq, hd)
    return linear(params["o"], out.transpose(1, 2).reshape(b, tq, d))
