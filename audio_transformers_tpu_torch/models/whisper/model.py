"""Whisper encoder-decoder (whisper-tiny class) on PyTorch tensors.

The functions of the reference (`audio_transformers_tpu/models/whisper/
model.py`) for the serving and training paths, over the port's parameter
trees (`core.params`):

  encoder: conv1d(n_mels->D,k3,p1) GELU -> conv1d(D->D,k3,s2,p1) GELU
           -> +positions (frozen) -> N pre-LN blocks -> LN
  decoder (teacher-forced, `apply_decoder`): tok embed + learned positions
           -> N pre-LN blocks (causal self-attention, cross-attention,
           MLP) -> LN; `logits_from_hidden` is the tied projection
  decoder step: tok embed + learned position -> N pre-LN blocks (causal
           self-attention over the KV cache, cross-attention over the
           precomputed encoder K/V, MLP) -> LN

The full-sequence passes take attn_impl "xla" (matmul + float32 softmax)
or "flash" (the flash-attention kernels, `ops/attention.py`; the serving
callers pass `resolve_encoder_attn`'s choice to the encoder), and
remat (`torch.utils.checkpoint` over each block, as the reference's
jax.checkpoint). In the
decode step, self and cross K/V keep the reference's time-minor
(B, H, hd, T) layout.
Cross-attention runs through the hand-written kernel
`ops.decode_attention.decode_cross_attention` (its plain version on the
CPU), over bf16/f32, int8 or nibble-packed int4 cross K/V, or, with
`step_attn="xla"`, through `xla_cross_attention`, the reference's XLA
arithmetic (`resolve_step_attn`); with beams, the
beams of a row share its cross K/V in one batched product instead. Self-attention over the short cache (bf16/f32, or int8
with per-step scales) stays plain PyTorch, as it stays XLA in the
reference, and attends over the whole static cache with the columns past
the position masked, as the reference does: a step's shapes do not
depend on its position. Unlike the reference's functional cache, the
port's cache is written in place: `apply_decoder_step` fills column
`cache["index"]` of each layer's buffers and advances the index.

The step's body (`_decoder_step`) reads its position from the cache's
0-d device tensor `cache["pos"]`, which `apply_decoder_step` advances
beside the host's `cache["index"]`. `decode.generate` runs the first
step eagerly on a side stream and captures the body there in a CUDA
graph (`_StepGraph`, through `_capture_after_first_step`); while the
cache carries it (`cache["graph"]`), `apply_decoder_step` replays it,
one graph launch a step.
"""

from __future__ import annotations

import functools
import math
import threading
import weakref
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from audio_transformers_tpu_torch.core import tracing
from audio_transformers_tpu_torch.core.config import WhisperConfig
from audio_transformers_tpu_torch.core.params import map_tensors
from audio_transformers_tpu_torch.ops import _build, decode_attention, nn
from audio_transformers_tpu_torch.ops.decode_attention import (
    decode_cross_attention, decode_cross_attention_reference, pack_int4,
    unpack_int4)
from audio_transformers_tpu_torch.ops.decode_logits import pad_vocab
from audio_transformers_tpu_torch.parallel import tensor as tp

Tensor = torch.Tensor


def param_axes(params: dict, cfg: WhisperConfig, model_size: int = 1):
    """The tensor-parallel layout of a whisper tree over a model axis of
    `model_size`, the reference's rules (`param_axes` of
    `audio_transformers_tpu/models/whisper/model.py`) on the port's (out,
    in) weights: q/k/v/fc1 weights cut along dim 0 (heads, hidden) with
    the q/v/fc1 biases (whisper's k has none), o/fc2 weights along dim 1
    (their inputs; their biases stay whole and are added once, after the
    all-reduce), the tied embedding's rows on the padded vocab boundary
    (`parallel.tensor.vocab_shard`), everything else whole. A tree of
    `parallel.tensor.Split` or None per leaf. Raises ValueError unless
    the heads split evenly: a cut inside a head is another computation."""
    if cfg.num_heads % model_size or cfg.ffn_dim % model_size:
        raise ValueError(f"{cfg.num_heads} heads (ffn {cfg.ffn_dim}) do not "
                         f"split over a model axis of {model_size}")
    tp.vocab_shard(cfg.vocab_size, model_size, 0)     # the vocab splits

    def axes(tree, path):
        if isinstance(tree, dict):
            return {k: axes(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [axes(v, path + (i,)) for i, v in enumerate(tree)]
        tail = "/".join(str(p) for p in path[-3:])
        if tail.endswith(("attn/q/w", "attn/k/w", "attn/v/w", "fc1/w",
                          "attn/q/b", "attn/v/b", "fc1/b")):
            return tp.Split(0)
        if tail.endswith(("attn/o/w", "fc2/w")):
            return tp.Split(1)
        if tail.endswith("embed/table"):
            return tp.Split(0, pad_vocab(cfg.vocab_size))
        return None
    return axes(params, ())


def _mlp(p: dict, h: Tensor, group) -> Tensor:
    """fc2(gelu(fc1(h))); under a model `group`, fc1 column- and fc2
    row-parallel (one all-reduce)."""
    h = nn.gelu(nn.linear(p["fc1"], tp.copy_to_model(h, group)))
    return nn.row_linear(p["fc2"], h, group)


def _self_block(p: dict, x: Tensor, heads: int, impl: str,
                group=None) -> Tensor:
    h = nn.layer_norm(p["self_ln"], x)
    x = x + nn.multihead_attention(p["self_attn"], h, h, num_heads=heads,
                                   impl=impl, group=group)
    h = nn.layer_norm(p["mlp_ln"], x)
    return x + _mlp(p, h, group)


def _blocks(block, remat: bool):
    """`block`, or with remat `block` under activation checkpointing: its
    activations are dropped after the forward and recomputed in the
    backward (the reference's jax.checkpoint over each block), where the
    recorder sees each recompute as a `block.recompute` span."""
    if not remat:
        return block
    recomputed = functools.partial(_recomputed, block)
    return functools.partial(checkpoint, recomputed, use_reentrant=False)


def _recomputed(block, *args):
    """block(*args), inside a `block.recompute` span when it runs in a
    backward (remat's recompute) with the recorder on."""
    if not tracing.enabled() or torch._C._current_graph_task_id() == -1:
        return block(*args)
    with tracing.span("block.recompute"):
        return block(*args)


def resolve_encoder_attn(device, dtype) -> str:
    """The encoder's self-attention route for a mel on `device` in `dtype`:
    "flash" (K4a, `ops.attention.flash_attention`) for bfloat16 on CUDA,
    where q and k are multiplied on the tensor cores and no (B, H, T, T)
    float32 logits are written; "xla" (the reference's arithmetic)
    otherwise: on the CPU and for float32."""
    if torch.device(device).type == "cuda" and dtype == torch.bfloat16:
        return "flash"
    return "xla"


def encode(params: dict, cfg: WhisperConfig, mel: Tensor, *,
           remat: bool = False, attn_impl: str = "xla",
           model_group=None) -> Tensor:
    """mel (B, T_mel, n_mels) -> encoder states (B, T_mel // 2, d_model),
    in mel's dtype.

    attn_impl: "xla" (matmul + float32 softmax), "flash" (the flash
    attention kernels, forward and backward) or "auto", which is "xla"
    here as in the reference; the trainer resolves its own "auto", and the
    serving callers pass `resolve_encoder_attn`'s choice for mel. Each
    call counts its route (`encode.attn.flash`, `encode.attn.xla`) with
    the recorder on. The
    positional table is frozen, as in the reference (stop_gradient): it
    takes no gradient. remat=True recomputes each block's activations in
    the backward instead of keeping them. With a `model_group`, `params`
    are this rank's shards (`param_axes`): each block runs its heads and
    hidden units, with two all-reduces, and every rank's output is the
    whole one."""
    if attn_impl == "auto":
        attn_impl = "xla"
    p = params["encoder"]
    with tracing.span("encode", device=mel.device):
        tracing.count(f"encode.attn.{attn_impl}")
        x = nn.gelu(nn.conv1d(p["conv1"], mel, padding=1))
        x = nn.gelu(nn.conv1d(p["conv2"], x, stride=2, padding=1))
        x = x + p["pos"].detach()[None, : x.shape[1], :].to(x.dtype)
        block = _blocks(_self_block, remat)
        for bp in p["blocks"]:
            x = block(bp, x, cfg.num_heads, attn_impl, model_group)
        return nn.layer_norm(p["ln"], x)


def _cross_block(p: dict, x: Tensor, enc: Tensor, heads: int,
                 impl: str, group=None) -> Tensor:
    h = nn.layer_norm(p["self_ln"], x)
    x = x + nn.multihead_attention(p["self_attn"], h, h, num_heads=heads,
                                   causal=True, impl=impl, group=group)
    h = nn.layer_norm(p["cross_ln"], x)
    x = x + nn.multihead_attention(p["cross_attn"], h, enc, num_heads=heads,
                                   impl=impl, group=group)
    h = nn.layer_norm(p["mlp_ln"], x)
    return x + _mlp(p, h, group)


def apply_decoder(params: dict, cfg: WhisperConfig, enc: Tensor,
                  tokens: Tensor, *, remat: bool = False,
                  attn_impl: str = "xla", model_group=None) -> Tensor:
    """Teacher-forced decoder pass: tokens (B, T) -> last hidden states
    (B, T, d_model) in enc's dtype. Causal self-attention with no padding
    mask, non-causal cross-attention, as in the reference. Embedding plus
    positions are summed in the parameters' dtype, then cast. "auto" is
    "xla", as in `encode`; so is remat; so is `model_group` (the
    embedding lookup of a vocab-sharded table takes one more
    all-reduce)."""
    if attn_impl == "auto":
        attn_impl = "xla"
    p = params["decoder"]
    x = nn.embedding_lookup(p["embed"], tokens, model_group, cfg.vocab_size)
    x = (x + p["pos"][None, : tokens.shape[1], :]).to(enc.dtype)
    block = _blocks(_cross_block, remat)
    for bp in p["blocks"]:
        x = block(bp, x, enc, cfg.num_heads, attn_impl, model_group)
    return nn.layer_norm(p["ln"], x)


def logits_from_hidden(params: dict, hidden: Tensor,
                       model_group=None) -> Tensor:
    """Tied output projection: hidden (B, T, D) @ embed^T -> (B, T, vocab)
    float32. Both operands are rounded to hidden's dtype and multiplied in
    float32, so bfloat16 operands give float32 logits, as the reference's
    preferred_element_type=f32 does (exact products; on the GPU this
    relies on PyTorch's default of no TF32 for float32 matmuls). With a
    `model_group` and this rank's rows of the table, the logits of its
    vocab shard (`parallel.tensor.gather_vocab` joins them)."""
    table = params["decoder"]["embed"]["table"].to(hidden.dtype)
    hidden = tp.copy_to_model(hidden, model_group)
    return torch.matmul(hidden.float(), table.float().t())


def init_cache(cfg: WhisperConfig, batch: int, *,
               max_len: Optional[int] = None, dtype=torch.float32,
               device=None, quant: str = "none",
               model_size: int = 1) -> dict:
    """Self-attention K/V buffers of static length, one per layer, in the
    time-minor (B, H, hd, L) layout, and the write index twice: a host
    int ("index", which the loops read) and a 0-d int64 tensor on the
    buffers' device ("pos", which the step reads, so that a captured step
    reads it too); on a model axis of `model_size`, H is this rank's
    heads.

    quant="int8" stores int8 K/V with one float32 scale per written time
    step, "k_scale" and "v_scale" of (B, H, L), as the reference does:
    the quantization of a past column never changes as the cache fills."""
    if quant not in ("none", "int8"):
        raise ValueError(f"unknown kv_quant {quant!r}")
    max_len = max_len or cfg.max_target_positions
    h, hd, n = cfg.num_heads // model_size, cfg.head_dim, cfg.decoder_layers

    def zeros(shape, dt):
        return [torch.zeros(shape, dtype=dt, device=device)
                for _ in range(n)]

    kv_dtype = torch.int8 if quant == "int8" else dtype
    cache = {"k": zeros((batch, h, hd, max_len), kv_dtype),
             "v": zeros((batch, h, hd, max_len), kv_dtype)}
    if quant == "int8":
        cache["k_scale"] = zeros((batch, h, max_len), torch.float32)
        cache["v_scale"] = zeros((batch, h, max_len), torch.float32)
    cache["index"] = 0
    cache["pos"] = torch.zeros((), dtype=torch.long, device=device)
    return cache


def prepare_decode_params(params: dict, cfg: WhisperConfig,
                          dtype=None) -> dict:
    """Step-ready decoder weights, built once outside the decode loop:
    per layer the self-attention q/k/v projections fused into one (3D, D)
    weight (whisper's k projection has no bias: a zero bias keeps the
    fused add uniform), and every tensor cast to `dtype` once. Over a
    rank's shards (`param_axes`) it fuses the rank's q/k/v rows, (3D/t,
    D)."""
    layers = []
    for bp in params["decoder"]["blocks"]:
        sa = bp["self_attn"]
        d = sa["q"]["w"].shape[0]
        qkv_w = torch.cat([sa["q"]["w"], sa["k"]["w"], sa["v"]["w"]], dim=0)
        kb = sa["k"].get("b", torch.zeros(d, dtype=sa["q"]["b"].dtype,
                                          device=sa["q"]["b"].device))
        qkv_b = torch.cat([sa["q"]["b"], kb, sa["v"]["b"]])
        layers.append({
            "self_ln": bp["self_ln"],
            "qkv": {"w": qkv_w, "b": qkv_b},
            "self_o": sa["o"],
            "cross_ln": bp["cross_ln"],
            "cross_q": bp["cross_attn"]["q"],
            "cross_o": bp["cross_attn"]["o"],
            "mlp_ln": bp["mlp_ln"],
            "fc1": bp["fc1"],
            "fc2": bp["fc2"],
        })
    dec = params["decoder"]
    out = {"embed": dec["embed"], "pos": dec["pos"], "blocks": layers,
           "ln": dec["ln"]}
    if dtype is not None:
        out = map_tensors(out, lambda t: t.to(dtype))
    return out


@tracing.spanned("cross_kv")
def precompute_cross_attention(params: dict, cfg: WhisperConfig, enc: Tensor,
                               *, quant: str = "none") -> dict:
    """Cross-attention K/V of every decoder layer, computed once per clip.

    Returns per-layer lists {"k", "v"} of (B, H, hd, T) tensors in enc's
    dtype, emitted directly in the time-minor layout (weight @ enc^T).
    quant="int8" stores int8 values with a per-key K scale (B, H, T) and
    a per-channel V scale (B, H, hd), both float32, as the reference does;
    the cross-attention kernel folds them at the edges. quant="int4" has
    the same scales at a quarter of the range (qmax 7) and stores the
    values nibble-packed along time (`pack_int4`, (B, H, hd, T/2) int8),
    the K scales split even/odd as (B, H, 2, T/2); T must be even. Over a
    rank's shards (`param_axes`) H is the rank's heads: every scale
    reduces within one head, so the shards' values are the whole run's."""
    if quant not in ("none", "int8", "int4"):
        raise ValueError(f"unknown kv_quant {quant!r}")
    out = {"k": [], "v": []}
    if quant != "none":
        out["k_scale"], out["v_scale"] = [], []
    qmax = 127.0 if quant == "int8" else 7.0
    b, t, _ = enc.shape
    if quant == "int4" and t % 2:
        # a zero-padded phantom key would score 0, not -inf, and leak into
        # the softmax; whisper's encoder length is always even
        raise ValueError(f"kv_quant='int4' needs an even encoder length, "
                         f"got T={t}")
    hd = cfg.head_dim
    enc_t = enc.transpose(1, 2)                           # (B, D, T)
    for bp in params["decoder"]["blocks"]:
        h = bp["cross_attn"]["k"]["w"].shape[0] // hd
        kv = []
        for name in ("k", "v"):
            lin = bp["cross_attn"][name]
            y = torch.matmul(lin["w"].to(enc.dtype), enc_t).float()
            if "b" in lin:
                y = y + lin["b"].float()[None, :, None]
            kv.append(y.to(enc.dtype).reshape(b, h, hd, t))
        k, v = kv
        if quant == "none":
            out["k"].append(k)
            out["v"].append(v)
            continue
        k_scale = k.abs().amax(dim=2, keepdim=True).float().clamp(
            min=1e-6) / qmax                              # (B, H, 1, T)
        v_scale = v.abs().amax(dim=3, keepdim=True).float().clamp(
            min=1e-6) / qmax                              # (B, H, hd, 1)
        k_q = torch.round(k.float() / k_scale)
        v_q = torch.round(v.float() / v_scale)
        out["v_scale"].append(v_scale[:, :, :, 0].contiguous())
        if quant == "int4":
            out["k"].append(pack_int4(k_q))
            out["v"].append(pack_int4(v_q))
            ks = k_scale[:, :, 0, :]
            out["k_scale"].append(torch.stack(
                [ks[..., 0::2], ks[..., 1::2]], dim=2).contiguous())
            continue
        out["k"].append(k_q.to(torch.int8))
        out["v"].append(v_q.to(torch.int8))
        out["k_scale"].append(k_scale[:, :, 0, :].contiguous())
    return out


def _q8(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Symmetric int8 quantization of the last axis, as the reference's
    `_q8`: returns the int8 values (held exactly in float32) and the
    float32 scale max|x| / 127 (at least 1e-6 / 127), shaped (..., 1)."""
    x32 = x.float()
    s = x32.abs().amax(dim=-1, keepdim=True).clamp(min=1e-6) / 127.0
    return torch.round(x32 / s), s


def beam_cross(cross: dict) -> dict:
    """The cross K/V of `precompute_cross_attention` as the beam step
    reads them, made once per decode: float32 copies of "k" and "v" (the
    beams' batched products run in float32; int8 values are exact in
    float32), the scales as they are, and "p_dtype", the dtype the
    probabilities are rounded to before P.V (the K/V's own dtype, as the
    reference's `cp.astype(vq.dtype)`; int8 K/V meet float32 p).

    int4 K/V follow the reference's int4 beam arithmetic: unpacked and
    dequantized to float32 with their scales folded in (the reference
    does it every step; the values are the same), then read as unquantized
    K/V with float32 p: q is not quantized, unlike int8's beam branch."""
    out = dict(cross)
    if "k_scale" in cross and cross["k_scale"][0].dim() == 4:
        del out["k_scale"], out["v_scale"]
        out["k"], out["v"] = [], []
        for k, v, ks, vs in zip(cross["k"], cross["v"], cross["k_scale"],
                                cross["v_scale"]):
            # (B, H, 2, T/2) even/odd scales -> interleaved (B, H, T)
            k_s = ks.transpose(2, 3).reshape(*ks.shape[:2], -1)
            out["k"].append(unpack_int4(k).float() * k_s[:, :, None, :])
            out["v"].append(unpack_int4(v).float() * vs[:, :, :, None])
        out["p_dtype"] = torch.float32
        return out
    out["k"] = [t.float() for t in cross["k"]]
    out["v"] = [t.float() for t in cross["v"]]
    out["p_dtype"] = torch.float32 if "k_scale" in cross \
        else cross["v"][0].dtype
    return out


def _beam_cross_attention(cq: Tensor, k: Tensor, v: Tensor,
                          k_scale: Optional[Tensor], v_scale: Optional[Tensor],
                          beams: int, scale: float,
                          p_dtype: torch.dtype) -> Tensor:
    """Cross-attention of B*beams query rows cq (B*beams, H, hd) over the
    B rows of float32 cross K/V (B, H, hd, T) from `beam_cross`: every
    beam of a batch row shares its row's K/V in one batched product,
    (B, H, beams, hd) @ (B, H, hd, T), with float32 accumulation, as the
    reference's `bnhd,bhdk->bnhk` einsum (int4 K/V arrive dequantized
    from `beam_cross` and take this unquantized branch).

    int8 K/V follow the reference's beam arithmetic (the `beams > 1`
    branch of `audio_transformers_tpu/models/whisper/model.py`), which
    differs from K1: q is quantized per (b,
    beam, h) row, the integer logits are scaled back by q's scale, then
    k_scale, then the softmax scale; the float32 probabilities meet V as
    float32 and v_scale multiplies the output. The int8 products run as
    float32 products of integer values, exact while hd * 127^2 < 2^24."""
    rows, h, hd = cq.shape
    q = cq.reshape(rows // beams, beams, h, hd).transpose(1, 2).float()
    if k_scale is None:
        logits = torch.matmul(q, k) * scale              # (B, H, N, T)
        p = torch.softmax(logits, dim=-1).to(p_dtype).float()
        out = torch.matmul(p, v.transpose(-1, -2))
    else:
        qq, qs = _q8(q)
        logits = (torch.matmul(qq, k) * qs
                  * k_scale[:, :, None, :] * scale)
        p = torch.softmax(logits, dim=-1)
        out = torch.matmul(p, v.transpose(-1, -2)) * v_scale[:, :, None, :]
    return out.transpose(1, 2).reshape(rows, h, hd)


def resolve_step_attn(step_attn: str) -> str:
    """`DecodeConfig.step_attn` -> "fused" (K1, `decode_cross_attention`)
    or "xla" (`xla_cross_attention`). "auto" is "fused" on every device
    (on the CPU K1's plain version runs); the reference's "auto" is its
    kernel on a TPU and XLA elsewhere. Anything else raises ValueError."""
    if step_attn not in ("auto", "fused", "xla"):
        raise ValueError(f"unknown step_attn {step_attn!r}")
    return "fused" if step_attn == "auto" else step_attn


def xla_cross_attention(q: Tensor, k: Tensor, v: Tensor,
                        k_scale: Optional[Tensor] = None,
                        v_scale: Optional[Tensor] = None, *,
                        scale: float) -> Tensor:
    """One decode step's cross-attention as the reference computes it
    with step_attn="xla" (the greedy branches of `apply_decoder_step` in
    `audio_transformers_tpu/models/whisper/model.py`), for q (B, H, hd)
    in the activation dtype over the K/V of `precompute_cross_attention`;
    returns (B, H, hd) in q's dtype. Unlike K1, int8 quantizes q and p:

      int4: the kernel's oracle on the unpadded K/V
        (`decode_cross_attention_reference`, K1's plain version);
      int8: q quantized per (b, h) row (`_q8`), the integer logits scaled
        back by q's scale, k_scale and the softmax scale; the
        probabilities quantized per row (max p / 127) and their integer
        product with V scaled by p's scale and v_scale. QK sums hd
        products of at most 127^2 (1.03e6 at hd 64): exact in float32.
        PV sums T products of at most 127^2 (2.4e7 at whisper's 1500
        keys), past float32's 2^24, so it accumulates in float64, where
        every such sum is exact, as the reference's int32 is;
      bf16/f32: float32 logits, the probabilities rounded to q's dtype,
        PV accumulated in float32."""
    if k_scale is not None and k_scale.dim() == 4:
        return decode_cross_attention_reference(
            q, k, v, k_scale=k_scale, v_scale=v_scale, scale=scale)
    if k_scale is not None:
        qq, qs = _q8(q)
        logits = (torch.einsum("bhd,bhdk->bhk", qq, k.float()) * qs
                  * k_scale * scale)
        p = torch.softmax(logits, dim=-1)
        ps = p.amax(dim=-1, keepdim=True) / 127.0
        pv = torch.einsum("bhk,bhdk->bhd", torch.round(p / ps).double(),
                          v.double())
        return (pv.float() * ps * v_scale).to(q.dtype)
    logits = torch.einsum("bhd,bhdk->bhk", q.float(), k.float()) * scale
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhk,bhdk->bhd", p.float(), v.float()).to(q.dtype)


def apply_decoder_step(sp: dict, cfg: WhisperConfig, token: Tensor,
                       cache: dict, cross: dict, *, beams: int = 1,
                       model_group=None,
                       step_attn: str = "auto") -> Tuple[Tensor, dict]:
    """One decode step over the step-ready weights `sp`
    (`prepare_decode_params`). token (B,) int64 -> (hidden (B, d_model),
    cache).

    Writes this step's self K/V at column cache["pos"] (in place; the
    host's cache["index"] holds the same number), attends over the whole
    cache with the columns past it masked out (probability exactly 0),
    then advances both. An int8
    cache (`init_cache(quant="int8")`) takes the reference's int8
    self-attention: the new K/V column is quantized with its own scale,
    q is quantized per row, and the probabilities, with the V scales
    folded in, are quantized per row for the P.V product; the products
    run as float32 over integer values, exact while L * 127^2 < 2^24
    (L <= 1040; whisper's L <= 448).

    beams > 1: token and cache hold B*beams rows while `cross`, from
    `beam_cross`, holds the B encoder rows, shared by the beams of each
    row (`_beam_cross_attention`); the cross-attention kernel K1 is
    single-query and is not called, as in the reference. Otherwise
    `step_attn` (`resolve_step_attn`) picks K1 or `xla_cross_attention`.

    With a `model_group`, `sp`, `cache` and `cross` hold this rank's heads
    and hidden units and its rows of the embedding (`param_axes`): the
    lookup is vocab-parallel (one all-reduce), and each layer's self o,
    cross o and fc2 projections end in an all-reduce, so the hidden state
    returned is the whole one on every rank.

    While the cache carries a captured step (`cache["graph"]`, set by
    `decode.generate` on the card), the step is a replay of that graph on
    `token`, and the hidden state returned is the graph's output buffer,
    which the next replay overwrites."""
    graph = cache.get("graph")
    if graph is not None:
        hidden = graph.replay(token)
    else:
        hidden = _decoder_step(sp, cfg, token, cache, cross, beams=beams,
                               model_group=model_group, step_attn=step_attn)
    cache["index"] += 1
    cache["pos"] += 1
    return hidden, cache


def _column(buf: Tensor, pos: Tensor, val: Tensor) -> None:
    """Writes val (...) as column `pos` (0-d int64) of buf (..., L), in
    place."""
    buf.index_copy_(buf.dim() - 1, pos.view(1), val.unsqueeze(-1))


def _decoder_step(sp: dict, cfg: WhisperConfig, token: Tensor, cache: dict,
                  cross: dict, *, beams: int = 1, model_group=None,
                  step_attn: str = "auto") -> Tensor:
    """The body of `apply_decoder_step` at the position cache["pos"]: every
    shape is the same at every position, and it makes no host sync, so it
    can be captured in a CUDA graph. It writes the cache's columns at the
    position and leaves both indices as they are; returns the hidden
    state (B, d_model)."""
    if beams > 1 and "p_dtype" not in cross:
        raise ValueError("a beam step reads the cross K/V of beam_cross()")
    b = token.shape[0]
    hd = cfg.head_dim
    d = sp["blocks"][0]["qkv"]["w"].shape[0] // 3        # this rank's width
    h_heads = d // hd
    scale = 1.0 / math.sqrt(hd)
    cross_quant = "k_scale" in cross
    self_quant = "k_scale" in cache
    group = model_group
    cross_attention = (decode_cross_attention
                       if resolve_step_attn(step_attn) == "fused"
                       else xla_cross_attention)

    x = nn.embedding_lookup(sp["embed"], token, group, cfg.vocab_size)
    pos = cache["pos"]
    x = x + sp["pos"].index_select(0, pos.view(1))
    x = x.to(sp["blocks"][0]["qkv"]["w"].dtype)
    # the reference's mask: columns past pos take finfo.min before the
    # softmax, whose exp underflows to exactly 0
    visible = torch.arange(cache["k"][0].shape[-1], device=x.device) <= pos
    masked = torch.finfo(torch.float32).min
    for li, bp in enumerate(sp["blocks"]):
        h = nn.layer_norm(bp["self_ln"], x)
        qkv = nn.linear(bp["qkv"], h)                     # (B, 3D)
        q = qkv[:, :d].reshape(b, h_heads, hd)
        k_new = qkv[:, d:2 * d].reshape(b, h_heads, hd)
        v_new = qkv[:, 2 * d:].reshape(b, h_heads, hd)
        k_all, v_all = cache["k"][li], cache["v"][li]
        if self_quant:
            kq, ks = _q8(k_new)
            vq, vs = _q8(v_new)
            _column(k_all, pos, kq.to(torch.int8))
            _column(v_all, pos, vq.to(torch.int8))
            ks_all, vs_all = cache["k_scale"][li], cache["v_scale"][li]
            _column(ks_all, pos, ks[..., 0])
            _column(vs_all, pos, vs[..., 0])
            qq, qs = _q8(q)
            logits = (torch.einsum("bhd,bhdk->bhk", qq, k_all.float())
                      * qs * ks_all * scale)
            logits = torch.where(visible, logits, masked)
            p = torch.softmax(logits, dim=-1) * vs_all
            ps = p.amax(dim=-1, keepdim=True).clamp(min=1e-30) / 127.0
            attn = (torch.einsum("bhk,bhdk->bhd", torch.round(p / ps),
                                 v_all.float()) * ps).to(x.dtype)
        else:
            _column(k_all, pos, k_new)
            _column(v_all, pos, v_new)
            logits = torch.einsum("bhd,bhdk->bhk", q.float(),
                                  k_all.float()) * scale
            logits = torch.where(visible, logits, masked)
            probs = torch.softmax(logits, dim=-1).to(v_all.dtype)
            attn = torch.einsum("bhk,bhdk->bhd", probs.float(),
                                v_all.float()).to(x.dtype)
        x = x + nn.row_linear(bp["self_o"], attn.reshape(b, d), group)

        h = nn.layer_norm(bp["cross_ln"], x)
        cq = nn.linear(bp["cross_q"], h).reshape(b, h_heads, hd)
        k_scale = cross["k_scale"][li] if cross_quant else None
        v_scale = cross["v_scale"][li] if cross_quant else None
        if beams > 1:
            cattn = _beam_cross_attention(cq, cross["k"][li], cross["v"][li],
                                          k_scale, v_scale, beams, scale,
                                          cross["p_dtype"])
        else:
            cattn = cross_attention(cq, cross["k"][li], cross["v"][li],
                                    k_scale=k_scale, v_scale=v_scale,
                                    scale=scale)
        x = x + nn.row_linear(bp["cross_o"], cattn.to(x.dtype).reshape(b, d),
                              group)

        h = nn.layer_norm(bp["mlp_ln"], x)
        x = x + _mlp(bp, h, group)
    return nn.layer_norm(sp["ln"], x)


class _StepGraph:
    """`_decoder_step` captured once in a CUDA graph over one decode's
    weights, self cache (its position `cache["pos"]` included) and cross
    K/V, with a static token buffer.

    The graph is replayed only through the cache that carries it, and so
    in one `generate` call: weights updated in place between calls are
    read as they are. Its memory comes from `pool`: the pool of a graph
    that no decode replays any more (`_capture_after_first_step`), or a
    new one (None). Torch returns a dead graph's own pool to the card only
    at `empty_cache` or an allocation that fails, so a new pool a call
    held 24 MiB (whisper-tiny) to 40 MiB (large-v3, batch 64) more at
    every call. A pool is never shared by two graphs in use: the output
    buffer, which the token's eager work reads after the replay, could be
    the other graph's scratch, and its replay, queued in between by
    another thread, would overwrite it. K1 launches in the graph take
    scratch of the graph's own (`decode_attention.graph_scratch`). The
    kernel launches that the capture records (`_build.tally`, this
    thread's only) are added to `_build.STATS` at each replay."""

    def __init__(self, sp: dict, cfg: WhisperConfig, cache: dict,
                 cross: dict, *, step_attn: str, stream, pool):
        dev = cache["k"][0].device
        # on the current stream, the one that replays the graph
        self.token = torch.zeros(cache["k"][0].shape[0], dtype=torch.long,
                                 device=dev)
        self.graph = torch.cuda.CUDAGraph()
        with _build.tally() as self.counts, torch.cuda.stream(stream), \
                decode_attention.graph_scratch(dev, stream):
            self.graph.capture_begin(pool=pool,
                                     capture_error_mode="thread_local")
            try:
                self.hidden = _decoder_step(sp, cfg, self.token, cache,
                                            cross, step_attn=step_attn)
            finally:
                self.graph.capture_end()

    def replay(self, token: Tensor) -> Tensor:
        """The step on `token` (B,): the graph replayed on the current
        stream; returns the output buffer."""
        self.token.copy_(token)
        self.graph.replay()
        for name, counted in self.counts.items():
            _build.STATS[name].launches += counted.launches
            _build.STATS[name].plain_cuda_calls += counted.plain_cuda_calls
        tracing.count("decode.graph_replays")
        return self.hidden


# a device's side stream for the first step and the capture, which take
# it one call at a time, and the graphs whose decodes have ended, each with
# an event after its last replay: never replayed again, each is kept so
# that its memory pool lives on for a later capture (torch takes a pool
# for a capture only while a graph of it lives: a dead graph's fails an
# internal assert of its allocators)
_CAPTURE_STATE: Dict[int, Tuple["torch.cuda.Stream", list]] = {}
_CAPTURE_LOCK = threading.Lock()


def _graph_ended(ended: list, graph, stream) -> None:
    """A decode dropped its step: `graph` and an event on the stream that
    replayed it, after everything queued there so far, join `ended`."""
    done = torch.cuda.Event()
    done.record(stream)
    ended.append((graph, done))


def _capture_after_first_step(sp: dict, cfg: WhisperConfig, token: Tensor,
                              cache: dict, cross: dict, *,
                              step_attn: str = "auto") -> Tuple[Tensor, dict]:
    """`apply_decoder_step` for a decode's first step, on the card and
    without a model group, then the step body captured for the rest of
    the decode (cache["graph"], a `_StepGraph`).

    The first step runs eagerly through `apply_decoder_step` on a side
    stream: torch's warm-up on the stream that the capture uses (cuBLAS's
    workspace for that stream). The current stream waits for it, and the
    capture follows at once, while the card runs the first step, in a
    `decode.capture` span. The graph's static buffers are made on the
    current stream, which replays the graph: made on the side stream, a
    buffer freed at the end of one thread's decode could be handed to
    another thread's first step while the first thread's last replays
    still read it. The replays of a graph that takes an ended graph's
    pool wait for that graph's last replay, whichever stream ran it.
    Returns what `apply_decoder_step` does."""
    dev = token.device
    current = torch.cuda.current_stream(dev)
    with _CAPTURE_LOCK:
        state = _CAPTURE_STATE.get(dev.index)
        if state is None:
            # from torch's pool of high-priority streams: the default-priority
            # pool hands its 32 streams out in turn, and a thread whose
            # stream came round to this one could not decode during another
            # thread's capture
            state = _CAPTURE_STATE[dev.index] = (
                torch.cuda.Stream(dev, priority=-1), [])
        side, ended = state
        side.wait_stream(current)
        with torch.cuda.stream(side):
            hidden, cache = apply_decoder_step(sp, cfg, token, cache, cross,
                                               step_attn=step_attn)
        current.wait_stream(side)
        hidden.record_stream(current)
        last, done = ended.pop() if ended else (None, None)
        if done is not None:
            current.wait_event(done)
        with tracing.span("decode.capture"):
            step = _StepGraph(sp, cfg, cache, cross, step_attn=step_attn,
                              stream=side,
                              pool=None if last is None else last.pool())
        # once the decode drops the step, its pool is free for another
        weakref.finalize(step, _graph_ended, ended, step.graph, current)
        cache["graph"] = step
        tracing.count("decode.graph_captures")
    return hidden, cache
