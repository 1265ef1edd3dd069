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
or "flash" (the flash-attention kernels, `ops/attention.py`), and remat
(`torch.utils.checkpoint` over each block, as the reference's
jax.checkpoint). In the
decode step, self and cross K/V keep the reference's time-minor
(B, H, hd, T) layout.
Cross-attention runs through the hand-written kernel
`ops.decode_attention.decode_cross_attention` (its plain version on the
CPU), over bf16/f32, int8 or nibble-packed int4 cross K/V; with beams, the
beams of a row share its cross K/V in one batched product instead. Self-attention over the short cache (bf16/f32, or int8
with per-step scales) stays plain PyTorch, as it stays XLA in the
reference. Unlike the reference's functional cache, the port's cache is
written in place: `apply_decoder_step` fills column `cache["index"]` of
each layer's buffers and advances the index.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from audio_transformers_tpu_torch.core.config import WhisperConfig
from audio_transformers_tpu_torch.core.params import map_tensors
from audio_transformers_tpu_torch.ops import nn
from audio_transformers_tpu_torch.ops.decode_attention import (
    decode_cross_attention, pack_int4, unpack_int4)
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
    backward (the reference's jax.checkpoint over each block)."""
    if not remat:
        return block
    return functools.partial(checkpoint, block, use_reentrant=False)


def encode(params: dict, cfg: WhisperConfig, mel: Tensor, *,
           remat: bool = False, attn_impl: str = "xla",
           model_group=None) -> Tensor:
    """mel (B, T_mel, n_mels) -> encoder states (B, T_mel // 2, d_model),
    in mel's dtype.

    attn_impl: "xla" (matmul + float32 softmax), "flash" (the flash
    attention kernels, forward and backward) or "auto", which is "xla"
    here as in the reference; the trainer resolves its own "auto". The
    positional table is frozen, as in the reference (stop_gradient): it
    takes no gradient. remat=True recomputes each block's activations in
    the backward instead of keeping them. With a `model_group`, `params`
    are this rank's shards (`param_axes`): each block runs its heads and
    hidden units, with two all-reduces, and every rank's output is the
    whole one."""
    if attn_impl == "auto":
        attn_impl = "xla"
    p = params["encoder"]
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
    time-minor (B, H, hd, L) layout, and the write index (a host int);
    on a model axis of `model_size`, H is this rank's heads.

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


def apply_decoder_step(sp: dict, cfg: WhisperConfig, token: Tensor,
                       cache: dict, cross: dict, *, beams: int = 1,
                       model_group=None) -> Tuple[Tensor, dict]:
    """One decode step over the step-ready weights `sp`
    (`prepare_decode_params`). token (B,) int64 -> (hidden (B, d_model),
    cache).

    Writes this step's self K/V at column cache["index"] (in place),
    attends over columns [0, index], then advances the index. An int8
    cache (`init_cache(quant="int8")`) takes the reference's int8
    self-attention: the new K/V column is quantized with its own scale,
    q is quantized per row, and the probabilities, with the V scales
    folded in, are quantized per row for the P.V product; the products
    run as float32 over integer values, exact while L * 127^2 < 2^24
    (L <= 1040; whisper's L <= 448).

    beams > 1: token and cache hold B*beams rows while `cross`, from
    `beam_cross`, holds the B encoder rows, shared by the beams of each
    row (`_beam_cross_attention`); the cross-attention kernel K1 is
    single-query and is not called, as in the reference.

    With a `model_group`, `sp`, `cache` and `cross` hold this rank's heads
    and hidden units and its rows of the embedding (`param_axes`): the
    lookup is vocab-parallel (one all-reduce), and each layer's self o,
    cross o and fc2 projections end in an all-reduce, so the hidden state
    returned is the whole one on every rank."""
    if beams > 1 and "p_dtype" not in cross:
        raise ValueError("a beam step reads the cross K/V of beam_cross()")
    idx = cache["index"]
    b = token.shape[0]
    hd = cfg.head_dim
    d = sp["blocks"][0]["qkv"]["w"].shape[0] // 3        # this rank's width
    h_heads = d // hd
    scale = 1.0 / math.sqrt(hd)
    cross_quant = "k_scale" in cross
    self_quant = "k_scale" in cache
    group = model_group

    x = nn.embedding_lookup(sp["embed"], token, group, cfg.vocab_size)
    x = x + sp["pos"][idx][None, :]
    x = x.to(sp["blocks"][0]["qkv"]["w"].dtype)
    for li, bp in enumerate(sp["blocks"]):
        h = nn.layer_norm(bp["self_ln"], x)
        qkv = nn.linear(bp["qkv"], h)                     # (B, 3D)
        q = qkv[:, :d].reshape(b, h_heads, hd)
        k_new = qkv[:, d:2 * d].reshape(b, h_heads, hd)
        v_new = qkv[:, 2 * d:].reshape(b, h_heads, hd)
        k_all, v_all = cache["k"][li], cache["v"][li]
        # columns past idx are masked out in the reference (exp of
        # finfo.min underflows to 0), so attending over [0, idx] is equal
        k_vis, v_vis = k_all[..., :idx + 1], v_all[..., :idx + 1]
        if self_quant:
            kq, ks = _q8(k_new)
            vq, vs = _q8(v_new)
            k_all[..., idx] = kq.to(torch.int8)
            v_all[..., idx] = vq.to(torch.int8)
            cache["k_scale"][li][..., idx] = ks[..., 0]
            cache["v_scale"][li][..., idx] = vs[..., 0]
            ks_vis = cache["k_scale"][li][..., :idx + 1]
            vs_vis = cache["v_scale"][li][..., :idx + 1]
            qq, qs = _q8(q)
            logits = (torch.einsum("bhd,bhdk->bhk", qq, k_vis.float())
                      * qs * ks_vis * scale)
            p = torch.softmax(logits, dim=-1) * vs_vis
            ps = p.amax(dim=-1, keepdim=True).clamp(min=1e-30) / 127.0
            attn = (torch.einsum("bhk,bhdk->bhd", torch.round(p / ps),
                                 v_vis.float()) * ps).to(x.dtype)
        else:
            k_all[..., idx] = k_new
            v_all[..., idx] = v_new
            logits = torch.einsum("bhd,bhdk->bhk", q.float(),
                                  k_vis.float()) * scale
            probs = torch.softmax(logits, dim=-1).to(v_all.dtype)
            attn = torch.einsum("bhk,bhdk->bhd", probs.float(),
                                v_vis.float()).to(x.dtype)
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
            cattn = decode_cross_attention(cq, cross["k"][li],
                                           cross["v"][li], k_scale=k_scale,
                                           v_scale=v_scale, scale=scale)
        x = x + nn.row_linear(bp["cross_o"], cattn.to(x.dtype).reshape(b, d),
                              group)

        h = nn.layer_norm(bp["mlp_ln"], x)
        x = x + _mlp(bp, h, group)
    cache["index"] = idx + 1
    return nn.layer_norm(sp["ln"], x), cache
