"""Uni-MoE-2.0-Omni's speech understanding on PyTorch tensors: the
whisper encoder (`models/whisper/model.encode`), an audio connector and a
Qwen2-style language model whose every FFN is a dynamic-capacity mixture
of experts (`model_type` grin_qwen2_vl, huggingface.co/HIT-TMG/
Uni-MoE-2.0-Omni). Audio and text in, text out.

The equations (x the residual stream, u its normalised copy):

  RMSNorm(x) = x / sqrt(mean(x^2) + 1e-6) * scale, in float32.
  Attention: u = RMSNorm(x); q = Wq u + bq, k = Wk u + bk, v = Wv u + bv
      (Qwen2's q/k/v bias). M-RoPE rotates the 64 frequency pairs
      (dims i and i + 64 of a 128-wide head, Qwen2-VL's rotate-half),
      theta_i = 1e6^(-i / 64): pairs 0-15 by the t row of the positions,
      16-39 by h, 40-63 by w (`mrope_section` [16, 24, 24]). Text and
      audio tokens take t = h = w = their index in the row's unpadded
      sequence. Causal attention, 28 query heads in 4 groups of 7 over 4
      K/V heads, scale 1/sqrt(128) (the 32768-token sliding window never
      binds). x <- x + Wo attn.
  MoE FFN: u = RMSNorm(x); p = softmax(float32(u) Wg) over 5 slots, the
      4 routed experts and slot 4, the null expert. Sort p in descending
      order; keep the fewest leading slots whose sum reaches 0.7, at most
      2. out = S0(u) + S1(u) + sum over kept experts e != null of
      p_e E_e(u), E(u) = Wdown(silu(Wgate u) * Wup u); the weights are
      not renormalised and the shared experts S0, S1 are not gated.
      x <- x + out.
  Head: the final RMSNorm, then the untied head over 152064 ids.
  Audio: each 30 s window through the whisper-large-v3 front end and
      encoder (1500 x 1280), adaptive average pooling over time to 200
      frames, then the linear projector 1280 -> 3584 with bias: 200
      embeddings a window.
  A row: 8 prompt ids, the audio tokens of its windows in order, the rest
      of the prompt; then greedy decoding for a fixed number of steps.

The published description leaves the q/k/v bias, the audio positions,
the pooling, the unrenormalised weights and the ungated shared experts
open; each is listed under `assumed` in the benchmark's configuration.

The path: rows of different lengths batch together. The prefill runs
every token-wise operation on the rows' tokens packed (N, D), and the
attention on a right-padded (B, H, T, 128) layout through K4a
(`ops/attention.flash_attention`, causal: a row's tokens see only its
own earlier tokens), the 4 K/V heads expanded to 28 first. The K/V of
every layer go to a static cache (B, 4, T_max, 128) a layer; a decode
step writes column pos_b of row b and attends over the columns up to
pos_b. The routed experts run through K6 (`ops/expert_gemm`) over the
slots sorted by expert, whose offsets stay on the card; nothing in the
layer stack or a decode step waits for the host. The greedy pick is K2
(`ops/decode_logits.fused_greedy_step`) over the head's transposed,
padded copy, whose `greedy_plan` fits D = 3584 (row groups of 8).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from audio_transformers_tpu_torch.core import tracing
from audio_transformers_tpu_torch.core.config import OmniConfig, UniMoEConfig
from audio_transformers_tpu_torch.core.params import init_whisper
from audio_transformers_tpu_torch.models.whisper import model as wm
from audio_transformers_tpu_torch.ops import _build, nn
from audio_transformers_tpu_torch.ops.attention import flash_attention
from audio_transformers_tpu_torch.ops.decode_logits import (
    fused_greedy_step, pad_vocab)
from audio_transformers_tpu_torch.ops.expert_gemm import expert_swiglu
from audio_transformers_tpu_torch.ops.logit_processors import NEG_INF

Tensor = torch.Tensor
# counters of the routing, in the order of `Router.stats`
STAT_NAMES = ("moe.slots.expert0", "moe.slots.expert1", "moe.slots.expert2",
              "moe.slots.expert3", "moe.slots.null", "moe.tokens.one_slot",
              "moe.experts.active", "moe.tokens")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _uniform(g, shape, bound):
    return (torch.rand(shape, generator=g) * 2.0 - 1.0) * bound


def init_llm(cfg: UniMoEConfig, g: torch.Generator,
             router_scale: float = 1.0) -> dict:
    """Seeded language-model weights: linear weights and biases uniform in
    +-1/sqrt(fan_in) (the router's times `router_scale`), the embedding
    standard normal (at a trained model's 0.02 the random layers' outputs
    swamp a token's identity, and greedy ids repeat), norm scales 1."""
    d, hd = cfg.hidden_size, cfg.head_dim
    kv = cfg.num_kv_heads * hd
    e, f = cfg.num_experts, cfg.expert_size
    fs = cfg.shared_experts * cfg.shared_size

    def lin(out, inp, bias=True):
        b = 1.0 / math.sqrt(inp)
        p = {"w": _uniform(g, (out, inp), b)}
        if bias:
            p["b"] = _uniform(g, (out,), b)
        return p

    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "attn_norm": {"scale": torch.ones(d)},
            "attn": {"q": lin(d, d), "k": lin(kv, d), "v": lin(kv, d),
                     "o": lin(d, d, bias=False)},
            "moe_norm": {"scale": torch.ones(d)},
            "moe": {
                "router": {"w": _uniform(g, (cfg.slots, d),
                                         router_scale / math.sqrt(d))},
                "experts": {"w_gate": _uniform(g, (e, f, d), 1 / math.sqrt(d)),
                            "w_up": _uniform(g, (e, f, d), 1 / math.sqrt(d)),
                            "w_down": _uniform(g, (e, d, f), 1 / math.sqrt(f))},
                "shared": {"w_gate": _uniform(g, (fs, d), 1 / math.sqrt(d)),
                           "w_up": _uniform(g, (fs, d), 1 / math.sqrt(d)),
                           "w_down": _uniform(
                               g, (d, fs), 1 / math.sqrt(cfg.shared_size))},
            }})
    return {"embed": {"table": torch.randn((cfg.vocab_size, d),
                                           generator=g)},
            "layers": layers,
            "norm": {"scale": torch.ones(d)},
            "head": {"w": _uniform(g, (cfg.vocab_size, d), 1 / math.sqrt(d))}}


def init(cfg: OmniConfig, g: torch.Generator,
         router_scale: float = 1.0) -> dict:
    """Seeded weights of the whole model: {"whisper": {"encoder"},
    "connector", "llm"} (the whisper decoder is not part of it)."""
    enc = init_whisper(cfg.whisper, g)["encoder"]
    dw, dl = cfg.whisper.d_model, cfg.llm.hidden_size
    b = 1.0 / math.sqrt(dw)
    return {"whisper": {"encoder": enc},
            "connector": {"w": _uniform(g, (dl, dw), b),
                          "b": _uniform(g, (dl,), b)},
            "llm": init_llm(cfg.llm, g, router_scale)}


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def rms_norm(p: dict, x: Tensor, eps: float) -> Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * p["scale"].float()).to(x.dtype)


def mrope(positions: Tensor, cfg: UniMoEConfig):
    """(cos, sin), each (N, head_dim) float32, for positions (3, N): the t,
    h and w rows, pair i taking the row `mrope_section` assigns it."""
    hd = cfg.head_dim
    if sum(cfg.mrope_section) != hd // 2:
        raise ValueError(f"mrope_section {cfg.mrope_section} does not sum to "
                         f"{hd // 2}")
    inv = cfg.rope_theta ** (-torch.arange(0, hd, 2, dtype=torch.float64,
                                           device=positions.device) / hd)
    pos = positions.to(torch.float64)
    parts, start = [], 0
    for row, n in enumerate(cfg.mrope_section):
        parts.append(pos[row][:, None] * inv[None, start:start + n])
        start += n
    ang = torch.cat(parts, dim=-1).float()            # (N, hd / 2)
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos(), ang.sin()


def rotate(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """x (N, H, hd) rotated by (N, hd) tables, in float32."""
    xf = x.float()
    half = x.shape[-1] // 2
    rot = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos[:, None] + rot * sin[:, None]).to(x.dtype)


def _swiglu(p: dict, u: Tensor) -> Tensor:
    """Wdown(silu(Wgate u) * Wup u) in the activation dtype (the shared
    experts: both at once, their widths side by side)."""
    h = F.silu(F.linear(u, p["w_gate"])) * F.linear(u, p["w_up"])
    return F.linear(h, p["w_down"])


# ---------------------------------------------------------------------------
# the MoE FFN
# ---------------------------------------------------------------------------


def route(router_w: Tensor, u: Tensor, cfg: UniMoEConfig):
    """Top-p routing over the slots: (slots (N, top_k) int64, the kept
    slot ids in descending p, or `cfg.slots` where nothing is kept;
    weights (N, top_k) float32, p of each kept routed expert and 0 for
    the null expert and unkept slots). The router runs in float32."""
    p = torch.softmax(u.float() @ router_w.float().t(), dim=-1)
    top, idx = torch.sort(p, dim=-1, descending=True, stable=True)
    top, idx = top[:, :cfg.top_k], idx[:, :cfg.top_k]
    before = torch.cumsum(top, dim=-1) - top          # sum of earlier slots
    keep = before < cfg.top_p                          # slot 0 always
    slots = torch.where(keep, idx, cfg.slots)
    weights = torch.where(keep & (idx < cfg.num_experts), top, 0.0)
    return slots, weights


def dispatch(slots: Tensor, n_exp: int):
    """(order, offsets): the (token, slot) entries sorted by expert (the
    null and unkept ones last), and the (E + 1,) int32 start of each
    expert's run, on the card."""
    flat = slots.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    counts = torch.zeros(n_exp + 1, dtype=torch.int32, device=flat.device)
    counts.scatter_add_(0, flat.clamp(max=n_exp),
                        torch.ones_like(flat, dtype=torch.int32))
    offsets = torch.zeros(n_exp + 1, dtype=torch.int32, device=flat.device)
    offsets[1:] = torch.cumsum(counts[:n_exp], dim=0)
    return order, offsets


class Router:
    """Accumulates the routing counters on the card (`STAT_NAMES`), read
    once after the batch's last sync (`counts`)."""

    def __init__(self, device):
        self.stats = torch.zeros(len(STAT_NAMES), dtype=torch.int64,
                                 device=device)

    def add(self, slots: Tensor, cfg: UniMoEConfig) -> None:
        e = cfg.num_experts
        per_slot = torch.zeros(cfg.slots + 1, dtype=torch.int64,
                               device=slots.device)
        per_slot.scatter_add_(0, slots.reshape(-1),
                              torch.ones_like(slots.reshape(-1)))
        one = (slots[:, 1:] == cfg.slots).all(dim=-1).sum()
        self.stats[:e] += per_slot[:e]
        self.stats[e] += per_slot[e:cfg.slots].sum()
        self.stats[e + 1] += one
        self.stats[e + 2] += (per_slot[:e] > 0).sum()
        self.stats[e + 3] += slots.shape[0]

    def counts(self) -> dict:
        return dict(zip(STAT_NAMES, self.stats.tolist()))


def moe(p: dict, u: Tensor, cfg: UniMoEConfig,
        router: Optional[Router] = None):
    """The MoE FFN of normalised tokens u (N, D): (out (N, D), the routing's
    slots): the shared experts, plus each kept routed expert's output
    weighted by its p (K6 over the slots sorted by expert; sums in
    float32)."""
    slots, weights = route(p["router"]["w"], u, cfg)
    if router is not None:
        router.add(slots, cfg)
    order, offsets = dispatch(slots, cfg.num_experts)
    k = slots.shape[1]
    ex = p["experts"]
    ys = expert_swiglu(u.index_select(0, order // k), offsets,
                       ex["w_gate"], ex["w_up"], ex["w_down"])
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    y = ys.index_select(0, inv).view(u.shape[0], k, -1).float()
    out = _swiglu(p["shared"], u).float() + (y * weights[..., None]).sum(1)
    return out.to(u.dtype), slots


class Observer:
    """What a caller asks `OmniPipeline.generate` to keep of a call, on the
    card: each bucket's log-mel features (`mel`) and audio tokens
    (`audio`), every layer's routing slots of every token in the order
    the layers ran (`routes`: the prefill's layers over the packed tokens,
    then each step's over the rows), and the normalised hidden states of
    `rows` at each greedy pick (`hidden`)."""

    def __init__(self, rows: Sequence[int]):
        self.rows = list(rows)
        self.rows_t: Optional[Tensor] = None
        self.mel: List[Tensor] = []
        self.audio: List[Tensor] = []
        self.routes: List[Tensor] = []
        self.hidden: List[Tensor] = []

    def keep_hidden(self, hidden: Tensor) -> None:
        if self.rows_t is None:
            self.rows_t = to_device(self.rows, hidden.device)
        self.hidden.append(hidden.index_select(0, self.rows_t))

    def keep_route(self, slots: Tensor) -> None:
        self.routes.append(slots.to(torch.int8))


# ---------------------------------------------------------------------------
# attention and the cache
# ---------------------------------------------------------------------------


def init_cache(cfg: UniMoEConfig, batch: int, length: int, dtype,
               device) -> List[dict]:
    """Each layer's K and V, (B, num_kv_heads, length, head_dim)."""
    shape = (batch, cfg.num_kv_heads, length, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.num_layers)]


def _qkv(p: dict, u: Tensor, cos: Tensor, sin: Tensor, cfg: UniMoEConfig):
    n, hd = u.shape[0], cfg.head_dim
    q = nn.linear(p["q"], u).view(n, cfg.num_heads, hd)
    k = nn.linear(p["k"], u).view(n, cfg.num_kv_heads, hd)
    v = nn.linear(p["v"], u).view(n, cfg.num_kv_heads, hd)
    return rotate(q, cos, sin), rotate(k, cos, sin), v


@dataclass
class Packing:
    """Where the packed tokens of a right-padded (B, T) batch lie: `flat`
    (N,) b * T + t of each token, on the card; `lengths` the rows'
    lengths (host)."""
    lengths: List[int]
    width: int
    flat: Tensor

    @staticmethod
    def of(lengths: Sequence[int], device) -> "Packing":
        width = max(lengths)
        flat = [b * width + t for b, n in enumerate(lengths)
                for t in range(n)]
        return Packing(list(lengths), width, to_device(flat, device))

    def positions(self) -> Tensor:
        """(N,) each token's index in its row."""
        return self.flat % self.width


def to_device(values, device, dtype=torch.int64) -> Tensor:
    """A host list on `device` without a sync: through pinned memory,
    copied asynchronously on the current stream."""
    t = torch.tensor(values, dtype=dtype)
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _prefill_attention(p: dict, u: Tensor, cos, sin, pack: Packing,
                       cache: dict, cfg: UniMoEConfig) -> Tensor:
    b, t, hd = len(pack.lengths), pack.width, cfg.head_dim
    q, k, v = _qkv(p, u, cos, sin, cfg)

    def padded(x):          # (N, H, hd) -> (B, H, T, hd)
        out = x.new_zeros((b * t,) + tuple(x.shape[1:]))
        out.index_copy_(0, pack.flat, x)
        return out.view(b, t, x.shape[1], hd).transpose(1, 2)

    kp, vp = padded(k), padded(v)
    cache["k"][:, :, :t] = kp
    cache["v"][:, :, :t] = vp
    rep = cfg.num_heads // cfg.num_kv_heads
    o = flash_attention(padded(q).contiguous(),
                        kp.repeat_interleave(rep, dim=1),
                        vp.repeat_interleave(rep, dim=1), causal=True)
    o = o.transpose(1, 2).reshape(b * t, cfg.hidden_size)
    return nn.linear(p["o"], o.index_select(0, pack.flat))


def _step_attention(p: dict, u: Tensor, cos, sin, pos: Tensor, cache: dict,
                    cfg: UniMoEConfig) -> Tensor:
    """One token a row: writes column pos[b] of row b's cache, attends over
    columns 0..pos[b]."""
    b, hd = u.shape[0], cfg.head_dim
    g = cfg.num_kv_heads
    q, k, v = _qkv(p, u, cos, sin, cfg)
    rows = torch.arange(b, device=u.device)[:, None]
    heads = torch.arange(g, device=u.device)[None, :]
    cache["k"][rows, heads, pos[:, None]] = k
    cache["v"][rows, heads, pos[:, None]] = v
    q = q.view(b, g, cfg.num_heads // g, hd)
    s = torch.matmul(q, cache["k"].transpose(-1, -2)).float() \
        / math.sqrt(hd)                                   # (B, g, rep, T)
    cols = torch.arange(s.shape[-1], device=u.device)
    s = s.masked_fill((cols[None, :] > pos[:, None])[:, None, None], NEG_INF)
    o = torch.matmul(torch.softmax(s, dim=-1).to(u.dtype), cache["v"])
    return nn.linear(p["o"], o.reshape(b, cfg.hidden_size))


def _layer(lp: dict, x: Tensor, attend, cfg: UniMoEConfig,
           router: Optional[Router], observer: Optional[Observer]) -> Tensor:
    x = x + attend(lp["attn"], rms_norm(lp["attn_norm"], x, cfg.rms_norm_eps))
    with tracing.span("moe", device=x.device):
        out, slots = moe(lp["moe"], rms_norm(lp["moe_norm"], x,
                                             cfg.rms_norm_eps), cfg, router)
    if observer is not None:
        observer.keep_route(slots)
    return x + out


def prefill(params: dict, cfg: UniMoEConfig, embeds: Tensor, pack: Packing,
            cache: List[dict], router: Optional[Router] = None,
            observer: Optional[Observer] = None) -> Tensor:
    """The packed embeddings (N, D) of right-padded rows through every
    layer, their K/V into `cache`; returns each row's last position's
    normalised hidden state (B, D)."""
    x = _stack(params, cfg, embeds, pack, cache, router, observer)
    ends = torch.cumsum(to_device(pack.lengths, x.device), 0) - 1
    return rms_norm(params["norm"], x.index_select(0, ends), cfg.rms_norm_eps)


def _stack(params, cfg, embeds, pack, cache, router, observer=None):
    pos = pack.positions()
    cos, sin = mrope(torch.stack([pos, pos, pos]), cfg)
    x = embeds
    for lp, c in zip(params["layers"], cache):
        x = _layer(lp, x, lambda ap, u: _prefill_attention(
            ap, u, cos, sin, pack, c, cfg), cfg, router, observer)
    return x


def decode_step(params: dict, cfg: UniMoEConfig, tokens: Tensor,
                pos: Tensor, cache: List[dict],
                router: Optional[Router] = None,
                observer: Optional[Observer] = None) -> Tensor:
    """One cached step, eagerly: tokens (B,) at positions pos (B,) -> the
    normalised hidden states (B, D)."""
    x = params["embed"]["table"].index_select(0, tokens.long())
    cos, sin = mrope(torch.stack([pos, pos, pos]), cfg)
    for lp, c in zip(params["layers"], cache):
        x = _layer(lp, x, lambda ap, u: _step_attention(
            ap, u, cos, sin, pos, c, cfg), cfg, router, observer)
    return rms_norm(params["norm"], x, cfg.rms_norm_eps)


class StepGraphs:
    """The decode step on the card, captured once per (rows, cache length,
    counted) in CUDA graphs over static buffers: the token and position
    of each row (`tok`, `pos`), the K/V cache (`cache`, which the prefill
    fills), the routing counters (`router`, when `counted`). One graph a
    part, in order: each layer's attention (the first also embeds the
    tokens and makes the M-RoPE tables), each layer's MoE FFN, then the
    head (the final norm, K2's pick into `tok`, pos + 1). A replay is one
    launch a part, 2 L + 1 a step in place of some hundred a layer, so the
    card and not the host paces the loop; each MoE replay is a `moe` span
    (CUDA events) while the recorder is on.

    Every part runs once eagerly on a side stream (torch's and cuBLAS's
    warm-up), then is captured there into one shared memory pool, in the
    order it replays. Kernel launches the captures record (`_build.tally`)
    are added to `_build.STATS` at each replay."""

    def __init__(self, params: dict, cfg: UniMoEConfig, table: Tensor,
                 add: Tensor, batch: int, length: int, dtype, device,
                 counted: bool):
        self.device = torch.device(device)
        self.cache = init_cache(cfg, batch, length, dtype, device)
        self.tok = torch.zeros(batch, dtype=torch.int32, device=device)
        self.pos = torch.zeros(batch, dtype=torch.int64, device=device)
        self.router = Router(device) if counted else None
        self.slots: List[Tensor] = [None] * cfg.num_layers
        parts = self._parts(params, cfg, table, add)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _, fn in parts:
                fn()
        self.xs = []
        self.graphs = []
        pool = torch.cuda.graph_pool_handle()
        with _build.tally() as counts:
            for kind, fn in parts:
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g, pool=pool, stream=side):
                    fn()
                self.graphs.append((kind, g))
        torch.cuda.current_stream(self.device).wait_stream(side)
        self.counts = {k: (v.launches, v.plain_cuda_calls)
                       for k, v in counts.items()}

    def _parts(self, p: dict, cfg: UniMoEConfig, table: Tensor, add: Tensor):
        eps = cfg.rms_norm_eps
        self.xs = []

        def attention(i):
            def run():
                lp = p["layers"][i]
                if i == 0:
                    self.cos, self.sin = mrope(
                        torch.stack([self.pos, self.pos, self.pos]), cfg)
                    x = p["embed"]["table"].index_select(0, self.tok.long())
                else:
                    x = self.xs[-1]
                self.xs.append(x + _step_attention(
                    lp["attn"], rms_norm(lp["attn_norm"], x, eps), self.cos,
                    self.sin, self.pos, self.cache[i], cfg))
            return run

        def ffn(i):
            def run():
                lp, x = p["layers"][i], self.xs[-1]
                out, self.slots[i] = moe(lp["moe"], rms_norm(
                    lp["moe_norm"], x, eps), cfg, self.router)
                self.xs.append(x + out)
            return run

        def head():
            self.hidden = rms_norm(p["norm"], self.xs[-1], eps)
            self.tok.copy_(fused_greedy_step(self.hidden, table, add))
            self.pos.add_(1)

        parts = []
        for i in range(cfg.num_layers):
            parts += [("attention", attention(i)), ("moe", ffn(i))]
        return parts + [("head", head)]

    def replay(self, observer: Optional[Observer] = None) -> Tensor:
        """One step from `tok` at `pos` (both advanced in place): returns
        `tok`, the new ids."""
        spanned = tracing.enabled()
        for kind, g in self.graphs:
            if spanned and kind == "moe":
                with tracing.span("moe", device=self.device):
                    g.replay()
            else:
                g.replay()
        for name, (launches, plain) in self.counts.items():
            _build.STATS[name].launches += launches
            _build.STATS[name].plain_cuda_calls += plain
        if observer is not None:
            for slots in self.slots:
                observer.keep_route(slots)
            observer.keep_hidden(self.hidden)
        return self.tok


# ---------------------------------------------------------------------------
# the head and the greedy pick
# ---------------------------------------------------------------------------


def prepare_head(params: dict, cfg: UniMoEConfig):
    """(table_t (D, V_pad), add (1, V_pad) float32): the head transposed
    and padded for K2, NEG_INF on the padded ids."""
    w = params["head"]["w"]
    v_pad = pad_vocab(cfg.vocab_size)
    table = torch.zeros((cfg.hidden_size, v_pad), dtype=w.dtype,
                        device=w.device)
    table[:, :cfg.vocab_size] = w.t()
    add = torch.zeros((1, v_pad), dtype=torch.float32, device=w.device)
    add[:, cfg.vocab_size:] = NEG_INF
    return table, add


def logits(hidden: Tensor, table_t: Tensor, vocab: int) -> Tensor:
    """(B, V) float32 logits of normalised hidden states, the products in
    the hidden states' dtype (for the check, off the served path)."""
    return (hidden @ table_t[:, :vocab]).float()


# ---------------------------------------------------------------------------
# audio
# ---------------------------------------------------------------------------


def audio_embeddings(params: dict, cfg: OmniConfig, mel: Tensor) -> Tensor:
    """Log-mel windows (W, T_mel, n_mels) -> (W, audio_tokens, D) in mel's
    dtype: the whisper encoder, pooled over time, projected."""
    enc = wm.encode(params["whisper"], cfg.whisper, mel,      # (W, 1500, Dw)
                    attn_impl=wm.resolve_encoder_attn(mel.device, mel.dtype))
    pooled = F.adaptive_avg_pool1d(enc.float().transpose(1, 2),
                                   cfg.audio_tokens).transpose(1, 2)
    return nn.linear(params["connector"], pooled.to(enc.dtype))
