"""Plain Uni-MoE-2.0-Omni speech understanding in float32 PyTorch: the
yardstick the port's `models/unimoe` is held to. It imports nothing of
the port (nor JAX) and turns TF32 off (`exact_float32`).

Written from the published description (huggingface.co/HIT-TMG/
Uni-MoE-2.0-Omni, config.json: `model_type` grin_qwen2_vl) one row at a
time, with no cache, batching or kernels:

- whisper encoder: conv1d(k3, p1) GELU, conv1d(k3, s2, p1) GELU, the
  sinusoidal positions, pre-LN blocks (multi-head attention with q, v, o
  biases and none on k; GELU MLP), a final LayerNorm (eps 1e-5);
- the audio connector (assumed): adaptive average pooling over time to
  `audio_tokens` frames, then a linear projector with bias;
- the language model, a Qwen2 decoder: RMSNorm (eps 1e-6), GQA with q/k/v
  biases (assumed, the Qwen2 convention), M-RoPE as Qwen2-VL writes it
  (the frequencies of the t, h and w position rows concatenated twice
  and cut by `mrope_section` doubled, chunk i taking row i % 3;
  rotate-half), causal softmax attention at scale 1/sqrt(head_dim);
- the dynamic-capacity MoE FFN: p = softmax(float32(u) Wg) over the routed
  experts and the null slot; sorted in descending order; the fewest
  leading slots whose sum reaches top_p, at most top_k, kept;
  out = the shared experts (not gated, assumed) + p_e E_e(u) over the
  kept routed experts (p not renormalised, assumed), E(u) =
  Wdown(silu(Wgate u) * Wup u); the null expert adds nothing;
- the final RMSNorm and the untied head.

Weights are a flat {name: float32 tensor}; names are the port's tree
paths joined by "." (`whisper.encoder.blocks.0.self_attn.q.w`,
`llm.layers.0.moe.experts.w_gate`, ...). The sizes come from a `dims`
object with the attributes `Dims` lists.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


@dataclass(frozen=True)
class Dims:
    """The sizes the reference reads."""
    hidden: int
    layers: int
    heads: int
    kv_heads: int
    rope_theta: float
    mrope_section: Tuple[int, ...]
    eps: float
    experts: int
    null_experts: int
    top_p: float
    top_k: int
    vocab: int
    enc_d: int
    enc_layers: int
    enc_heads: int
    audio_tokens: int
    n_mels: int = 128
    sample_rate: int = 16000
    n_fft: int = 400
    hop: int = 160

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matrix products and convolutions, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class Omni:
    """The reference over weights from `w(name)` (a dict's `__getitem__`,
    or a function that makes a tensor on demand)."""

    def __init__(self, dims: Dims, w: Callable[[str], Tensor]):
        self.dims = dims
        self.w = w

    # -- primitives ---------------------------------------------------------

    def q(self, x: Tensor) -> Tensor:
        """The operand of a product as it is multiplied (float32 here)."""
        return x

    def mm(self, a: Tensor, b: Tensor) -> Tensor:
        return torch.matmul(self.q(a), self.q(b))

    def linear(self, p: str, x: Tensor, bias: bool = True) -> Tensor:
        y = self.mm(x, self.w(p + ".w").t())
        return y + self.w(p + ".b") if bias else y

    def rms(self, p: str, x: Tensor) -> Tensor:
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                               + self.dims.eps) * self.w(p + ".scale")

    def ln(self, p: str, x: Tensor) -> Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.w(p + ".scale"),
                            self.w(p + ".bias"), 1e-5)

    # -- the whisper encoder ------------------------------------------------

    def conv(self, p: str, x: Tensor, stride: int) -> Tensor:
        y = F.conv1d(self.q(x.transpose(1, 2)), self.q(self.w(p + ".w")),
                     self.w(p + ".b"), stride=stride, padding=1)
        return y.transpose(1, 2)

    def encode(self, mel: Tensor) -> Tensor:
        """(W, T_mel, n_mels) -> (W, T_mel // 2, enc_d)."""
        d = self.dims
        pre = "whisper.encoder"
        x = F.gelu(self.conv(f"{pre}.conv1", mel, 1))
        x = F.gelu(self.conv(f"{pre}.conv2", x, 2))
        x = x + self.w(f"{pre}.pos")[: x.shape[1]]
        h, hd = d.enc_heads, d.enc_d // d.enc_heads
        for i in range(d.enc_layers):
            p = f"{pre}.blocks.{i}"
            u = self.ln(f"{p}.self_ln", x)
            b, t, _ = u.shape

            def heads(name, bias=True):
                return self.linear(f"{p}.self_attn.{name}", u, bias).view(
                    b, t, h, hd).transpose(1, 2)
            qh, kh, vh = heads("q"), heads("k", False), heads("v")
            s = self.mm(qh, kh.transpose(-1, -2)) / math.sqrt(hd)
            o = self.mm(torch.softmax(s, -1), vh).transpose(1, 2).reshape(
                b, t, d.enc_d)
            x = x + self.linear(f"{p}.self_attn.o", o)
            u = self.ln(f"{p}.mlp_ln", x)
            x = x + self.linear(f"{p}.fc2", F.gelu(self.linear(f"{p}.fc1", u)))
        return self.ln(f"{pre}.ln", x)

    def audio_tokens(self, enc: Tensor) -> Tensor:
        """(W, T, enc_d) -> (W, audio_tokens, hidden)."""
        pooled = F.adaptive_avg_pool1d(enc.transpose(1, 2),
                                       self.dims.audio_tokens).transpose(1, 2)
        return self.linear("connector", pooled)

    # -- the language model -------------------------------------------------

    def rope(self, positions: Tensor) -> Tuple[Tensor, Tensor]:
        """Qwen2-VL's M-RoPE tables (T, head_dim) for positions (3, T)."""
        d = self.dims
        hd = d.head_dim
        inv = 1.0 / (d.rope_theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                                   device=positions.device)
                                      / hd))
        freqs = positions.double()[..., None] * inv          # (3, T, hd/2)
        emb = torch.cat([freqs, freqs], dim=-1)             # (3, T, hd)
        chunks = emb.split(list(d.mrope_section) * 2, dim=-1)
        emb = torch.cat([c[i % 3] for i, c in enumerate(chunks)], dim=-1)
        return emb.cos().float(), emb.sin().float()

    @staticmethod
    def rotate(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
        """x (T, H, hd)."""
        half = x.shape[-1] // 2
        rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
        return x * cos[:, None] + rot * sin[:, None]

    def attention(self, p: str, u: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
        d = self.dims
        t, hd = u.shape[0], d.head_dim
        q = self.rotate(self.linear(f"{p}.q", u).view(t, d.heads, hd), cos, sin)
        k = self.rotate(self.linear(f"{p}.k", u).view(t, d.kv_heads, hd),
                        cos, sin)
        v = self.linear(f"{p}.v", u).view(t, d.kv_heads, hd)
        rep = d.heads // d.kv_heads
        k = k.repeat_interleave(rep, dim=1).transpose(0, 1)
        v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
        s = self.mm(q.transpose(0, 1), k.transpose(-1, -2)) / math.sqrt(hd)
        keep = torch.ones(t, t, dtype=torch.bool, device=u.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
        o = self.mm(torch.softmax(s, -1), v).transpose(0, 1).reshape(t, -1)
        return self.linear(f"{p}.o", o, bias=False)

    def route(self, p: str, u: Tensor) -> Tuple[Tensor, Tensor]:
        """(kept (T, top_k) slot ids, -1 where not kept; p (T, slots))."""
        d = self.dims
        probs = torch.softmax(self.mm(u, self.w(f"{p}.router.w").t()), -1)
        top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        top, idx = top[:, :d.top_k], idx[:, :d.top_k]
        before = torch.cumsum(top, dim=-1) - top
        kept = torch.where(before < d.top_p, idx, -1)
        return kept, probs

    def swiglu(self, gate: Tensor, up: Tensor, down: Tensor,
               u: Tensor) -> Tensor:
        return self.mm(F.silu(self.mm(u, gate.t())) * self.mm(u, up.t()),
                       down.t())

    def moe(self, p: str, u: Tensor, shared: bool = True
            ) -> Tuple[Tensor, Tensor]:
        """(out (T, hidden), kept slots (T, top_k))."""
        d = self.dims
        kept, probs = self.route(p, u)
        out = torch.zeros_like(u)
        if shared:
            gate, up = self.w(f"{p}.shared.w_gate"), self.w(f"{p}.shared.w_up")
            down = self.w(f"{p}.shared.w_down")
            width = gate.shape[0] // 2
            for j in range(2):
                cols = slice(j * width, (j + 1) * width)
                out = out + self.swiglu(gate[cols], up[cols], down[:, cols], u)
        gate, up = self.w(f"{p}.experts.w_gate"), self.w(f"{p}.experts.w_up")
        down = self.w(f"{p}.experts.w_down")
        for e in range(d.experts):
            rows = (kept == e).any(dim=-1)
            if rows.any():
                y = self.swiglu(gate[e], up[e], down[e], u[rows])
                out[rows] = out[rows] + probs[rows, e:e + 1] * y
        return out, kept

    def layer(self, i: int, x: Tensor, cos: Tensor, sin: Tensor
              ) -> Tuple[Tensor, Tensor]:
        p = f"llm.layers.{i}"
        x = x + self.attention(f"{p}.attn", self.rms(f"{p}.attn_norm", x),
                               cos, sin)
        out, kept = self.moe(f"{p}.moe", self.rms(f"{p}.moe_norm", x))
        return x + out, kept

    def embed(self, ids: Sequence[int], audio: Tensor, after: int) -> Tensor:
        """A row's input: its first `after` ids, the audio tokens
        (n, hidden), the rest."""
        table = self.w("llm.embed.table")
        ids = torch.tensor(list(ids), device=audio.device)
        return torch.cat([table[ids[:after]], audio, table[ids[after:]]])

    def forward(self, x: Tensor) -> Tuple[Tensor, List[Tensor]]:
        """One row's embeddings (T, hidden) -> (logits (T, vocab), each
        layer's kept slots (T, top_k)), positions t = h = w = index."""
        pos = torch.arange(x.shape[0], device=x.device)
        cos, sin = self.rope(torch.stack([pos, pos, pos]))
        routes = []
        for i in range(self.dims.layers):
            x, kept = self.layer(i, x, cos, sin)
            routes.append(kept)
        return self.logits(x), routes

    def logits(self, x: Tensor) -> Tensor:
        return self.mm(self.rms("llm.norm", x), self.w("llm.head.w").t())


def slot_sets(kept: Tensor) -> List[frozenset]:
    """Each token's set of kept slots."""
    return [frozenset(s for s in row if s >= 0) for row in kept.tolist()]


def from_dict(weights: Dict[str, Tensor]) -> Callable[[str], Tensor]:
    return weights.__getitem__
