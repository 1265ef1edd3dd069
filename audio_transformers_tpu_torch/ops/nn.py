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
import torch.distributed as dist
import torch.nn.functional as F

from audio_transformers_tpu_torch.parallel import tensor as tp

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


def row_linear(params: dict, x: Tensor, group=None) -> Tensor:
    """`linear` whose weight is cut along its input over a model `group`
    (tensor parallelism: x holds this rank's features): the partial
    products summed over the group, then the bias, added once. `linear`
    itself without a group."""
    if group is None:
        return linear(params, x)
    y = tp.reduce_from_model(F.linear(x, params["w"].to(x.dtype)).float(),
                          group)
    if "b" in params:
        y = y + params["b"].float()
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


def batch_norm(params: dict, state: dict, x: Tensor, *, training: bool,
               momentum: float = 0.1, eps: float = 1e-5,
               group=None) -> tuple:
    """x (B, T, C) normalised per channel over (B, T) in float32: torch
    BatchNorm1d's semantics, channels-last. In training the batch's
    statistics normalise and the running ones move by `momentum` (the
    variance with the unbiased n / (n - 1) correction); otherwise the
    running ones normalise. Returns (y in x's dtype, new state); the new
    state holds no gradient.

    With a process `group` (data parallelism) the batch is the global
    one: the mean, then the mean of squared deviations from it, each
    summed over the ranks by a differentiable all-reduce, so values and
    gradients are those of one BatchNorm over every rank's rows (as
    GSPMD computes the reference's over a sharded batch), and n counts
    every rank's rows."""
    xf = x.float()
    if training:
        n = x.shape[0] * x.shape[1]
        if group is not None:
            n *= dist.get_world_size(group)
        mean = _group_sum(xf.sum(dim=(0, 1)), group) / n
        var = _group_sum((xf - mean).square().sum(dim=(0, 1)), group) / n
        with torch.no_grad():
            unbiased = var * (n / max(n - 1, 1))
            new_state = {
                "mean": (1 - momentum) * state["mean"] + momentum * mean,
                "var": (1 - momentum) * state["var"] + momentum * unbiased,
            }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype), new_state


def _group_sum(t: Tensor, group) -> Tensor:
    """t summed over the ranks of `group` (autograd flows back through the
    all-reduce); t itself without one."""
    if group is None:
        return t
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(t, group=group)


def group_norm(params: dict, x: Tensor, *, num_groups: int = 32,
               eps: float = 1e-5) -> Tensor:
    """x (B, T, C) normalised per sample over (T, C // g) in each of g
    channel groups, float32; no running state."""
    b, t, c = x.shape
    g = min(num_groups, c)
    xf = x.float().reshape(b, t, g, c // g)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, t, c)
    return (y * params["scale"] + params["bias"]).to(x.dtype)


class RowShard:
    """A random stream split by rows over data-parallel ranks: each draw
    is made from `generator` for the global batch (`world` times this
    rank's rows) and this rank's contiguous rows are kept, so the values
    a row gets do not depend on how many ranks share the batch."""

    def __init__(self, generator: torch.Generator, rank: int, world: int):
        self.generator, self.rank, self.world = generator, rank, world

    @property
    def device(self) -> torch.device:
        return self.generator.device


def draw(fn, generator, *args, shape, device) -> Tensor:
    """fn(*args, shape, generator=, device=) (torch.rand, torch.randint)
    from a torch.Generator, or this rank's rows of the global draw from a
    `RowShard`; the batch is dim 0 of `shape`."""
    if isinstance(generator, RowShard):
        b = shape[0]
        full = fn(*args, (b * generator.world, *shape[1:]),
                  generator=generator.generator, device=device)
        return full[generator.rank * b:(generator.rank + 1) * b]
    return fn(*args, shape, generator=generator, device=device)


def dropout(generator: Optional[torch.Generator], x: Tensor, rate: float,
            *, training: bool, shard=None) -> Tensor:
    """Inverted dropout: each element kept with probability 1 - rate (a
    uniform draw from `generator` below it) and scaled by 1 / (1 - rate).
    The identity when not training, at rate 0 or without a generator. The
    generator (or `RowShard`) must live on x's device.

    `shard` = (dim, t, r) says that x is piece r of t equal pieces along
    `dim` (not 0) of the whole tensor, a model rank's heads or hidden
    units: the mask is drawn for the whole tensor and piece r kept, so
    the ranks of a model axis together draw what one process draws."""
    if not training or rate <= 0.0 or generator is None:
        return x
    shape = list(x.shape)
    if shard is not None:
        dim, t, r = shard
        shape[dim] *= t
    keep = draw(torch.rand, generator, shape=tuple(shape),
                device=x.device) < 1.0 - rate
    if shard is not None:
        keep = keep.narrow(dim, r * x.shape[dim], x.shape[dim])
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def embedding_lookup(params: dict, ids: Tensor, group=None,
                     vocab: Optional[int] = None) -> Tensor:
    """Rows `ids` of params["table"]. Under a model `group` the table is
    this rank's rows of a `vocab`-id embedding cut on the padded vocab
    (`parallel.tensor.vocab_shard`): each rank looks up the ids it holds,
    zero elsewhere, and the all-reduce sums the one nonzero term of each
    (exact)."""
    table = params["table"]
    if group is None:
        return table[ids]
    start, stop, _ = tp.vocab_shard(vocab, tp.model_size(group),
                                    tp.model_rank(group))
    local = ids - start
    hit = (local >= 0) & (local < stop - start)
    rows = table[local.clamp(0, max(stop - start - 1, 0))]
    return tp.reduce_from_model(
        torch.where(hit[..., None], rows, torch.zeros_like(rows)), group)


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


def sinusoidal_embeddings_ref(length: int, dim: int,
                              max_timescale: float = 10000.0) -> Tensor:
    """The UrbanSound classifier's sinusoids: concat(sin, cos), with the
    frequency denominator `half` where whisper's has `half - 1`."""
    half = dim // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32)
                      * (math.log(max_timescale) / half))
    args = torch.arange(length, dtype=torch.float32)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def causal_mask(t: int, device=None) -> Tensor:
    """(1, 1, t, t) True on and below the diagonal."""
    return torch.ones((t, t), dtype=torch.bool,
                      device=device).tril()[None, None]


def multihead_attention(params: dict, q_in: Tensor, kv_in: Tensor, *,
                        num_heads: int, mask: Optional[Tensor] = None,
                        impl: str = "xla", causal: bool = False,
                        dropout_rate: float = 0.0,
                        generator: Optional[torch.Generator] = None,
                        group=None) -> Tensor:
    """Self- or cross-attention, q_in (B, Tq, D), kv_in (B, Tk, D).

    impl="xla" is matmul + float32 softmax (the reference's XLA
    formulation), with `mask` (broadcastable to (B, H, Tq, Tk), True =
    keep) or `causal`, and dropout of the attention probabilities at
    `dropout_rate` when a generator is given (torch MultiheadAttention's
    semantics; under a model group drawn for every head and cut to this
    rank's). impl="flash" projects straight to the head-major
    (B, H, T, hd) layout and runs the flash-attention kernels
    (`ops.attention.flash_attention`, forward and backward); it takes no
    mask beyond `causal`.

    With a model `group` (tensor parallelism) the projections are this
    rank's shards: q/k/v hold its num_heads / t heads (the head width
    comes from them) and o its input columns, so the o projection's
    partial sums are all-reduced before its bias (`row_linear`)."""
    b, tq, _ = q_in.shape
    if group is not None:
        num_heads //= tp.model_size(group)
        self_attn = kv_in is q_in
        q_in = tp.copy_to_model(q_in, group)
        kv_in = q_in if self_attn else tp.copy_to_model(kv_in, group)
    d = params["q"]["w"].shape[0]       # this rank's heads x head width
    hd = d // num_heads

    def heads(lin, x):   # (B, T, D) -> (B, H, T, hd)
        return linear(lin, x).reshape(b, -1, num_heads, hd).transpose(1, 2)

    q, k, v = (heads(params["q"], q_in), heads(params["k"], kv_in),
               heads(params["v"], kv_in))
    if impl == "flash":
        if mask is not None or (dropout_rate > 0.0 and generator is not None):
            raise NotImplementedError(
                "flash path supports only causal masking and no dropout; "
                "pass impl='xla' for arbitrary masks or dropout")
        from audio_transformers_tpu_torch.ops.attention import \
            flash_attention
        out = flash_attention(q, k, v, causal=causal)     # (B, H, Tq, hd)
        return row_linear(params["o"], out.transpose(1, 2).reshape(b, tq, d),
                          group)
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
    if dropout_rate > 0.0 and generator is not None:
        # under a model group: the mask of every head, this rank's kept
        probs = dropout(generator, probs, dropout_rate, training=True,
                        shard=tp.piece(group, 1))
    out = torch.matmul(probs.to(v.dtype), v)              # (B, H, Tq, hd)
    return row_linear(params["o"], out.transpose(1, 2).reshape(b, tq, d),
                      group)
