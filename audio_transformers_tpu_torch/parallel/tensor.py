"""Tensor parallelism: the layout over the mesh's "model" axis and the
collectives that GSPMD inserts for it in the reference, written out.

The reference shards its parameters with PartitionSpecs
(`audio_transformers_tpu/models/whisper/model.py:param_axes`,
`parallel/mesh.py:shard_params`) and lets XLA place the collectives. The
port runs one process per device, each holding its shards
(`shard_params`, by a tree of `Split`s from the model's `param_axes`),
and calls them itself, Megatron-style:

  - `copy_to_model`: identity forward, all-reduce backward; it stands
    before each column-parallel projection (q/k/v, fc1, the tied vocab
    projection), whose input gradient is a partial sum on each rank;
  - `reduce_from_model`: all-reduce forward, identity backward; it
    follows each row-parallel projection (o, fc2), whose output is a
    partial sum on each rank;
  - `gather_vocab`: the vocab-sharded logits gathered along the last
    dim; its backward keeps this rank's slice and reduces nothing (the
    decodes' sampling fallback and beams);
  - `vocab_parallel_cross_entropy`: the cross-entropy of vocab-sharded
    logits from three all-reduces of one float a row (the max, the sum
    of exponentials, the target's logit), whose backward makes no
    collective: the train and eval steps never gather B x T x V logits,
    as XLA partitions the reference's softmax cross-entropy over the
    embedding's vocab shards.

`ops.nn.row_linear` and `ops.nn.embedding_lookup` take a model group
and use them.

`torch.distributed.nn.functional.all_reduce` is not used here: its
backward sums the gradients over the ranks, which would multiply every
replicated parameter's gradient by the model axis's size.

Every collective runs in float32 (bf16 activations are cast for it and
back), and on every rank of the model group in the same order. A model
group of None (model axis 1) makes each of them the identity.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from audio_transformers_tpu_torch.ops.decode_logits import pad_vocab

# the vocab shards are cut on multiples of this: the float32 K2 route's
# tile (the bf16 route's 16-id units divide it)
VOCAB_ALIGN = 256


class Split(NamedTuple):
    """A leaf cut into the model axis's size of equal pieces along `dim`.
    With `padded`, the length cut is `padded` (the vocab padded for the
    greedy kernel): the pieces past the leaf's end are short or empty."""
    dim: int
    padded: Optional[int] = None


def model_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def model_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def piece(group, dim: int):
    """(dim, model size, model rank) of a model `group`, the `shard` of
    `ops.nn.dropout` for a tensor cut along `dim` over the group; None
    without a group."""
    return None if group is None else (dim, model_size(group),
                                       model_rank(group))


def vocab_shard(vocab: int, t: int, r: int) -> Tuple[int, int, int]:
    """(start, stop, width) of rank r's ids of a vocab cut over t ranks on
    the padded boundary: width = pad_vocab(vocab) / t ids a rank, the
    rows [start, stop) real (the last rank's run is short)."""
    padded = pad_vocab(vocab)
    if padded % (t * VOCAB_ALIGN):
        raise ValueError(f"padded vocab {padded} does not split into {t} "
                         f"shards of a multiple of {VOCAB_ALIGN} ids")
    width = padded // t
    start = min(r * width, vocab)
    return start, min(start + width, vocab), width


def _bounds(split: Split, length: int, t: int, r: int) -> Tuple[int, int]:
    full = split.padded or length
    if full % t:
        raise ValueError(f"length {full} does not split into {t} shards")
    piece = full // t
    start = min(r * piece, length)
    return start, min(start + piece, length)


def _walk(tree, axes, fn):
    """fn(leaf, split or None) over the leaves of `tree`, with `axes` a
    tree of the same structure."""
    if isinstance(tree, dict):
        return {k: _walk(v, axes[k], fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, a, fn) for v, a in zip(tree, axes)]
    return fn(tree, axes)



def shard_params(params, t: int, r: int, axes):
    """Rank r's shards of the full tree `params` on a model axis of t:
    each leaf with a `Split` in `axes` cut along its dim (a contiguous
    copy), every other leaf as it is."""
    def cut(x, split):
        if split is None or t == 1:
            return x
        start, stop = _bounds(split, x.shape[split.dim], t, r)
        return x.narrow(split.dim, start, stop - start).contiguous()
    return _walk(params, axes, cut)


def gather_params(params, group, axes):
    """The full tree from every rank's shards (`shard_params`'s inverse),
    detached, on every rank of the model `group`."""
    t = model_size(group)

    def join(x, split):
        if split is None or t == 1:
            return x.detach()
        piece = (split.padded or 0) // t or x.shape[split.dim]
        pad = [0, 0] * x.dim()
        pad[2 * (x.dim() - 1 - split.dim) + 1] = piece - x.shape[split.dim]
        parts = all_gather(torch.nn.functional.pad(x.detach(), pad), group)
        # every rank's real length along dim
        ns = all_gather(torch.tensor([x.shape[split.dim]], device=x.device),
                        group)
        return torch.cat([p.narrow(split.dim, 0, int(k))
                          for p, k in zip(parts, ns)], dim=split.dim)
    return _walk(params, axes, join)


def split_leaves(axes) -> list:
    """The `Split` (or None) of every leaf of an axes tree, in the order of
    `core.params.leaves_with_path` over the parameters."""
    if isinstance(axes, dict):
        return [x for v in axes.values() for x in split_leaves(v)]
    if isinstance(axes, list):
        return [x for v in axes for x in split_leaves(v)]
    return [axes]


def all_gather(x: torch.Tensor, group) -> list:
    """Every rank's `x` (equal shapes) in group-rank order. gloo gathers
    host tensors only: a CUDA tensor goes through a host copy there (the
    one-card runs of several ranks); NCCL gathers it in place."""
    t = model_size(group)
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return [p.to(x.device) for p in all_gather(x.cpu(), group)]
    parts = [torch.empty_like(x) for _ in range(t)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


def _all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    y = x.float().clone()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherVocab(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, vocab):
        t, r = model_size(group), model_rank(group)
        start, stop, width = vocab_shard(vocab, t, r)
        ctx.rank_slice = (start, stop)
        parts = all_gather(
            torch.nn.functional.pad(x, (0, width - x.shape[-1])), group)
        return torch.cat(parts, dim=-1)[..., :vocab]

    @staticmethod
    def backward(ctx, g):
        start, stop = ctx.rank_slice
        return g[..., start:stop], None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """x as it is; in the backward its gradient summed over the model
    group (the input of a column-parallel projection)."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over the model group (the partial output of a
    row-parallel projection); the gradient passes through unchanged."""
    return x if group is None else _ReduceFromModel.apply(x, group)


def gather_vocab(x: torch.Tensor, group, vocab: int) -> torch.Tensor:
    """(..., V_local) logits of each rank's vocab shard -> (..., vocab),
    the same on every rank; the backward keeps this rank's slice."""
    return x if group is None else _GatherVocab.apply(x, group, vocab)



class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, group, v0, vocab):
        # this rank's real ids are [v0, v0 + n): columns past n (the
        # padded vocab's tail) enter neither the max nor the sum
        n = max(min(logits.shape[-1], vocab - v0), 0)
        x = logits[..., :n].float()
        m = (x.amax(dim=-1) if n else
             torch.full(x.shape[:-1], float("-inf"), device=x.device))
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(x - m[..., None])
        s = e.sum(dim=-1)
        dist.all_reduce(s, group=group)
        local = targets.long() - v0
        hit = (local >= 0) & (local < n)
        idx = local.clamp(0, max(n - 1, 0))[..., None]
        t = (torch.where(hit, x.gather(-1, idx)[..., 0], 0.0) if n
             else torch.zeros_like(m))
        dist.all_reduce(t, group=group)
        e /= s[..., None]                        # this rank's softmax
        ctx.save_for_backward(e, idx, hit)
        ctx.width = logits.shape[-1]
        ctx.dtype = logits.dtype
        return torch.log(s) + m - t

    @staticmethod
    def backward(ctx, g):
        p, idx, hit = ctx.saved_tensors
        if p.shape[-1]:
            p = p.scatter_add(-1, idx, -hit[..., None].to(p.dtype))
        grad = p * g[..., None]
        grad = torch.nn.functional.pad(grad, (0, ctx.width - grad.shape[-1]))
        return grad.to(ctx.dtype), None, None, None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                                 group, v0: int, vocab: int) -> torch.Tensor:
    """Per-token cross-entropy (...,) float32 of logits cut over the vocab:
    `logits` (..., V_local) are this rank's ids [v0, v0 + V_local) of a
    `vocab`-id vocabulary (ids past `vocab` ignored), `targets` (...,)
    global ids. The forward all-reduces, over the model `group`, each
    row's max (MAX), its sum of exp(l - max) and the target's logit
    (SUM; 0 on every rank but the one that holds the id); the backward,
    softmax - onehot on this rank's ids times the upstream gradient,
    makes no collective. The same values as F.cross_entropy of the
    gathered logits, up to sum order."""
    return _VocabParallelCE.apply(logits, targets, group, v0, vocab)
