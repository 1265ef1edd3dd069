"""UrbanSound8K classifier: conv front end -> pre-LN encoder -> CNN head.

The reference's `audio_transformers_tpu/models/urbansound/model.py` on
PyTorch tensors, channels-last (B, T, C) throughout:

  - two conv1d over the mel bins (padding conv_kernel // 2, stride 2 on
    the second), each followed by BatchNorm (or GroupNorm) and GELU;
  - an optional linear projection conv_dim -> encoder_dim;
  - the sinusoidal table `pos[:T]` added (it lives in `state`, not in
    `params`: no gradient and no optimizer touches it);
  - pre-LN encoder blocks: LN -> attention (matmul + float32 softmax, with
    dropout of the probabilities) -> residual, LN -> MLP (4x, GELU, two
    dropouts) -> residual;
  - a final LayerNorm, the CNN head (conv1d k=3 + norm + GELU per stage),
    the mean over time and the linear classifier.

`apply` returns the logits and the new state: in training BatchNorm
normalises with the batch's statistics and moves the running ones; in
evaluation it normalises with the running ones. Dropout draws from an
explicit `torch.Generator`; without one (or at dropout 0) nothing is
dropped.

Tensor parallelism: `param_axes` is the reference's layout (each block's
attention cut over its heads, the MLP over its hidden units), and
`apply(..., model_group=)` runs on a rank's shards with two all-reduces
a block; the attention-probability dropout draws its mask for every
head and keeps the rank's, so the ranks together compute the one-process
step. The reference's trainer never applies the layout, and neither does
`train_classifier` (replicas on a model axis); `train/classifier.
make_steps` takes the shards when it is given a model group.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from audio_transformers_tpu_torch.core.config import UrbanSoundConfig
from audio_transformers_tpu_torch.core.params import init_urbansound
from audio_transformers_tpu_torch.ops import nn
from audio_transformers_tpu_torch.parallel import tensor as tp


def init(cfg: UrbanSoundConfig, generator: torch.Generator
         ) -> Tuple[dict, dict]:
    """(params, state) from `generator` (`core.params.init_urbansound`)."""
    return init_urbansound(cfg, generator)


def param_axes(params: dict, cfg: UrbanSoundConfig, model_size: int = 1):
    """The tensor-parallel layout of a classifier tree over a model axis
    of `model_size`, the reference's rules (`param_axes` of
    `audio_transformers_tpu/models/urbansound/model.py`) on the port's
    (out, in) weights: in each encoder block the q/k/v weights and biases
    cut along dim 0 (heads), o's weight along dim 1 (its input; its bias
    whole, added once after the all-reduce), fc1's weight and bias along
    dim 0 (hidden units), fc2's weight along dim 1; everything else whole,
    every BatchNorm and its running state included. A tree of
    `parallel.tensor.Split` or None per leaf. Raises ValueError unless
    the heads and the 4 x encoder_dim hidden units split evenly."""
    if cfg.num_heads % model_size or (4 * cfg.encoder_dim) % model_size:
        raise ValueError(f"{cfg.num_heads} heads ({4 * cfg.encoder_dim} "
                         f"hidden units) do not split over a model axis "
                         f"of {model_size}")

    def axes(tree, path):
        if isinstance(tree, dict):
            return {k: axes(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [axes(v, path + (i,)) for i, v in enumerate(tree)]
        if "blocks" not in path:
            return None
        tail = "/".join(str(p) for p in path[-3:])
        if tail.endswith(("attn/q/w", "attn/k/w", "attn/v/w", "attn/q/b",
                          "attn/k/b", "attn/v/b", "fc1/w", "fc1/b")):
            return tp.Split(0)
        if tail.endswith(("attn/o/w", "fc2/w")):
            return tp.Split(1)
        return None
    return axes(params, ())


def _norm_groups(dim: int) -> int:
    g = 32
    while dim % g:
        g //= 2
    return max(g, 1)


def _norm(cfg: UrbanSoundConfig, p: dict, s: dict, x: torch.Tensor, *,
          training: bool, group=None) -> Tuple[torch.Tensor, dict]:
    if cfg.norm_type == "group":
        return nn.group_norm(p, x, num_groups=_norm_groups(
            p["scale"].shape[0])), s
    return nn.batch_norm(p, s, x, training=training, group=group)


def _encoder_block(p: dict, x: torch.Tensor, cfg: UrbanSoundConfig, *,
                   training: bool, generator: Optional[torch.Generator],
                   model_group=None) -> torch.Tensor:
    rate = cfg.dropout if training else 0.0
    h = nn.layer_norm(p["attn_ln"], x)
    x = x + nn.multihead_attention(p["attn"], h, h, num_heads=cfg.num_heads,
                                   dropout_rate=rate, generator=generator,
                                   group=model_group)
    h = nn.layer_norm(p["mlp_ln"], x)
    h = nn.gelu(nn.linear(p["fc1"], tp.copy_to_model(h, model_group)))
    # the hidden units' dropout cuts this rank's columns of the whole draw;
    # fc2's output is whole on every rank, as is its dropout's draw
    h = nn.dropout(generator, h, rate, training=training,
                   shard=tp.piece(model_group, -1))
    h = nn.row_linear(p["fc2"], h, model_group)
    h = nn.dropout(generator, h, rate, training=training)
    return x + h


def apply(params: dict, state: dict, cfg: UrbanSoundConfig,
          mel: torch.Tensor, *, training: bool = False,
          generator: Optional[torch.Generator] = None, group=None,
          model_group=None) -> Tuple[torch.Tensor, dict]:
    """mel (B, T, n_mels) log-mel features -> (logits (B, classes) in
    mel's dtype, new state). Under data parallelism `group` is the
    process group whose ranks hold the global batch: BatchNorm's
    training statistics are then the global batch's (`nn.batch_norm`),
    and `generator` is a `nn.RowShard`. With a `model_group`, `params`
    are this rank's shards (`param_axes`): each encoder block runs its
    heads and hidden units and ends its attention and its MLP in an
    all-reduce, so every rank's logits and state are the whole ones;
    BatchNorm's `group` stays the data group."""
    pad = cfg.conv_kernel // 2
    x = nn.conv1d(params["conv1"], mel, padding=pad)
    x, bn1 = _norm(cfg, params["bn1"], state["bn1"], x, training=training,
                   group=group)
    x = nn.gelu(x)
    x = nn.conv1d(params["conv2"], x, stride=2, padding=pad)
    x, bn2 = _norm(cfg, params["bn2"], state["bn2"], x, training=training,
                   group=group)
    x = nn.gelu(x)
    if "proj" in params:
        x = nn.linear(params["proj"], x)
    x = x + state["pos"][None, :x.shape[1], :].to(x.dtype)
    for p in params["blocks"]:
        x = _encoder_block(p, x, cfg, training=training, generator=generator,
                           model_group=model_group)
    x = nn.layer_norm(params["ln_post"], x)
    cnn = []
    for p, s in zip(params["cnn"], state["cnn"]):
        x = nn.conv1d(p["conv"], x, padding=1)
        x, ns = _norm(cfg, p["bn"], s, x, training=training, group=group)
        cnn.append(ns)
        x = nn.gelu(x)
    # the state's own key order, which checkpoints check on resume
    new_state = {"bn1": bn1, "bn2": bn2, "cnn": cnn, "pos": state["pos"]}
    return nn.linear(params["cls"], x.mean(dim=1)), new_state
