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
dropped. The reference's `param_axes` (tensor parallelism) is not ported
(ROADMAP.md §1 item 11): the reference's trainer never applies it, and
on a model axis the port's trainer keeps replicas, as the reference's
does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from audio_transformers_tpu_torch.core.config import UrbanSoundConfig
from audio_transformers_tpu_torch.core.params import init_urbansound
from audio_transformers_tpu_torch.ops import nn


def init(cfg: UrbanSoundConfig, generator: torch.Generator
         ) -> Tuple[dict, dict]:
    """(params, state) from `generator` (`core.params.init_urbansound`)."""
    return init_urbansound(cfg, generator)


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
                   training: bool,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    rate = cfg.dropout if training else 0.0
    h = nn.layer_norm(p["attn_ln"], x)
    x = x + nn.multihead_attention(p["attn"], h, h, num_heads=cfg.num_heads,
                                   dropout_rate=rate, generator=generator)
    h = nn.layer_norm(p["mlp_ln"], x)
    h = nn.gelu(nn.linear(p["fc1"], h))
    h = nn.dropout(generator, h, rate, training=training)
    h = nn.linear(p["fc2"], h)
    h = nn.dropout(generator, h, rate, training=training)
    return x + h


def apply(params: dict, state: dict, cfg: UrbanSoundConfig,
          mel: torch.Tensor, *, training: bool = False,
          generator: Optional[torch.Generator] = None, group=None
          ) -> Tuple[torch.Tensor, dict]:
    """mel (B, T, n_mels) log-mel features -> (logits (B, classes) in
    mel's dtype, new state). Under data parallelism `group` is the
    process group whose ranks hold the global batch: BatchNorm's
    training statistics are then the global batch's (`nn.batch_norm`),
    and `generator` is a `nn.RowShard`."""
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
        x = _encoder_block(p, x, cfg, training=training, generator=generator)
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
