"""Parameter trees of the port: the weights bridge and the seeded init.

A model's parameters are nested dicts (and lists of per-layer dicts) of
tensors with the same keys as the reference package's pytrees
(`audio_transformers_tpu/models/whisper/model.py:init`,
`models/whisper/emotion.py:init`). Leaves are in PyTorch's layouts:

  linear `w`  JAX (in, out)          -> (out, in)
  conv   `w`  JAX (K, Cin, Cout)     -> (Cout, Cin, K)
  everything else (biases, layer-norm scale/bias, embedding table, the
  encoder `pos` parameter, decoder positions) keeps its shape.

`from_jax_params` and `to_jax_params` convert between the two; a round
trip returns the JAX tree bit for bit. The UrbanSound classifier's
(params, state) pair (`init_urbansound`) converts the same way, tree by
tree: its state's BatchNorm statistics and `pos` table keep their
shapes. `leaves_with_path`, `trainable_leaves` and `set_trainable` serve
the trainers: every leaf is trained except the frozen encoder positional
table (`FROZEN`). `init` and `init_urbansound` build fresh trees from an
explicit `torch.Generator` with the reference's distributions, for
machines where no JAX parameters can be made.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from audio_transformers_tpu_torch.core.config import (EmotionWhisperConfig,
                                                      UrbanSoundConfig,
                                                      WhisperConfig)
from audio_transformers_tpu_torch.ops.nn import (sinusoidal_embeddings,
                                                 sinusoidal_embeddings_ref)


def _leaf_to_torch(key: str, x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    if key == "w" and t.dim() == 2:
        t = t.t()
    elif key == "w" and t.dim() == 3:
        t = t.permute(2, 1, 0)
    return t.contiguous()


def _leaf_to_numpy(key: str, t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if key == "w" and t.dim() == 2:
        t = t.t()
    elif key == "w" and t.dim() == 3:
        t = t.permute(2, 1, 0)
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _map(tree: Any, fn, key: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn, key) for v in tree]
    return fn(key, tree)


def from_jax_params(tree: Any) -> dict:
    """A JAX parameter tree (leaves as numpy or jax arrays) -> port tree."""
    return _map(tree, _leaf_to_torch)


def to_jax_params(tree: Any) -> dict:
    """Inverse of `from_jax_params`: port tree -> tree of numpy arrays."""
    return _map(tree, _leaf_to_numpy)


def map_tensors(tree: Any, fn) -> Any:
    """`fn` applied to every leaf of a parameter tree."""
    return _map(tree, lambda _, t: fn(t))


def to_device(tree: Any, device) -> Any:
    return map_tensors(tree, lambda t: t.to(device))


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; raises when CUDA is asked for and
    absent, so that no entry point quietly runs on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} was asked for, but no "
                           "CUDA device is present (pass device='cpu' to "
                           "run on the CPU)")
    return device


def compute_dtype_for(device: torch.device) -> torch.dtype:
    """The activation dtype of a device the caller chose: bfloat16 on the
    card, float32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


# leaves that take no gradient and no optimizer update: the encoder
# positional table, frozen as in the reference (stop_gradient)
FROZEN = (("whisper", "encoder", "pos"),)


def leaves_with_path(tree: Any, path: tuple = ()) -> list:
    """[(path, tensor)] in tree order; a path holds dict keys and list
    indices, e.g. ("whisper", "decoder", "blocks", 0, "fc1", "w")."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in leaves_with_path(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in leaves_with_path(v, path + (i,))]
    return [(path, tree)]


def trainable_leaves(tree: Any, frozen=FROZEN) -> list:
    """[(path, tensor)] of every leaf except the frozen ones."""
    frozen = {tuple(f) for f in frozen}
    return [(p, t) for p, t in leaves_with_path(tree) if p not in frozen]


def set_trainable(tree: Any, frozen=FROZEN) -> Any:
    """Marks every leaf of `tree` requires_grad, except the frozen ones,
    in place; returns the tree."""
    frozen = {tuple(f) for f in frozen}
    for p, t in leaves_with_path(tree):
        t.requires_grad_(p not in frozen)
    return tree


# ---------------------------------------------------------------------------
# seeded init (torch's default Linear/Conv1d init: U(+-1/sqrt(fan_in)))
# ---------------------------------------------------------------------------


def _uniform(g: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=g) * 2.0 - 1.0) * bound


def linear_init(g: torch.Generator, in_dim: int, out_dim: int, *,
                use_bias: bool = True) -> dict:
    bound = 1.0 / math.sqrt(in_dim)
    p = {"w": _uniform(g, (out_dim, in_dim), bound)}
    if use_bias:
        p["b"] = _uniform(g, (out_dim,), bound)
    return p


def conv1d_init(g: torch.Generator, in_dim: int, out_dim: int,
                kernel_size: int) -> dict:
    bound = 1.0 / math.sqrt(in_dim * kernel_size)
    return {"w": _uniform(g, (out_dim, in_dim, kernel_size), bound),
            "b": _uniform(g, (out_dim,), bound)}


def layer_norm_init(dim: int) -> dict:
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}


def _mha_init(g: torch.Generator, dim: int, *, k_bias: bool = False) -> dict:
    return {"q": linear_init(g, dim, dim),
            "k": linear_init(g, dim, dim, use_bias=k_bias),
            "v": linear_init(g, dim, dim),
            "o": linear_init(g, dim, dim)}


def _block_init(g: torch.Generator, cfg: WhisperConfig, *,
                cross: bool) -> dict:
    d = cfg.d_model
    p = {"self_ln": layer_norm_init(d), "self_attn": _mha_init(g, d),
         "mlp_ln": layer_norm_init(d),
         "fc1": linear_init(g, d, cfg.ffn_dim),
         "fc2": linear_init(g, cfg.ffn_dim, d)}
    if cross:
        p["cross_ln"] = layer_norm_init(d)
        p["cross_attn"] = _mha_init(g, d)
    return p


def init_whisper(cfg: WhisperConfig, g: torch.Generator) -> dict:
    d = cfg.d_model
    enc = {
        "conv1": conv1d_init(g, cfg.n_mels, d, 3),
        "conv2": conv1d_init(g, d, d, 3),
        "pos": sinusoidal_embeddings(cfg.max_source_positions, d),
        "blocks": [_block_init(g, cfg, cross=False)
                   for _ in range(cfg.encoder_layers)],
        "ln": layer_norm_init(d),
    }
    dec = {
        "embed": {"table": torch.randn((cfg.vocab_size, d), generator=g)
                  * 0.02},
        "pos": torch.randn((cfg.max_target_positions, d), generator=g) * 0.02,
        "blocks": [_block_init(g, cfg, cross=True)
                   for _ in range(cfg.decoder_layers)],
        "ln": layer_norm_init(d),
    }
    return {"encoder": enc, "decoder": dec}


def init(cfg: EmotionWhisperConfig, generator: torch.Generator) -> dict:
    """Fresh EmotionWhisper parameters (float32, on the CPU) from
    `generator`: {"whisper": ..., "emotion_head": ...}."""
    return {"whisper": init_whisper(cfg.whisper, generator),
            "emotion_head": linear_init(generator, cfg.whisper.d_model,
                                        cfg.num_emotion_classes)}


def _norm_init(cfg: UrbanSoundConfig, dim: int) -> tuple:
    """(params, state) of one norm: BatchNorm's running mean 0 and var 1
    in the state, or GroupNorm's empty state."""
    params = layer_norm_init(dim)
    if cfg.norm_type == "group":
        return params, {}
    return params, {"mean": torch.zeros(dim), "var": torch.ones(dim)}


def init_urbansound(cfg: UrbanSoundConfig, generator: torch.Generator
                    ) -> tuple:
    """Fresh UrbanSound classifier (float32, on the CPU) from `generator`:
    (params, state), the reference's trees (`audio_transformers_tpu/models/
    urbansound/model.py:init`). `state` holds what no optimizer touches:
    the norms' running statistics and the sinusoidal `pos` table."""
    if cfg.norm_type not in ("batch", "group"):
        raise ValueError(f"unknown norm_type {cfg.norm_type!r}")
    g, d = generator, cfg.encoder_dim
    params: dict = {
        "conv1": conv1d_init(g, cfg.n_mels, cfg.conv_dim, cfg.conv_kernel),
        "conv2": conv1d_init(g, cfg.conv_dim, cfg.conv_dim, cfg.conv_kernel)}
    state: dict = {}
    params["bn1"], state["bn1"] = _norm_init(cfg, cfg.conv_dim)
    params["bn2"], state["bn2"] = _norm_init(cfg, cfg.conv_dim)
    if cfg.conv_dim != d:
        params["proj"] = linear_init(g, cfg.conv_dim, d)
    params["blocks"] = [
        {"attn_ln": layer_norm_init(d), "attn": _mha_init(g, d, k_bias=True),
         "mlp_ln": layer_norm_init(d), "fc1": linear_init(g, d, 4 * d),
         "fc2": linear_init(g, 4 * d, d)}
        for _ in range(cfg.num_encoder_blocks)]
    params["ln_post"] = layer_norm_init(d)
    params["cnn"], state["cnn"] = [], []
    in_dim = d
    for dim in cfg.cnn_dims:
        bn_p, bn_s = _norm_init(cfg, dim)
        params["cnn"].append({"conv": conv1d_init(g, in_dim, dim, 3),
                              "bn": bn_p})
        state["cnn"].append(bn_s)
        in_dim = dim
    params["cls"] = linear_init(g, cfg.cnn_dims[-1], cfg.num_classes)
    state["pos"] = sinusoidal_embeddings_ref(cfg.max_positions, d)
    return params, state
