"""Import HF Whisper checkpoints into the port's parameter tree.

The port of `audio_transformers_tpu/models/whisper/load.py`. It takes
state dicts of `WhisperForConditionalGeneration` (keys `model.encoder...`)
and of the reference's `EmotionWhisperModel` wrapper (keys
`whisper.model.encoder...` plus `emotion_classifier.*`). `proj_out.weight`
is ignored: the output projection is tied to the embedding table by
construction. HF linear weights are already (out, in) and conv weights
(Cout, Cin, K), the port's layouts (`core/params.py`), so nothing is
transposed; every leaf becomes float32. The tree equals what
`core.params.from_jax_params` makes of the JAX loader's result.

`load_safetensors` reads `model.safetensors` with the port's own reader
(`utils/safetensors.py`) and `pytorch_model.bin` with `torch.load`; it
needs neither `safetensors` nor `transformers`.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from audio_transformers_tpu_torch.core.config import WhisperConfig
from audio_transformers_tpu_torch.utils.safetensors import load_file


def _t(x) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    return t.detach().to("cpu", torch.float32).contiguous().clone()


def _linear(sd, prefix: str) -> dict:
    p = {"w": _t(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        p["b"] = _t(sd[f"{prefix}.bias"])
    return p


def _conv(sd, prefix: str) -> dict:
    return {"w": _t(sd[f"{prefix}.weight"]), "b": _t(sd[f"{prefix}.bias"])}


def _ln(sd, prefix: str) -> dict:
    return {"scale": _t(sd[f"{prefix}.weight"]),
            "bias": _t(sd[f"{prefix}.bias"])}


def _attn(sd, prefix: str) -> dict:
    return {"q": _linear(sd, f"{prefix}.q_proj"),
            "k": _linear(sd, f"{prefix}.k_proj"),  # whisper's has no bias
            "v": _linear(sd, f"{prefix}.v_proj"),
            "o": _linear(sd, f"{prefix}.out_proj")}


def from_torch_state_dict(sd: Dict, cfg: WhisperConfig
                          ) -> Tuple[dict, Optional[dict]]:
    """(whisper tree, emotion head {"w" (classes, d), "b"} or None) from a
    state dict of tensors or numpy arrays. Keys follow the port's init
    order (`core.params.init_whisper`)."""
    if any(k.startswith("whisper.") for k in sd):
        sd = {(k[len("whisper."):] if k.startswith("whisper.") else k): v
              for k, v in sd.items()}

    enc = {"conv1": _conv(sd, "model.encoder.conv1"),
           "conv2": _conv(sd, "model.encoder.conv2"),
           "pos": _t(sd["model.encoder.embed_positions.weight"]),
           "blocks": [], "ln": _ln(sd, "model.encoder.layer_norm")}
    for i in range(cfg.encoder_layers):
        pre = f"model.encoder.layers.{i}"
        enc["blocks"].append({
            "self_ln": _ln(sd, f"{pre}.self_attn_layer_norm"),
            "self_attn": _attn(sd, f"{pre}.self_attn"),
            "mlp_ln": _ln(sd, f"{pre}.final_layer_norm"),
            "fc1": _linear(sd, f"{pre}.fc1"),
            "fc2": _linear(sd, f"{pre}.fc2"),
        })

    dec = {"embed": {"table": _t(sd["model.decoder.embed_tokens.weight"])},
           "pos": _t(sd["model.decoder.embed_positions.weight"]),
           "blocks": [], "ln": _ln(sd, "model.decoder.layer_norm")}
    for i in range(cfg.decoder_layers):
        pre = f"model.decoder.layers.{i}"
        dec["blocks"].append({
            "self_ln": _ln(sd, f"{pre}.self_attn_layer_norm"),
            "self_attn": _attn(sd, f"{pre}.self_attn"),
            "mlp_ln": _ln(sd, f"{pre}.final_layer_norm"),
            "fc1": _linear(sd, f"{pre}.fc1"),
            "fc2": _linear(sd, f"{pre}.fc2"),
            "cross_ln": _ln(sd, f"{pre}.encoder_attn_layer_norm"),
            "cross_attn": _attn(sd, f"{pre}.encoder_attn"),
        })

    emotion = None
    if "emotion_classifier.weight" in sd:
        emotion = _linear(sd, "emotion_classifier")
    return {"encoder": enc, "decoder": dec}, emotion


def config_from_hf(hf_config) -> WhisperConfig:
    """WhisperConfig from an object with a transformers.WhisperConfig's
    attributes (transformers is not imported). The timestamp and task
    ids come from the vocab version (`token_overrides_for_vocab`): HF's
    config does not carry them."""
    return WhisperConfig(
        **WhisperConfig.token_overrides_for_vocab(hf_config.vocab_size),
        vocab_size=hf_config.vocab_size,
        n_mels=hf_config.num_mel_bins,
        d_model=hf_config.d_model,
        encoder_layers=hf_config.encoder_layers,
        decoder_layers=hf_config.decoder_layers,
        num_heads=hf_config.encoder_attention_heads,
        ffn_dim=hf_config.encoder_ffn_dim,
        max_source_positions=hf_config.max_source_positions,
        max_target_positions=hf_config.max_target_positions,
        pad_token_id=hf_config.pad_token_id,
        bos_token_id=hf_config.bos_token_id,
        eos_token_id=hf_config.eos_token_id,
        decoder_start_token_id=hf_config.decoder_start_token_id,
    )


def config_from_json(d: dict) -> WhisperConfig:
    """WhisperConfig from an HF config.json dict, with config_from_hf's
    vocab-derived ids and whisper-tiny's values for missing keys."""
    vocab = d.get("vocab_size", 51865)
    return WhisperConfig(
        **WhisperConfig.token_overrides_for_vocab(vocab),
        vocab_size=vocab,
        n_mels=d.get("num_mel_bins", 80),
        d_model=d.get("d_model", 384),
        encoder_layers=d.get("encoder_layers", 4),
        decoder_layers=d.get("decoder_layers", 4),
        num_heads=d.get("encoder_attention_heads", 6),
        ffn_dim=d.get("encoder_ffn_dim", 1536),
        max_source_positions=d.get("max_source_positions", 1500),
        max_target_positions=d.get("max_target_positions", 448),
        pad_token_id=d.get("pad_token_id", 50257),
        bos_token_id=d.get("bos_token_id", 50257),
        eos_token_id=d.get("eos_token_id", 50257),
        decoder_start_token_id=d.get("decoder_start_token_id", 50258),
    )


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A state dict from a .safetensors file or an HF save_pretrained
    directory (model.safetensors, else pytorch_model.bin). Sharded
    checkpoints (an *.index.json beside the shards) are not read."""
    if os.path.isdir(path):
        st = os.path.join(path, "model.safetensors")
        bin_ = os.path.join(path, "pytorch_model.bin")
        if os.path.exists(st):
            path = st
        elif os.path.exists(bin_):
            return torch.load(bin_, map_location="cpu", weights_only=True)
        else:
            raise FileNotFoundError(
                f"no model.safetensors or pytorch_model.bin in {path!r} "
                "(sharded index checkpoints are not supported)")
    return load_file(path)
