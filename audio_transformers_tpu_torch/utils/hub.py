"""HF-format export and Hub publishing, the port of
`audio_transformers_tpu/utils/hub.py`.

Exported state dicts use the reference wrapper's key names
(`whisper.model...` plus `emotion_classifier.*`) and materialise the
tied `whisper.proj_out.weight`, so that the reference's loaders and the
JAX package (`EmotionWhisperPipeline.from_hf_dir`) read the port's
models unchanged. The UrbanSound classifier exports as one safetensors
file with the reference architecture's torch module names
(`classifier_to_torch_state_dict`), BatchNorm running statistics and the
`position_embeddings` table included. The port's leaves are already in
PyTorch's layouts; every value is written as float32.
`model.safetensors` is written by the port's own writer
(`utils/safetensors.py`); `huggingface_hub` is imported only by
`push_to_hub`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import torch

from audio_transformers_tpu_torch.core.checkpoint import save_label_map
from audio_transformers_tpu_torch.core.config import EmotionWhisperConfig
from audio_transformers_tpu_torch.utils.safetensors import save_file


def _t(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", torch.float32).contiguous()


def to_torch_state_dict(params: dict, cfg: EmotionWhisperConfig, *,
                        wrapper_prefix: str = "whisper."
                        ) -> Dict[str, torch.Tensor]:
    """The port's {"whisper", "emotion_head"} tree -> the reference
    wrapper's flat state dict of float32 CPU tensors."""
    sd: Dict[str, torch.Tensor] = {}

    def put(name, t):
        sd[wrapper_prefix + name] = _t(t)

    def put_linear(name, p):
        put(f"{name}.weight", p["w"])
        if "b" in p:
            put(f"{name}.bias", p["b"])

    def put_ln(name, p):
        put(f"{name}.weight", p["scale"])
        put(f"{name}.bias", p["bias"])

    def put_attn(name, p):
        put_linear(f"{name}.q_proj", p["q"])
        put_linear(f"{name}.k_proj", p["k"])
        put_linear(f"{name}.v_proj", p["v"])
        put_linear(f"{name}.out_proj", p["o"])

    enc = params["whisper"]["encoder"]
    put_linear("model.encoder.conv1", enc["conv1"])
    put_linear("model.encoder.conv2", enc["conv2"])
    put("model.encoder.embed_positions.weight", enc["pos"])
    put_ln("model.encoder.layer_norm", enc["ln"])
    for i, bp in enumerate(enc["blocks"]):
        pre = f"model.encoder.layers.{i}"
        put_ln(f"{pre}.self_attn_layer_norm", bp["self_ln"])
        put_attn(f"{pre}.self_attn", bp["self_attn"])
        put_ln(f"{pre}.final_layer_norm", bp["mlp_ln"])
        put_linear(f"{pre}.fc1", bp["fc1"])
        put_linear(f"{pre}.fc2", bp["fc2"])

    dec = params["whisper"]["decoder"]
    put("model.decoder.embed_tokens.weight", dec["embed"]["table"])
    put("model.decoder.embed_positions.weight", dec["pos"])
    put_ln("model.decoder.layer_norm", dec["ln"])
    for i, bp in enumerate(dec["blocks"]):
        pre = f"model.decoder.layers.{i}"
        put_ln(f"{pre}.self_attn_layer_norm", bp["self_ln"])
        put_attn(f"{pre}.self_attn", bp["self_attn"])
        put_ln(f"{pre}.encoder_attn_layer_norm", bp["cross_ln"])
        put_attn(f"{pre}.encoder_attn", bp["cross_attn"])
        put_ln(f"{pre}.final_layer_norm", bp["mlp_ln"])
        put_linear(f"{pre}.fc1", bp["fc1"])
        put_linear(f"{pre}.fc2", bp["fc2"])
    # the tied output projection, materialised for reference loaders
    put("proj_out.weight", dec["embed"]["table"])

    if params.get("emotion_head"):
        sd["emotion_classifier.weight"] = _t(params["emotion_head"]["w"])
        sd["emotion_classifier.bias"] = _t(params["emotion_head"]["b"])
    return sd


def export_hf_dir(params: dict, cfg: EmotionWhisperConfig, out_dir: str, *,
                  style_to_idx: Optional[dict] = None,
                  val_loss: Optional[float] = None,
                  val_accuracy: Optional[float] = None) -> str:
    """Writes an HF-compatible model directory: model.safetensors,
    config.json, generation_config.json, style_to_id.txt (with
    `style_to_idx`) and a README model card. Returns `out_dir`."""
    os.makedirs(out_dir, exist_ok=True)
    save_file(to_torch_state_dict(params, cfg),
              os.path.join(out_dir, "model.safetensors"),
              metadata={"format": "pt"})

    w = cfg.whisper
    config = {
        "architectures": ["EmotionWhisperModel"],
        "model_type": "whisper",
        "vocab_size": w.vocab_size,
        "num_mel_bins": w.n_mels,
        "d_model": w.d_model,
        "encoder_layers": w.encoder_layers,
        "decoder_layers": w.decoder_layers,
        "encoder_attention_heads": w.num_heads,
        "decoder_attention_heads": w.num_heads,
        "encoder_ffn_dim": w.ffn_dim,
        "decoder_ffn_dim": w.ffn_dim,
        "max_source_positions": w.max_source_positions,
        "max_target_positions": w.max_target_positions,
        "pad_token_id": w.pad_token_id,
        "bos_token_id": w.bos_token_id,
        "eos_token_id": w.eos_token_id,
        "decoder_start_token_id": w.decoder_start_token_id,
        "num_emotion_classes": cfg.num_emotion_classes,
    }
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)

    gen = {"forced_decoder_ids": None, "max_length": w.max_target_positions,
           "pad_token_id": w.pad_token_id, "eos_token_id": w.eos_token_id,
           "decoder_start_token_id": w.decoder_start_token_id,
           "no_timestamps_token_id": w.no_timestamps_token_id}
    with open(os.path.join(out_dir, "generation_config.json"), "w") as f:
        json.dump(gen, f, indent=2)

    if style_to_idx:
        save_label_map(os.path.join(out_dir, "style_to_id.txt"),
                       style_to_idx)

    with open(os.path.join(out_dir, "README.md"), "w") as f:
        f.write("# Emotion-Aware Whisper Model (audio-transformers-tpu)\n\n")
        f.write("Whisper-tiny encoder-decoder with a linear emotion head, "
                "trained with the audio-transformers-tpu framework "
                "(PyTorch).\n\n")
        if val_loss is not None:
            f.write(f"Validation Loss: {val_loss:.4f}\n\n")
        if val_accuracy is not None:
            f.write(f"Emotion Accuracy: {val_accuracy:.4f}\n\n")
    return out_dir


def classifier_to_torch_state_dict(params: dict, state: dict
                                   ) -> Dict[str, torch.Tensor]:
    """The classifier's (params, state) -> the reference module's flat
    state dict of float32 CPU tensors (q, k and v fused into the
    attention's `in_proj_*`)."""
    sd: Dict[str, torch.Tensor] = {}

    def lin(name, p):   # linear and conv alike: torch layouts already
        sd[f"{name}.weight"] = _t(p["w"])
        if "b" in p:
            sd[f"{name}.bias"] = _t(p["b"])

    def norm(name, p, s=None):
        sd[f"{name}.weight"] = _t(p["scale"])
        sd[f"{name}.bias"] = _t(p["bias"])
        if s:   # BatchNorm's running statistics; GroupNorm has none
            sd[f"{name}.running_mean"] = _t(s["mean"])
            sd[f"{name}.running_var"] = _t(s["var"])

    lin("conv_module.conv1", params["conv1"])
    lin("conv_module.conv2", params["conv2"])
    norm("conv_module.bn1", params["bn1"], state["bn1"])
    norm("conv_module.bn2", params["bn2"], state["bn2"])
    if "proj" in params:
        lin("projection", params["proj"])
    sd["position_embeddings"] = _t(state["pos"])
    for i, bp in enumerate(params["blocks"]):
        pre = f"encoder_blocks.{i}"
        norm(f"{pre}.attn_ln", bp["attn_ln"])
        qkv = [bp["attn"][k] for k in ("q", "k", "v")]
        sd[f"{pre}.attn.in_proj_weight"] = torch.cat([_t(p["w"])
                                                      for p in qkv])
        sd[f"{pre}.attn.in_proj_bias"] = torch.cat([_t(p["b"]) for p in qkv])
        lin(f"{pre}.attn.out_proj", bp["attn"]["o"])
        norm(f"{pre}.mlp_ln", bp["mlp_ln"])
        lin(f"{pre}.mlp.0", bp["fc1"])
        lin(f"{pre}.mlp.3", bp["fc2"])
    norm("ln_post", params["ln_post"])
    for i, (cp, cs) in enumerate(zip(params["cnn"], state["cnn"])):
        lin(f"cnn_module.cnn_layers.{i}.0", cp["conv"])
        norm(f"cnn_module.cnn_layers.{i}.1", cp["bn"], cs)
    lin("classifier", params["cls"])
    return sd


def export_classifier(params: dict, state: dict, out_path: str) -> str:
    """Writes the classifier to `out_path` as safetensors with the
    reference's torch-convention keys; returns `out_path`."""
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    save_file(classifier_to_torch_state_dict(params, state), out_path)
    return out_path


def push_to_hub(local_dir: str, repo_id: str,
                token: Optional[str] = None) -> bool:
    """Uploads `local_dir` to the Hub repo `repo_id` with the token, or
    the HF_ACCESS environment variable; without either it skips and
    returns False."""
    token = token or os.environ.get("HF_ACCESS")
    if not token:
        print("[hub] HF_ACCESS not set; skipping upload")
        return False
    try:
        from huggingface_hub import HfApi
        api = HfApi(token=token)
        api.create_repo(repo_id=repo_id, exist_ok=True)
        api.upload_folder(folder_path=local_dir, repo_id=repo_id,
                          path_in_repo=".",
                          commit_message="Upload from audio-transformers-tpu")
        return True
    except Exception as e:  # a failed upload must not lose the trained run
        print(f"[hub] upload failed: {e}")
        return False
