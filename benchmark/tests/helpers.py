"""A small registry for the CPU tests: the test-size whisper, short mixes
and the benchmark's own metric readers, laid out as the benchmark's
folders are, in a temporary directory."""

from __future__ import annotations

import json
import os
import shutil

from benchmark.harness import registry

TEST_CONFIG = {
    "source": "test size", "model_type": "whisper", "d_model": 64, "encoder_layers": 2,
    "decoder_layers": 2, "encoder_attention_heads": 2,
    "decoder_attention_heads": 2, "encoder_ffn_dim": 128,
    "decoder_ffn_dim": 128, "num_mel_bins": 80, "vocab_size": 1024,
    "max_source_positions": 64, "max_target_positions": 32,
    "pad_token_id": 0, "bos_token_id": 0, "eos_token_id": 0,
    "decoder_start_token_id": 1, "lang_en_token_id": 2,
    "no_timestamps_token_id": 3, "timestamp_begin_id": 4,
    "transcribe_token_id": 2, "suppress_tokens": [5, 6, 7],
    "begin_suppress_tokens": [220, 0], "num_emotion_classes": 10,
    "assumed": {"text_token_ids": [5, 1024]}}

OPT = {"lr": 3e-05, "b1": 0.9, "b2": 0.999, "eps": 1e-08,
       "weight_decay": 0.0}
TRAIN_MIX = {"kind": "train", "batch": 4, "pool": 4, "audio_s": [0.3, 1.2],
             "label_len": 12, "transcript_ids": [3, 12],
             "compute_dtype": "float32", "attn_impl": "xla", "remat": False,
             "optimizer": OPT, "emotion_weight": 0.5, "trace_steps": 2}
ANALYZE_MIX = {"kind": "analyze", "batch": 4, "max_batch": 4, "pool": 2,
               "audio_s": [0.3, 1.2], "max_new_tokens": 12,
               "compute_dtype": "float32", "kv_quant": "none",
               "repetition_penalty": 1.15, "no_repeat_ngram": 3,
               "check_rows": 2, "check_extra": 2, "trace_steps": 1}


def make(tmp: str, train_mix: dict = TRAIN_MIX,
         analyze_mix: dict = ANALYZE_MIX, limits: dict = None) -> str:
    """A registry root under `tmp` with cells "test-train" and
    "test-analyze"; returns its path (both root and bench dir)."""
    for sub in ("configs", "workloads", "limits", "metrics"):
        os.makedirs(os.path.join(tmp, sub), exist_ok=True)
    with open(os.path.join(tmp, "configs", "test.json"), "w") as f:
        json.dump(TEST_CONFIG, f)
    for name, mix in (("train", train_mix), ("analyze", analyze_mix)):
        with open(os.path.join(tmp, "workloads", f"t-{name}.json"), "w") as f:
            json.dump(mix, f)
    for name, lim in (limits or {}).items():
        with open(os.path.join(tmp, "limits", f"{name}.json"), "w") as f:
            json.dump({k: {"limit": v} for k, v in lim.items()}, f)
    real = registry.load_benchmark()
    for m in real["per_layer"]:
        shutil.copy(os.path.join(registry.HERE, "metrics", m["name"] + ".py"),
                    os.path.join(tmp, "metrics"))
    bench = dict(real)
    bench["configs"] = [{"name": "test", "source": "test size",
                         "file": "configs/test.json", "reduced": [],
                         "why": "CPU tests"}]
    bench["workloads"] = [
        {"name": "test-train", "config": "test", "traffic": "t-train",
         "chips": 1, "why": "CPU tests"},
        {"name": "test-analyze", "config": "test", "traffic": "t-analyze",
         "chips": 1, "why": "CPU tests"}]
    rename = {"tiny-train-b64": "test-train", "large-v3-train-b16": None,
              "large-v3-offline-b64": "test-analyze",
              "large-v3-train-dp4": None}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [rename[w] for w in m["workloads"]
                              if rename.get(w)]
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return tmp
