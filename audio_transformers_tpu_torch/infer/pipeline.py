"""Inference pipeline: transcription + per-segment emotion, on PyTorch.

The port of `audio_transformers_tpu/infer/pipeline.EmotionWhisperPipeline`
with the same surface (`analyze_windows`, `transcribe`, `analyze`) and the
same batching: model windows are stacked into power-of-two buckets capped
at `max_batch`, each bucket goes through log-mel -> encoder -> greedy
decode, or beam search with `num_beams` > 1 (repetition penalty 1.15,
no-repeat 3-gram) -> emotion head on the decode's hidden states. A
pipeline loads from the port's checkpoints (`from_checkpoint`), from HF
directories (`from_hf_dir`, also the JAX package's exports), or takes
bridged or seeded parameters (`core.params`). It runs on the card unless
the caller asks for the CPU (`device="cpu"`); it raises when CUDA is asked
for and absent.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from audio_transformers_tpu_torch.core import tracing
from audio_transformers_tpu_torch.core.checkpoint import (Checkpointer,
                                                          load_label_map)
from audio_transformers_tpu_torch.core.config import (DecodeConfig,
                                                      EmotionWhisperConfig,
                                                      MelConfig,
                                                      WhisperConfig)
from audio_transformers_tpu_torch.core.params import (compute_dtype_for,
                                                      init, linear_init,
                                                      resolve_device,
                                                      to_device)
from audio_transformers_tpu_torch.models.whisper import beam as wbeam
from audio_transformers_tpu_torch.models.whisper import decode as wdecode
from audio_transformers_tpu_torch.models.whisper import emotion as emo
from audio_transformers_tpu_torch.models.whisper import model as wm
from audio_transformers_tpu_torch.models.whisper.load import (
    config_from_json, from_torch_state_dict, load_safetensors)
from audio_transformers_tpu_torch.ops.mel import log_mel
from audio_transformers_tpu_torch.utils.audio import resample, to_mono

# The reference's fallback label list.
DEFAULT_EMOTION_LABELS = [
    "confused", "default", "emphasis", "enunciated", "essentials", "happy",
    "laughing", "sad", "singing", "whisper",
]


class EmotionWhisperPipeline:
    """params: the port's {"whisper", "emotion_head"} tree (moved to
    `device` here; "cuda" by default, and an error when there is no card).
    compute_dtype: the activation dtype of the encoder and decoder; by
    default bfloat16 on the card and float32 on the CPU. num_beams > 1
    decodes by beam search (`models/whisper/beam.py`). step_attn and
    logits_impl ("auto", "fused" or "xla") go to `analyze_windows`'s
    DecodeConfig: the greedy routes of K1 and K2 or the reference's XLA
    arithmetic (`decode.generate`)."""

    def __init__(self, params: dict, cfg: EmotionWhisperConfig,
                 mel_cfg: Optional[MelConfig] = None,
                 idx_to_label: Optional[Dict[int, str]] = None,
                 tokenizer=None, *, device="cuda",
                 compute_dtype: Optional[torch.dtype] = None,
                 suppress_ids=None, kv_quant: str = "none",
                 num_beams: int = 1, step_attn: str = "auto",
                 logits_impl: str = "auto"):
        self.device = resolve_device(device)
        self.params = to_device(params, self.device)
        self.cfg = cfg
        self.mel_cfg = mel_cfg or MelConfig.whisper(n_mels=cfg.whisper.n_mels)
        self.idx_to_label = idx_to_label or dict(
            enumerate(DEFAULT_EMOTION_LABELS))
        self.tokenizer = tokenizer
        self.compute_dtype = compute_dtype or compute_dtype_for(self.device)
        self.kv_quant = kv_quant
        self.num_beams = num_beams
        self.step_attn = step_attn
        self.logits_impl = logits_impl
        self.suppress_ids = tuple(
            suppress_ids if suppress_ids is not None
            else wdecode.default_suppress_ids(cfg.whisper))
        # model window in samples: enc positions * conv stride * hop
        self._window = (cfg.whisper.max_source_positions * 2
                        * self.mel_cfg.hop_length)

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str, *, tokenizer=None,
                        step: Optional[int] = None, device="cuda",
                        compute_dtype: Optional[torch.dtype] = None,
                        kv_quant: str = "none", num_beams: int = 1
                        ) -> "EmotionWhisperPipeline":
        """A pipeline from a checkpoint directory the trainer wrote
        (checkpoints/ or resume/; the latest step unless `step`). The
        config, mel config, label map and suppress ids come from the
        step's metadata; without a config the head's width gives the
        class count."""
        device = resolve_device(device)
        tree, meta, _ = Checkpointer(checkpoint_dir).restore(step=step)
        params = tree["params"] if "params" in tree else tree
        meta = meta or {}
        if "cfg" in meta:
            cfg = EmotionWhisperConfig.from_dict(_loads_maybe(meta["cfg"]))
        else:
            cfg = EmotionWhisperConfig(
                num_emotion_classes=params["emotion_head"]["w"].shape[0])
        mel_cfg = (MelConfig.from_dict(_loads_maybe(meta["mel_cfg"]))
                   if "mel_cfg" in meta else None)
        idx_to_label = None
        if meta.get("style_to_idx"):
            idx_to_label = {int(v): k
                            for k, v in meta["style_to_idx"].items()}
        suppress = meta.get("suppress_ids")
        return cls(params, cfg, mel_cfg, idx_to_label, tokenizer=tokenizer,
                   device=device, compute_dtype=compute_dtype,
                   kv_quant=kv_quant, num_beams=num_beams,
                   suppress_ids=tuple(suppress) if suppress else None)

    @classmethod
    def from_hf_dir(cls, model_dir: str, *, tokenizer=None,
                    num_emotion_classes: int = 10, device="cuda",
                    compute_dtype: Optional[torch.dtype] = None,
                    kv_quant: str = "none", num_beams: int = 1
                    ) -> "EmotionWhisperPipeline":
        """A pipeline from an HF-format directory (model.safetensors or
        pytorch_model.bin; the reference's save_pretrained output and
        both packages' `export_hf_dir`). config.json gives the geometry
        and `num_emotion_classes`, style_to_id.txt the label map and
        generation_config.json's `suppress_tokens` the suppress ids. A
        plain whisper export without an `emotion_classifier` gets a fresh
        head from `torch.Generator().manual_seed(0)`; the JAX package
        draws its fresh head from `jax.random.PRNGKey(0)`, so the two
        packages' heads differ by construction."""
        device = resolve_device(device)
        sd = load_safetensors(model_dir)
        cfg_path = os.path.join(model_dir, "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                raw = json.load(f)
            whisper_cfg = config_from_json(raw)
            num_emotion_classes = raw.get("num_emotion_classes",
                                          num_emotion_classes)
        else:
            whisper_cfg = WhisperConfig.tiny()
        cfg = EmotionWhisperConfig(whisper=whisper_cfg,
                                   num_emotion_classes=num_emotion_classes)
        whisper_params, emotion = from_torch_state_dict(sd, cfg.whisper)
        del sd
        if not emotion:
            emotion = linear_init(torch.Generator().manual_seed(0),
                                  whisper_cfg.d_model,
                                  cfg.num_emotion_classes)
        params = {"whisper": whisper_params, "emotion_head": emotion}
        idx_to_label = None
        lm = os.path.join(model_dir, "style_to_id.txt")
        if os.path.exists(lm):
            idx_to_label = {v: k for k, v in load_label_map(lm).items()}
        suppress = None
        gc_path = os.path.join(model_dir, "generation_config.json")
        if os.path.exists(gc_path):
            with open(gc_path) as f:
                gc = json.load(f)
            if gc.get("suppress_tokens"):
                suppress = tuple(int(t) for t in gc["suppress_tokens"])
        return cls(params, cfg, idx_to_label=idx_to_label,
                   tokenizer=tokenizer, device=device,
                   compute_dtype=compute_dtype, kv_quant=kv_quant,
                   num_beams=num_beams, suppress_ids=suppress)

    def _prep(self, waveform: np.ndarray, sr: int) -> np.ndarray:
        wav = to_mono(np.asarray(waveform, dtype=np.float32))
        if sr != self.mel_cfg.sample_rate:
            wav = resample(wav, sr, self.mel_cfg.sample_rate)
        return wav

    @torch.inference_mode()
    def _decode(self, windows: np.ndarray, dcfg: DecodeConfig) -> dict:
        w = self.cfg.whisper
        prompt = wdecode.build_prompt(w, dcfg)
        wav = torch.from_numpy(np.ascontiguousarray(windows)).to(self.device)
        with tracing.span("log_mel"):
            mel = log_mel(wav, self.mel_cfg).to(self.compute_dtype)
        enc = wm.encode(self.params["whisper"], w, mel)
        if dcfg.num_beams > 1:
            # deterministic, so the compression-ratio fallback (a rescue of
            # degenerate greedy output) does not apply, as in the reference
            out = wbeam.generate_beam(self.params["whisper"], w, dcfg, enc,
                                      prompt=prompt,
                                      suppress_ids=self.suppress_ids)
        else:
            out = wdecode.generate_with_fallback(
                self.params["whisper"], w, dcfg, enc, prompt=prompt,
                suppress_ids=self.suppress_ids, tokenizer=self.tokenizer)
        logits = emo.sequence_emotion_from_hiddens(self.params,
                                                   out["hiddens"])
        out["probs"] = torch.softmax(logits, dim=-1)
        out["prompt_len"] = len(prompt)
        return out

    def _text(self, tokens: np.ndarray, start: int, length: int) -> str:
        if self.tokenizer is None:
            return ""
        ids = [int(t) for t in tokens[start:length]]
        return self.tokenizer.decode(ids, skip_special=True).strip()

    @tracing.spanned("pipeline.analyze_windows")
    def analyze_windows(self, windows: np.ndarray, *,
                        max_new_tokens: int = 64, max_batch: int = 16):
        """Decode + emotion for built model windows, (n, window) float32 ->
        (texts: list of n str, probs: (n, n_classes) float32). The serving
        micro-batcher calls this."""
        n = windows.shape[0]
        dcfg = DecodeConfig(max_new_tokens=max_new_tokens,
                            repetition_penalty=1.15, no_repeat_ngram_size=3,
                            kv_quant=self.kv_quant, num_beams=self.num_beams,
                            step_attn=self.step_attn,
                            logits_impl=self.logits_impl)
        bucket = 1
        while bucket < min(n, max_batch):
            bucket *= 2
        bucket = min(bucket, max_batch)
        texts: List[str] = []
        probs_rows = []
        for start in range(0, n, bucket):
            idxs = list(range(start, min(start + bucket, n)))
            group = np.zeros((bucket, self._window), np.float32)
            group[: len(idxs)] = windows[idxs[0]: idxs[-1] + 1]
            tracing.count("pipeline.rows", len(idxs))
            tracing.count("pipeline.padded_rows", bucket - len(idxs))
            out = self._decode(group, dcfg)
            # unmasked mean over all L positions, as the head is trained
            probs = out["probs"].cpu().numpy().astype(np.float32)
            tokens = out["tokens"].cpu().numpy()
            lengths = out["lengths"].cpu().numpy()
            for row in range(len(idxs)):
                texts.append(self._text(tokens[row], out["prompt_len"],
                                        int(lengths[row])))
                probs_rows.append(probs[row])
        return texts, np.stack(probs_rows)

    def _window_for(self, wav: np.ndarray) -> np.ndarray:
        window = np.zeros((1, self._window), np.float32)
        n = min(len(wav), self._window)
        window[0, :n] = wav[:n]
        return window

    def _segment_windows(self, wav: np.ndarray, seg_len: int) -> np.ndarray:
        n_segs = max(1, math.ceil(len(wav) / seg_len))
        windows = np.zeros((n_segs, self._window), np.float32)
        for s in range(n_segs):
            chunk = wav[s * seg_len: (s + 1) * seg_len][: self._window]
            windows[s, : len(chunk)] = chunk
        return windows

    def transcribe(self, waveform: np.ndarray, sr: int, *,
                   max_new_tokens: int = 128, runner=None) -> str:
        """Full-clip transcription (greedy, repetition penalty 1.15).
        `runner` replaces analyze_windows (the serving micro-batcher)."""
        wav = self._prep(waveform, sr)
        run = runner or self.analyze_windows
        texts, _ = run(self._window_for(wav), max_new_tokens=max_new_tokens)
        return texts[0]

    def analyze(self, waveform: np.ndarray, sr: int, *,
                segment_duration: float = 5.0, max_new_tokens: int = 64,
                max_batch: Optional[int] = None, runner=None) -> dict:
        """Transcription + per-segment emotion probabilities:
        {"transcription": str, "segments": [{"start", "end", "text",
        "emotion_probs", "emotion"}, ...]}. A `runner` owns the batching
        policy, so passing both it and `max_batch` is an error."""
        if runner is not None and max_batch is not None:
            raise ValueError(
                "max_batch has no effect when a runner is supplied; the "
                "runner (e.g. MicroBatcher) owns the batching policy")
        wav = self._prep(waveform, sr)
        sr = self.mel_cfg.sample_rate
        run = runner or (lambda w, **kw: self.analyze_windows(
            w, max_batch=16 if max_batch is None else max_batch, **kw))
        transcription = self.transcribe(wav, sr, runner=runner)

        seg_len = int(segment_duration * sr)
        windows = self._segment_windows(wav, seg_len)
        texts, probs = run(windows, max_new_tokens=max_new_tokens)
        segments: List[dict] = []
        for s in range(windows.shape[0]):
            p = probs[s]
            segments.append({
                "start": s * segment_duration,
                "end": min((s + 1) * segment_duration, len(wav) / sr),
                "text": texts[s],
                "emotion_probs": {self.idx_to_label.get(i, str(i)):
                                  float(p[i]) for i in range(len(p))},
                "emotion": self.idx_to_label.get(int(p.argmax()),
                                                 str(int(p.argmax()))),
            })
        return {"transcription": transcription, "segments": segments}


def _loads_maybe(obj):
    return json.loads(obj) if isinstance(obj, str) else obj


def self_test(duration: float = 12.0, *, device="cuda") -> dict:
    """Analyze a synthesized sine+noise clip with seeded whisper-tiny
    weights on `device` (bfloat16 on the card, float32 on the CPU); raises
    when CUDA is asked for and absent."""
    from audio_transformers_tpu_torch.utils.audio import synth_clip

    cfg = EmotionWhisperConfig()
    params = init(cfg, torch.Generator().manual_seed(0))
    pipe = EmotionWhisperPipeline(params, cfg, device=device)
    return pipe.analyze(synth_clip(duration, 16000), 16000)
