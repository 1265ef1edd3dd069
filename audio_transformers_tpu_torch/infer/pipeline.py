"""Inference pipeline: transcription + per-segment emotion, on PyTorch.

The port of `audio_transformers_tpu/infer/pipeline.EmotionWhisperPipeline`
with the same surface (`analyze_windows`, `transcribe`, `analyze`) and the
same batching: model windows are stacked into power-of-two buckets capped
at `max_batch`, each bucket goes through log-mel -> encoder -> greedy
decode, or beam search with `num_beams` > 1 (repetition penalty 1.15,
no-repeat 3-gram) -> emotion head on the decode's hidden states. Loading
from orbax checkpoints or HF directories is not ported yet; build the
pipeline from bridged or seeded parameters (`core.params`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from audio_transformers_tpu.core.config import (DecodeConfig,
                                                EmotionWhisperConfig,
                                                MelConfig)
from audio_transformers_tpu.utils.audio import resample, to_mono
from audio_transformers_tpu_torch.core.params import init, to_device
from audio_transformers_tpu_torch.models.whisper import beam as wbeam
from audio_transformers_tpu_torch.models.whisper import decode as wdecode
from audio_transformers_tpu_torch.models.whisper import emotion as emo
from audio_transformers_tpu_torch.models.whisper import model as wm
from audio_transformers_tpu_torch.ops.mel import log_mel

# The reference's fallback label list.
DEFAULT_EMOTION_LABELS = [
    "confused", "default", "emphasis", "enunciated", "essentials", "happy",
    "laughing", "sad", "singing", "whisper",
]


class EmotionWhisperPipeline:
    """params: the port's {"whisper", "emotion_head"} tree (moved to
    `device` here). compute_dtype: the activation dtype of the encoder and
    decoder (bfloat16 on the GPU; the CPU tests use float32). num_beams > 1
    decodes by beam search (`models/whisper/beam.py`)."""

    def __init__(self, params: dict, cfg: EmotionWhisperConfig,
                 mel_cfg: Optional[MelConfig] = None,
                 idx_to_label: Optional[Dict[int, str]] = None,
                 tokenizer=None, *, device="cpu",
                 compute_dtype: torch.dtype = torch.bfloat16,
                 suppress_ids=None, kv_quant: str = "none",
                 num_beams: int = 1):
        self.device = torch.device(device)
        self.params = to_device(params, self.device)
        self.cfg = cfg
        self.mel_cfg = mel_cfg or MelConfig.whisper(n_mels=cfg.whisper.n_mels)
        self.idx_to_label = idx_to_label or dict(
            enumerate(DEFAULT_EMOTION_LABELS))
        self.tokenizer = tokenizer
        self.compute_dtype = compute_dtype
        self.kv_quant = kv_quant
        self.num_beams = num_beams
        self.suppress_ids = tuple(
            suppress_ids if suppress_ids is not None
            else wdecode.default_suppress_ids(cfg.whisper))
        # model window in samples: enc positions * conv stride * hop
        self._window = (cfg.whisper.max_source_positions * 2
                        * self.mel_cfg.hop_length)

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

    def analyze_windows(self, windows: np.ndarray, *,
                        max_new_tokens: int = 64, max_batch: int = 16):
        """Decode + emotion for built model windows, (n, window) float32 ->
        (texts: list of n str, probs: (n, n_classes) float32). The serving
        micro-batcher calls this."""
        n = windows.shape[0]
        dcfg = DecodeConfig(max_new_tokens=max_new_tokens,
                            repetition_penalty=1.15, no_repeat_ngram_size=3,
                            kv_quant=self.kv_quant, num_beams=self.num_beams)
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


def self_test(duration: float = 12.0) -> dict:
    """Analyze a synthesized sine+noise clip with seeded whisper-tiny
    weights: bfloat16 on the GPU when there is one, else float32 on the
    CPU."""
    from audio_transformers_tpu.utils.audio import synth_clip

    cuda = torch.cuda.is_available()
    cfg = EmotionWhisperConfig()
    params = init(cfg, torch.Generator().manual_seed(0))
    pipe = EmotionWhisperPipeline(
        params, cfg, device="cuda" if cuda else "cpu",
        compute_dtype=torch.bfloat16 if cuda else torch.float32)
    return pipe.analyze(synth_clip(duration, 16000), 16000)
