"""Sequence- and segment-level evaluation of the whisper-emotion model, on
PyTorch: the port of `audio_transformers_tpu/infer/evaluate.py`, writing
the reference's exact files:

  - sequence level: predictions.txt, TSV rows `gt_style\tpred_style\t
    gt_text\tpred_text`, and metrics.txt, `samples/accuracy/weighted_f1`
    tab-separated;
  - segment level: predictions.txt, the per-segment log, and
    segment_evaluation.txt, accuracy, F1 and the classification report,
    the ground truth being the sample's emotion repeated per segment.

Transcription and emotion logits come from one batched pass (the decode
records the hidden states): log-mel (K3 on the card) -> encoder ->
greedy decode with the fallback re-decode (K1, K2), or beam search (K5)
-> the emotion head. Each batch goes to `device` ("cuda" by default; an
error when there is no card).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from audio_transformers_tpu_torch.core.config import (DecodeConfig,
                                                      EmotionWhisperConfig,
                                                      MelConfig)
from audio_transformers_tpu_torch.core.params import (compute_dtype_for,
                                                      resolve_device,
                                                      to_device)
from audio_transformers_tpu_torch.infer.metrics import (classification_metrics,
                                                        word_error_rate)
from audio_transformers_tpu_torch.models.whisper import beam as wbeam
from audio_transformers_tpu_torch.models.whisper import decode as wdecode
from audio_transformers_tpu_torch.models.whisper import emotion as emo
from audio_transformers_tpu_torch.models.whisper import model as wm
from audio_transformers_tpu_torch.ops.mel import log_mel


def _decode_batch(params, cfg: EmotionWhisperConfig, mel_cfg: MelConfig,
                  dcfg: DecodeConfig, waveform, prompt, compute_dtype,
                  device, *, tokenizer=None) -> dict:
    w = cfg.whisper
    suppress_ids = wdecode.default_suppress_ids(w)
    wav = torch.from_numpy(np.ascontiguousarray(waveform, np.float32))
    mel = log_mel(wav.to(device), mel_cfg).to(compute_dtype)
    enc = wm.encode(params["whisper"], w, mel)
    if dcfg.num_beams > 1:
        # beam search is deterministic: the compression-ratio fallback, a
        # rescue of degenerate greedy output, does not apply
        return wbeam.generate_beam(params["whisper"], w, dcfg, enc,
                                   prompt=prompt,
                                   suppress_ids=tuple(suppress_ids))
    # a plain generate when dcfg.compression_ratio_threshold is unset
    return wdecode.generate_with_fallback(params["whisper"], w, dcfg, enc,
                                          prompt=prompt,
                                          suppress_ids=tuple(suppress_ids),
                                          tokenizer=tokenizer)


def _setup(params, device, compute_dtype):
    dev = resolve_device(device)
    return (to_device(params, dev), dev,
            compute_dtype or compute_dtype_for(dev))


@torch.inference_mode()
def evaluate_sequence_level(params, cfg: EmotionWhisperConfig,
                            mel_cfg: MelConfig, batcher, idx_to_style: Dict,
                            *, tokenizer=None,
                            output_dir: Optional[str] = None,
                            dcfg: Optional[DecodeConfig] = None,
                            compute_dtype: Optional[torch.dtype] = None,
                            device="cuda") -> dict:
    """Greedy transcription and sequence-level emotion over a batcher's
    eval batches. The decode defaults are the reference's published
    evaluation (greedy, 100 new tokens, no-repeat 3-gram, repetition
    penalty 1.15); compute_dtype defaults to bfloat16 on the card and
    float32 on the CPU."""
    dcfg = dcfg or DecodeConfig(max_new_tokens=100, no_repeat_ngram_size=3,
                                repetition_penalty=1.15)
    params, dev, compute_dtype = _setup(params, device, compute_dtype)
    w = cfg.whisper
    prompt = wdecode.build_prompt(w, dcfg)

    gt_all, pred_all, rows = [], [], []
    gt_texts, pred_texts = [], []
    for batch in batcher.eval_batches():
        out = _decode_batch(params, cfg, mel_cfg, dcfg, batch["waveform"],
                            prompt, compute_dtype, dev, tokenizer=tokenizer)
        # the unmasked mean, as the head is trained and as the reference
        # evaluates
        emotion_logits = emo.sequence_emotion_from_hiddens(params,
                                                           out["hiddens"])
        preds = emotion_logits.argmax(dim=-1).cpu().numpy()
        tokens = out["tokens"].cpu().numpy()
        lengths = out["lengths"].cpu().numpy()
        for b in range(len(preds)):
            if not batch["valid"][b]:
                continue
            gt = int(batch["emotion_labels"][b])
            pr = int(preds[b])
            gt_all.append(gt)
            pred_all.append(pr)
            gt_txt = pr_txt = ""
            if tokenizer is not None:
                gen = tokens[b, len(prompt): lengths[b]].tolist()
                pr_txt = tokenizer.decode(gen).strip()
                lab = batch["labels"][b]
                lab = lab[lab != getattr(tokenizer, "pad_token_id", -1)]
                gt_txt = tokenizer.decode(lab.tolist()).strip()
                gt_texts.append(gt_txt)
                pred_texts.append(pr_txt)
            rows.append((idx_to_style.get(gt, "Unknown"),
                         idx_to_style.get(pr, "Unknown"), gt_txt, pr_txt))

    result = classification_metrics(gt_all, pred_all, idx_to_style)
    if gt_texts:
        result["wer"] = word_error_rate(gt_texts, pred_texts)

    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "predictions.txt"), "w") as f:
            for r in rows:
                f.write("\t".join(r) + "\n")
        with open(os.path.join(output_dir, "metrics.txt"), "w") as f:
            f.write(f"samples\t{result['samples']}\n"
                    f"accuracy\t{result['accuracy']:.6f}\n"
                    f"weighted_f1\t{result['weighted_f1']:.6f}\n")
    return result


def segments_from_tokens(tokens_row: np.ndarray, length: int,
                         prompt_len: int, timestamp_begin: int,
                         tokenizer=None, *, precision: float = 0.02) -> list:
    """Split a timestamped decode row into segments {"start", "end" (s;
    whisper's timestamps tick every 20 ms), "text"} on the host."""
    segments = []
    start_t = None
    text_ids: list = []
    for t in tokens_row[prompt_len:length].tolist():
        if t >= timestamp_begin:
            ts = (t - timestamp_begin) * precision
            if start_t is None:
                start_t = ts
            else:
                text = (tokenizer.decode(text_ids).strip()
                        if tokenizer else "")
                segments.append({"start": start_t, "end": ts, "text": text})
                start_t, text_ids = None, []
        elif start_t is not None:
            text_ids.append(t)
    if start_t is not None and text_ids:
        text = tokenizer.decode(text_ids).strip() if tokenizer else ""
        segments.append({"start": start_t, "end": start_t, "text": text})
    return segments


@torch.inference_mode()
def evaluate_segment_level(params, cfg: EmotionWhisperConfig,
                           mel_cfg: MelConfig, batcher, idx_to_style: Dict,
                           *, tokenizer=None,
                           output_dir: Optional[str] = None,
                           dcfg: Optional[DecodeConfig] = None,
                           max_segments: Optional[int] = None,
                           compute_dtype: Optional[torch.dtype] = None,
                           device="cuda") -> dict:
    """Timestamped decode -> per-segment emotion; the ground truth is the
    sample's emotion repeated per segment. The decode defaults are the
    reference's (timestamps on, repetition penalty 1.1, no-repeat 3-gram,
    256 new tokens, and the anti-repetition fallback: a compression ratio
    above 2.4 re-decodes the row at temperature 0.7)."""
    dcfg = dcfg or DecodeConfig(max_new_tokens=256, return_timestamps=True,
                                no_repeat_ngram_size=3,
                                repetition_penalty=1.1,
                                compression_ratio_threshold=2.4)
    params, dev, compute_dtype = _setup(params, device, compute_dtype)
    w = cfg.whisper
    prompt = wdecode.build_prompt(w, dcfg)

    gt_all, pred_all = [], []
    total_segments = 0
    log_lines = ["===== TRANSCRIPTION AND EMOTION PREDICTIONS =====", ""]
    for batch in batcher.eval_batches():
        out = _decode_batch(params, cfg, mel_cfg, dcfg, batch["waveform"],
                            prompt, compute_dtype, dev, tokenizer=tokenizer)
        seg = emo.segment_emotion_from_decode(params, cfg, out,
                                              prompt_len=len(prompt),
                                              max_segments=max_segments)
        seg_preds = seg["segment_logits"].argmax(dim=-1).cpu().numpy()
        counts = seg["segment_counts"].cpu().numpy()
        tokens = out["tokens"].cpu().numpy()
        lengths = out["lengths"].cpu().numpy()
        for b in range(counts.shape[0]):
            if not batch["valid"][b]:
                continue
            gt = int(batch["emotion_labels"][b])
            spans = segments_from_tokens(
                tokens[b], int(lengths[b]), len(prompt),
                w.timestamp_begin_id, tokenizer)
            log_lines.append("Segment-by-segment analysis:")
            # segment id s is span s (both count end timestamps): every
            # slot is visited and the empty ones skipped, so that a row of
            # counts [3, 0, 2] keeps its third segment
            for s in range(counts.shape[1]):
                if counts[b, s] <= 0:
                    continue
                gt_all.append(gt)
                pred_all.append(int(seg_preds[b, s]))
                total_segments += 1
                span = spans[s] if s < len(spans) else {"start": 0.0,
                                                        "end": 0.0,
                                                        "text": ""}
                pred_name = idx_to_style.get(int(seg_preds[b, s]),
                                             "Unknown")
                log_lines.append(
                    f"  Segment {s + 1} ({span['start']:.1f}s - "
                    f"{span['end']:.1f}s):")
                log_lines.append(f"    Text: \"{span['text']}\"")
                log_lines.append(f"    Predicted Emotion: {pred_name}")
            log_lines.append("")

    result = classification_metrics(gt_all, pred_all, idx_to_style)
    result["total_segments"] = total_segments

    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "predictions.txt"), "w") as f:
            f.write("\n".join(log_lines) + "\n")
        with open(os.path.join(output_dir, "segment_evaluation.txt"),
                  "w") as f:
            f.write(f"Total segments evaluated: {total_segments}\n")
            f.write(f"Segment-level Emotion Classification Accuracy: "
                    f"{result['accuracy']:.4f}\n")
            f.write(f"Segment-level Emotion Classification F1 Score: "
                    f"{result['weighted_f1']:.4f}\n\n")
            f.write("Detailed Classification Report:\n")
            f.write(result["report"])
    return result
