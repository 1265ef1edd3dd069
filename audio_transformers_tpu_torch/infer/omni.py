"""Inference pipeline of Uni-MoE-2.0-Omni's speech understanding: audio and
a prompt in, greedy text ids out, on PyTorch.

The surface of `EmotionWhisperPipeline`: built from the port's parameter
tree and config (`core.config.OmniConfig`), on the card unless the caller
asks for the CPU. `generate` takes whole recordings: each is cut into 30 s
windows (the last zero-padded), the windows of every row go through K3
(`ops/mel.log_mel`) and the whisper encoder (`models/whisper/model.encode`)
in buckets of at most `encoder_bucket` windows, are pooled and projected
(`models/unimoe/model.audio_embeddings`), and are placed in each row after
its first `audio_after` prompt ids. The rows, of different lengths, are
prefilled together and then decoded greedily for `max_new_tokens`, one
host sync a call (the ids' copy back). Loading the published checkpoint
and its tokenizer waits until those files are in the repository: the
weights are the caller's (seeded in the benchmark and the tests).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from audio_transformers_tpu_torch.core import tracing
from audio_transformers_tpu_torch.core.config import MelConfig, OmniConfig
from audio_transformers_tpu_torch.core.params import (compute_dtype_for,
                                                      map_tensors,
                                                      resolve_device)
from audio_transformers_tpu_torch.models.unimoe import model as um
from audio_transformers_tpu_torch.ops.decode_logits import fused_greedy_step
from audio_transformers_tpu_torch.ops.mel import log_mel

# cache positions a captured decode step is rounded up to
CACHE_BLOCK = 256


class OmniPipeline:
    """params: the port's {"whisper": {"encoder"}, "connector", "llm"}
    tree, moved to `device` and cast to `compute_dtype` (bfloat16 on the
    card, float32 on the CPU by default; tensors already there are kept,
    not copied)."""

    def __init__(self, params: dict, cfg: OmniConfig,
                 mel_cfg: Optional[MelConfig] = None, *, device="cuda",
                 compute_dtype: Optional[torch.dtype] = None,
                 encoder_bucket: int = 32, audio_after: int = 8):
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype or compute_dtype_for(self.device)
        self.params = map_tensors(params, lambda t: t.to(
            device=self.device, dtype=self.compute_dtype))
        self.cfg = cfg
        self.mel_cfg = mel_cfg or MelConfig.whisper(n_mels=cfg.whisper.n_mels)
        self.encoder_bucket = encoder_bucket
        self.audio_after = audio_after
        self.window = (cfg.whisper.max_source_positions * 2
                       * self.mel_cfg.hop_length)
        self.table, self.add = um.prepare_head(self.params["llm"], cfg.llm)
        self._steps = None
        self._staging = [None, None]
        self._staged = [None, None]

    # -- audio ----------------------------------------------------------------

    def window_counts(self, audio: Sequence[np.ndarray]) -> List[int]:
        return [max(1, math.ceil(len(a) / self.window)) for a in audio]

    def audio_embeddings(self, audio: Sequence[np.ndarray],
                         observer: Optional[um.Observer] = None
                         ) -> torch.Tensor:
        """(W, audio_tokens, D) of the recordings' windows, in buckets. On
        the card each bucket is cut straight into one of two pinned
        staging buffers, kept across calls, and copied without a sync
        (a buffer is refilled once its last copy has ended)."""
        counts = self.window_counts(audio)
        total = sum(counts)
        outs = []
        for i, lo in enumerate(range(0, total, self.encoder_bucket)):
            n = min(self.encoder_bucket, total - lo)
            host = self._stage(i % 2)[:n]
            fill_windows(audio, counts, lo, host.numpy())
            wav = host.to(self.device, non_blocking=True)
            if self.device.type == "cuda":
                self._staged[i % 2] = torch.cuda.Event()
                self._staged[i % 2].record()
            with tracing.span("log_mel"):
                mel = log_mel(wav, self.mel_cfg)
            outs.append(um.audio_embeddings(self.params, self.cfg,
                                            mel.to(self.compute_dtype)))
            if observer is not None:
                observer.mel.append(mel)
                observer.audio.append(outs[-1])
        return torch.cat(outs) if len(outs) > 1 else outs[0]

    def _stage(self, k: int) -> torch.Tensor:
        """Staging buffer k of a bucket's windows: pinned on the card."""
        shape = (self.encoder_bucket, self.window)
        if self.device.type != "cuda":
            return torch.empty(shape)
        if self._staging[k] is None:
            self._staging[k] = torch.empty(shape, pin_memory=True)
        if self._staged[k] is not None:
            self._staged[k].synchronize()
        return self._staging[k]

    def embed(self, prompts: Sequence[Sequence[int]], counts: Sequence[int],
              audio: torch.Tensor):
        """(packed embeddings (N, D), Packing): each row's first
        `audio_after` prompt ids, its windows' audio tokens, the rest."""
        a = self.cfg.audio_tokens
        ids, at, lengths = [], [], []
        for prompt, n in zip(prompts, counts):
            head, tail = list(prompt[:self.audio_after]), \
                list(prompt[self.audio_after:])
            start = len(ids) + len(head)
            at.extend(range(start, start + n * a))
            row = head + [0] * (n * a) + tail
            ids.extend(row)
            lengths.append(len(row))
        table = self.params["llm"]["embed"]["table"]
        x = table.index_select(0, um.to_device(ids, self.device))
        x.index_copy_(0, um.to_device(at, self.device),
                      audio.reshape(-1, x.shape[1]).to(x.dtype))
        return x, um.Packing.of(lengths, self.device)

    # -- generation -----------------------------------------------------------

    def generate(self, audio: Sequence[np.ndarray],
                 prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 160,
                 observer: Optional[um.Observer] = None) -> np.ndarray:
        """(B, max_new_tokens) int greedy ids of each (recording, prompt)
        row; recordings are float32 16 kHz mono. On the card the steps
        replay `models/unimoe/model.StepGraphs` (`_step_graphs`); on the
        CPU they run eagerly. `observer`
        keeps what it lists of the call."""
        if len(audio) != len(prompts) or not prompts:
            raise ValueError("one prompt per recording")
        cfg = self.cfg.llm
        with tracing.span("omni.generate"):
            x, pack = self.embed(prompts, self.window_counts(audio),
                                 self.audio_embeddings(audio, observer))
            b, length = len(prompts), pack.width + max_new_tokens
            steps = self._step_graphs(b, length)
            if steps is None:
                cache = um.init_cache(cfg, b, length, self.compute_dtype,
                                      self.device)
                router = um.Router(self.device) if tracing.enabled() else None
            else:
                cache, router = steps.cache, steps.router
                if router is not None:
                    router.stats.zero_()
            out = torch.empty((b, max_new_tokens), dtype=torch.int32,
                              device=self.device)
            llm = self.params["llm"]
            with tracing.span("omni.prefill", device=self.device):
                hidden = um.prefill(llm, cfg, x, pack, cache, router,
                                    observer)
                tok = fused_greedy_step(hidden, self.table, self.add)
            if observer is not None:
                observer.keep_hidden(hidden)
            out[:, 0] = tok
            pos = um.to_device(pack.lengths, self.device)
            if steps is not None:
                steps.tok.copy_(tok)
                steps.pos.copy_(pos)
            for s in range(1, max_new_tokens):
                with tracing.span("omni.decode.step", device=self.device):
                    if steps is not None:
                        tok = steps.replay(observer)
                    else:
                        hidden = um.decode_step(llm, cfg, tok, pos + s - 1,
                                                cache, router, observer)
                        tok = fused_greedy_step(hidden, self.table, self.add)
                        if observer is not None:
                            observer.keep_hidden(hidden)
                out[:, s] = tok
            tokens = out.cpu().numpy()
            if router is not None:
                for name, n in router.counts().items():
                    tracing.count(name, n)
        return tokens

    def _step_graphs(self, rows: int, length: int):
        """The captured decode step for `rows` and a cache of at least
        `length` positions (None on the CPU): kept and replayed by every
        later call it fits, else captured anew with the length rounded up
        to `CACHE_BLOCK` (the step attends over the whole static cache,
        its columns past each row's position masked), so batches whose
        longest row differs share one capture."""
        if self.device.type != "cuda":
            return None
        counted = tracing.enabled()
        if self._steps is not None:
            (r, n, c), steps = self._steps
            if r == rows and c == counted and n >= length:
                return steps
        length = -(-length // CACHE_BLOCK) * CACHE_BLOCK
        self._steps = None
        with tracing.span("omni.capture"):
            self._steps = ((rows, length, counted), um.StepGraphs(
                self.params["llm"], self.cfg.llm, self.table, self.add,
                rows, length, self.compute_dtype, self.device,
                counted=counted))
        tracing.count("omni.graph_captures")
        return self._steps[1]

    def analyze(self, wav: np.ndarray, sr: int, prompt: Sequence[int],
                max_new_tokens: int = 160) -> dict:
        """One recording at any rate: {"tokens": [...], "audio_s"}."""
        from audio_transformers_tpu_torch.utils.audio import resample, to_mono
        wav = resample(to_mono(np.asarray(wav, np.float32)), sr,
                       self.mel_cfg.sample_rate)
        tokens = self.generate([wav], [list(prompt)], max_new_tokens)
        return {"tokens": tokens[0].tolist(),
                "audio_s": len(wav) / self.mel_cfg.sample_rate}


def fill_windows(audio: Sequence[np.ndarray], counts: Sequence[int],
                 first: int, out: np.ndarray) -> None:
    """Windows [first, first + len(out)) of the recordings, in order, into
    `out` (n, window): each recording cut into `counts` windows, the last
    zero-padded."""
    window = out.shape[1]
    idx = 0
    for a, c in zip(audio, counts):
        for j in range(c):
            if first <= idx < first + len(out):
                seg = a[j * window:(j + 1) * window]
                row = out[idx - first]
                row[:len(seg)] = seg
                row[len(seg):] = 0.0
            idx += 1


def seeded(cfg: OmniConfig, seed: int = 0, router_scale: float = 1.0
           ) -> dict:
    """Seeded float32 parameters on the CPU (`models/unimoe/model.init`)."""
    return um.init(cfg, torch.Generator().manual_seed(seed), router_scale)

