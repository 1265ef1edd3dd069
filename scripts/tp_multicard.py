#!/usr/bin/env python3
"""Tensor parallelism over the cards of one host.

    python3 scripts/tp_multicard.py [--device cpu]

1. whisper-tiny (6 heads, seeded random weights, bf16 and float32) on a
   `model:2` mesh (2 cards) and on `data:2 x model:2` (4 cards): the
   greedy timestamped decode of 12 s clips (one a data rank), each rank
   on its heads, hidden units and vocab shard (K1 on its heads, K2 in its
   vocab-shard mode, one all-gather of the row partials a step), held to
   one card's decode of the same clips (`hold_decode`: float32 token for
   token; bf16 token for token up to the first position whose one-card
   margin lies under the bound that the hidden states' measured
   difference allows). Every rank must launch K1, K2's shard mode and
   K3, and K1 is held to its plain version at this rank's B * H / t rows.
   Printed per mesh: ms per decode step on the mesh and on one card, the
   collectives per step (all-reduces: 1 + 3 x decoder layers; all-gathers:
   1) and their time, by the host clock around each with the card
   synchronised, and its share of a step so timed.
   Then 4 beams on the same clips (48 new tokens, penalty 1.15, 3-gram
   ban; kv_quant none, int8, and int8 with timestamps), each rank on its
   heads with the logits gathered to whole rows each step and K5
   reordering its own caches, the ranks' choices compared every step
   (`generate_beam(check_ranks=True)`): `hold_beam` holds them to one
   card's (float32: the kept beams and lengths equal, scores within 1e-5
   relative; bf16: equal up to the first step whose one-card deciding
   margin lies under the bound the measured hidden differences allow);
   every rank launches K5 once a step. Printed: ms per beam step on the
   mesh and on one card, collectives per step.
2. whisper-base (8 heads, random weights) on `model:4`: the decode and
   beam checks.
3. one TP train step (whisper-tiny, batch 2, float32, flash attention)
   on `model:2` and `data:2 x model:2`: through the vocab-parallel
   cross-entropy and, for comparison, through the logits gathered to
   every rank (the route before it): their losses and gradients held to
   each other (1e-6 relative, 1e-4 * max(1, max |g|)) and the loss and
   rank 0's gradients to one card's step on the same batch, each route's
   collectives counted; then a second step with its collectives counted
   and timed as above, and a third for ms per step on the mesh and on
   one card.
4. one TP classifier train step (UrbanSoundConfig() at full width,
   batch 64 of 4 s clips, dropout 0.1; bf16 and float32) on `model:4`
   and `data:2 x model:2` (on `model:2` in chip_smoke): held to one
   card's step (float32: loss within 1e-6 relative, gradients within
   1e-4 * max(1, max |g|); bf16: loss within 2e-2 relative, the
   gradients' error printed), every whole leaf bit-equal over the model
   ranks (cuDNN deterministic for the step: its default convolution
   weight gradients sum in no fixed order), K3 launched on every rank.

Each mesh runs in N processes over NCCL, process r on card r
(`parallel.launch`). With --device cpu the same runs in gloo processes on
the CPU at the test widths (d 64, ffn 128; 2 heads, 4 for the model:4
case; the classifier at tests/torch_dp_worker.py's widths with 4 heads)
with whisper's vocabulary, a rehearsal of the paths (float32 only, no
kernels, no device time). chip_smoke.py's phase 30 runs `run_mesh` (the
decodes and beams untimed, the train step and the classifier step) with
two gloo ranks on one card.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time
from contextlib import contextmanager

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from audio_transformers_tpu_torch.core import params as cp  # noqa: E402
from audio_transformers_tpu_torch.core.config import (  # noqa: E402
    DecodeConfig, EmotionWhisperConfig, MelConfig, OptimizerConfig,
    TrainConfig, UrbanSoundConfig, WhisperConfig)
from audio_transformers_tpu_torch.models.urbansound import model as us  # noqa: E402,E501
from audio_transformers_tpu_torch.models.whisper import beam as wbeam  # noqa: E402,E501
from audio_transformers_tpu_torch.models.whisper import decode as wdecode  # noqa: E402,E501
from audio_transformers_tpu_torch.models.whisper import emotion as emo  # noqa: E402,E501
from audio_transformers_tpu_torch.models.whisper import model as wm  # noqa: E402,E501
from audio_transformers_tpu_torch.ops import _build  # noqa: E402
from audio_transformers_tpu_torch.ops import decode_attention as da  # noqa: E402,E501
from audio_transformers_tpu_torch.ops import decode_logits as dl  # noqa: E402,E501
from audio_transformers_tpu_torch.ops.mel import log_mel  # noqa: E402
from audio_transformers_tpu_torch.parallel import distributed  # noqa: E402
from audio_transformers_tpu_torch.parallel import tensor as tp  # noqa: E402
from audio_transformers_tpu_torch.parallel.launch import launch  # noqa: E402,E501
from audio_transformers_tpu_torch.parallel.mesh import (  # noqa: E402
    Mesh, build_mesh)

MESHES = {"model2": (("data", -1), ("model", 2)),
          "data2model2": (("data", 2), ("model", 2)),
          "model4": (("data", -1), ("model", 4))}
DCFG = DecodeConfig(max_new_tokens=48, return_timestamps=True,
                    repetition_penalty=1.15, no_repeat_ngram_size=3)
BEAMS = {
    "none": DecodeConfig(max_new_tokens=48, num_beams=4,
                         repetition_penalty=1.15, no_repeat_ngram_size=3),
    "int8": DecodeConfig(max_new_tokens=48, num_beams=4, kv_quant="int8",
                         repetition_penalty=1.15, no_repeat_ngram_size=3),
    "int8_ts": DecodeConfig(max_new_tokens=48, num_beams=4, kv_quant="int8",
                            return_timestamps=True, repetition_penalty=1.15,
                            no_repeat_ngram_size=3),
}
BEAM_KEYS = ("tokens", "lengths", "beam_tokens", "beam_scores",
             "beam_lengths")
CLS_BATCH = 64
CLIP_S = 12.0
K1_TOL_BF16 = 2e-2
# the bf16 rule: a logit of row b moves by at most |dh| * max_v |e_v| (the
# hidden states' measured difference times the largest embedding row, by
# Cauchy-Schwarz), times the repetition penalty (a seen logit is
# multiplied by it); a token may change only where the one-card margin is
# under twice that, plus the float32 sums' slack
MARGIN_SLACK = 1e-3


def whisper_cfg(size: str, device: str) -> WhisperConfig:
    """whisper-tiny or -base on the card; on the CPU the test widths with
    whisper's vocabulary and special ids (4 heads for "base", so that a
    model axis of 4 splits them)."""
    full = WhisperConfig() if size == "tiny" else WhisperConfig.base()
    if not device.startswith("cpu"):
        return full
    return WhisperConfig.test().replace(
        vocab_size=full.vocab_size, pad_token_id=full.pad_token_id,
        bos_token_id=full.bos_token_id, eos_token_id=full.eos_token_id,
        decoder_start_token_id=full.decoder_start_token_id,
        no_timestamps_token_id=full.no_timestamps_token_id,
        timestamp_begin_id=full.timestamp_begin_id,
        lang_en_token_id=full.lang_en_token_id,
        transcribe_token_id=full.transcribe_token_id,
        num_heads=2 if size == "tiny" else 4)


def clips(n: int, cfg: WhisperConfig, device, dtype) -> torch.Tensor:
    """n seeded 12 s clips (sines and noise), zero-padded to the encoder's
    window, as log-mel features (K3 on the card) in `dtype`."""
    mel_cfg = MelConfig.whisper()
    window = 2 * cfg.max_source_positions * mel_cfg.hop_length
    rng = np.random.default_rng(30)
    t = np.arange(int(CLIP_S * mel_cfg.sample_rate)) / mel_cfg.sample_rate
    wav = np.zeros((n, window), np.float32)
    for i in range(n):
        x = (0.5 * np.sin(2 * math.pi * (220 + 110 * i) * t)
             + 0.05 * rng.standard_normal(len(t)))[:window]
        wav[i, :len(x)] = x
    return log_mel(torch.from_numpy(wav).to(device), mel_cfg).to(dtype)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextmanager
def counted_collectives(device, timed: bool):
    """Counts (and with `timed`, times by the host clock with the card
    synchronised before and after) every all_reduce and all_gather the
    block makes; yields the {"all_reduce": [n, s], "all_gather": [n, s]}
    it fills."""
    rec = {"all_reduce": [0, 0.0], "all_gather": [0, 0.0]}
    saved = {name: getattr(dist, name) for name in rec}

    def wrap(name):
        def call(*a, **kw):
            if timed:
                _sync(device)
            t0 = time.perf_counter()
            out = saved[name](*a, **kw)
            if timed:
                _sync(device)
            rec[name][0] += 1
            rec[name][1] += time.perf_counter() - t0
            return out
        return call
    for name in rec:
        setattr(dist, name, wrap(name))
    try:
        yield rec
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def _k1_rows(b, heads, dev, dtype) -> float:
    """K1 against its plain version at this rank's b * heads rows (hd 64,
    1500 keys): the largest difference."""
    g = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn((b, heads, 64), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((b, heads, 64, 1500), generator=g,
                        device=dev).to(dtype) for _ in range(2))
    got = da.decode_cross_attention(q, k, v, scale=0.125)
    want = da.decode_cross_attention_reference(q, k, v, scale=0.125)
    return float((got.float() - want.float()).abs().max())


def _dtype(name):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def rank_main(out_dir: str, mesh_name: str, size: str, dtypes: list,
              device: str = "cuda", backend=None, timed: bool = True,
              train: bool = False, beams: bool = False,
              classifier: bool = False) -> None:
    """One rank of a mesh: the TP decode in each of `dtypes` (its data
    rank's clip on its shards; with `timed`, run twice more to time a
    step and its collectives), with `beams` the beam cases, with
    `classifier` the classifier step, then with `train` the TP train
    step. Saves <out_dir>/{decode,beam}_<mesh>_<size>_<dtype>_rank<r>.pt,
    <out_dir>/classifier_<mesh>_<dtype>_rank<r>.pt and
    <out_dir>/train_<mesh>_rank<r>.pt."""
    distributed.initialize_if_multihost(device=device, backend=backend)
    torch.backends.cudnn.allow_tf32 = False   # float32 convolutions exact
    mesh = build_mesh(MESHES[mesh_name])
    for dtype in dtypes:
        decode_rank(out_dir, mesh, mesh_name, size, dtype, device, timed)
        if beams:
            beam_rank(out_dir, mesh, mesh_name, size, dtype, device, timed)
        if classifier:
            classifier_rank(out_dir, mesh, mesh_name, dtype, device)
    if train:
        train_rank(out_dir, mesh, mesh_name, device)


def _decoder_setup(mesh, size, dtype, device):
    """(device, config, this rank's whisper shards, the encoder states of
    its data rank's clip)."""
    dev = distributed.process_device(device)
    cfg = whisper_cfg(size, str(dev))
    full = cp.init(EmotionWhisperConfig(whisper=cfg),
                   torch.Generator().manual_seed(0))
    axes = emo.param_axes(full, EmotionWhisperConfig(whisper=cfg),
                          mesh.model_size)
    shards = cp.to_device(tp.shard_params(
        full, mesh.model_size, mesh.model_rank, axes), dev)["whisper"]
    mel = clips(mesh.size, cfg, dev, _dtype(dtype))[mesh.rank:mesh.rank + 1]
    with torch.no_grad():
        enc = wm.encode(shards, cfg, mel, model_group=mesh.model_group)
    return dev, cfg, shards, enc


def decode_rank(out_dir, mesh, mesh_name, size, dtype, device,
                timed) -> None:
    dt = _dtype(dtype)
    group = mesh.model_group
    _build.reset_stats()
    dev, cfg, shards, enc = _decoder_setup(mesh, size, dtype, device)

    def run():
        with torch.no_grad():
            return wdecode.generate(shards, cfg, DCFG, enc,
                                    model_group=group)
    out = run()
    launches = {k: (s.launches, s.plain_cuda_calls)
                for k, s in _build.STATS.items()}
    wall = timed_wall = None
    if timed:
        _sync(dev)
        t0 = time.perf_counter()
        run()
        _sync(dev)
        wall = time.perf_counter() - t0
    with counted_collectives(dev, timed=timed) as rec:
        t0 = time.perf_counter()
        run()
        _sync(dev)
        timed_wall = time.perf_counter() - t0
    # decoder steps run: every position up to the first EOS, or all of
    # them (the loop's last token is fed once more)
    res = {"mesh": (mesh.size, mesh.rank, mesh.model_size, mesh.model_rank),
           "tokens": out["tokens"].cpu(), "lengths": out["lengths"].cpu(),
           "hiddens": out["hiddens"].float().cpu(), "launches": launches,
           "wall_s": wall, "timed_wall_s": timed_wall,
           "positions": int(out["lengths"].max()), "collectives": rec,
           "card": torch.cuda.get_device_name(dev) if dev.type == "cuda"
           else "cpu"}
    if dev.type == "cuda":
        res["k1_rows"] = {b: _k1_rows(b, cfg.num_heads // mesh.model_size,
                                      dev, dt) for b in (1, 4)}
    rank = distributed.process_index()
    torch.save(res, os.path.join(
        out_dir, f"decode_{mesh_name}_{size}_{dtype}_rank{rank}.pt"))


class MarginSpy:
    """Stands in for `dl.fused_greedy_step` during one card's decode: the
    kernel picks the token; the plain version's processed logits give
    each row's margin (the top-two gap in the region the token comes
    from, and in timestamp mode also the probability rule's), one (B,)
    tensor a generated position."""

    def __init__(self):
        self.fn = dl.fused_greedy_step
        self.margins = []

    def __call__(self, hidden, table_t, add, **kw):
        l = dl.processed_logits(hidden, table_t, add, **{
            k: v for k, v in kw.items() if k not in ("vocab_offset",
                                                     "partials")})

        def gap(x):
            top = x.topk(2, dim=-1).values
            return top[:, 0] - top[:, 1]
        m = gap(l)
        tb = kw.get("timestamp_begin")
        if kw.get("ts_bounds") is not None:
            rule = torch.logsumexp(l[:, tb:], -1) - l[:, :tb].amax(-1)
            region = torch.where(rule > 0, gap(l[:, tb:]), gap(l))
            m = torch.minimum(rule.abs(), region)
        self.margins.append(m.float().cpu())
        return self.fn(hidden, table_t, add, **kw)


def one_card_decode(size: str, dtype: str, n_clips: int, device: str,
                    timed: bool = True) -> dict:
    """The same decode on one card (no group) with every position's
    margins (with `timed`, once more to time it); also the largest
    embedding row's norm."""
    dev = torch.device(device)
    cfg = whisper_cfg(size, str(dev))
    full = cp.to_device(cp.init(EmotionWhisperConfig(whisper=cfg),
                                torch.Generator().manual_seed(0)),
                        dev)["whisper"]
    mel = clips(n_clips, cfg, dev, _dtype(dtype))
    spy = MarginSpy()
    with torch.no_grad():
        enc = wm.encode(full, cfg, mel)
        dl.fused_greedy_step = spy
        try:
            out = wdecode.generate(full, cfg, DCFG, enc)
        finally:
            dl.fused_greedy_step = spy.fn
        wall = None
        if timed:
            _sync(dev)
            t0 = time.perf_counter()
            wdecode.generate(full, cfg, DCFG, enc)
            _sync(dev)
            wall = time.perf_counter() - t0
    table = full["decoder"]["embed"]["table"].to(_dtype(dtype)).float()
    return {"tokens": out["tokens"].cpu(), "lengths": out["lengths"].cpu(),
            "hiddens": out["hiddens"].float().cpu(),
            "margins": spy.margins, "wall_s": wall,
            "emb_norm": float(table.norm(dim=1).max()),
            "prompt_len": len(wdecode.build_prompt(cfg, DCFG))}


def hold_decode(one: dict, ranks: list, dtype: str) -> dict:
    """Holds each rank's tokens to one card's decode of its clip: float32
    token for token; bf16 token for token up to the first position where
    they differ, where the one-card margin must lie under 2 * penalty *
    |dh| * max|e_v| + MARGIN_SLACK (dh: the two runs' final hidden states
    at the position before, where the inputs were still the same). The
    model ranks of a data rank must hold the same tokens. Returns
    {"rows_equal", "first_divergence", "bound_at_divergence",
    "margin_at_divergence"} per data row."""
    p_len = one["prompt_len"]
    rows = {}
    for r in ranks:
        d_rank = r["mesh"][1]
        peer = ranks[d_rank * r["mesh"][2]]
        if not torch.equal(r["tokens"], peer["tokens"]):
            raise AssertionError("the model ranks of a data rank hold "
                                 "different tokens")
        want = one["tokens"][d_rank]
        got = r["tokens"][0]
        diff = (got != want).nonzero()
        row = {"rows_equal": not len(diff)}
        if len(diff):
            pos = int(diff[0])
            if dtype == "float32":
                raise AssertionError(f"float32 TP decode differs from one "
                                     f"card at position {pos}")
            dh = float((r["hiddens"][0, pos - 1]
                        - one["hiddens"][d_rank, pos - 1]).norm())
            bound = 2 * DCFG.repetition_penalty * dh * one["emb_norm"] \
                + MARGIN_SLACK
            margin = float(one["margins"][pos - p_len][d_rank])
            row.update(first_divergence=pos, bound_at_divergence=bound,
                       margin_at_divergence=margin)
            if margin > bound:
                raise AssertionError(
                    f"bf16 TP decode differs at position {pos} where the "
                    f"one-card margin {margin:.3g} exceeds the bound "
                    f"{bound:.3g} (|dh| {dh:.3g})")
        rows[d_rank] = row
    return rows


class BeamSpy:
    """Records, while active, each beam step's position, hidden states
    (`wm.apply_decoder_step`'s output, float32 on the host), the token
    history of each row, and its deciding margin per batch row: the gap
    between the N-th continuing (non-EOS) candidate and the next one in
    rank order, and, where an EOS candidate stands at rank N or N + 1,
    the gap between those two ranks (which EOS retire); with timestamps
    also the timestamp rule's |logsumexp(timestamps) - max(text)| over
    the row's beams. (The order of the kept beams among themselves is not
    a decision: `hold_beam` compares the kept sets.)"""

    def __init__(self, cfg: WhisperConfig, n_beams: int):
        self.cfg, self.n = cfg, n_beams
        self.steps = []

    @contextmanager
    def active(self):
        step_fn, topk_fn = wm.apply_decoder_step, wbeam._stable_top_k
        proc_fn = wbeam._process_logits
        tb, eos = self.cfg.timestamp_begin_id, self.cfg.eos_token_id

        def step(*a, **kw):
            h, cache = step_fn(*a, **kw)
            self.steps.append({"hidden": h.float().cpu()})
            return h, cache

        def proc(lp, tokens, pos, cfg, dcfg, *a, **kw):
            rec = self.steps[-1]
            rec.update(pos=pos, hist=tokens[:, :pos].cpu())
            if dcfg.return_timestamps:
                rule = (torch.logsumexp(lp[:, tb:], -1)
                        - lp[:, :tb].amax(-1)).abs()
                rec["rule"] = rule.view(-1, self.n).amin(1)
            return proc_fn(lp, tokens, pos, cfg, dcfg, *a, **kw)

        def topk(x, k):
            vals, idx = topk_fn(x, k + 1)
            n = self.n
            is_eos = (idx % (x.shape[1] // n)) == eos
            rank_ne = torch.cumsum(~is_eos, dim=1)
            j = ((~is_eos) & (rank_ne == n)).int().argmax(dim=1)[:, None]
            gap = (vals.gather(1, j) - vals.gather(1, j + 1))[:, 0]
            at_edge = is_eos[:, n - 1] | is_eos[:, n]
            gap = torch.where(at_edge, torch.minimum(
                gap, vals[:, n - 1] - vals[:, n]), gap)
            rec = self.steps[-1]
            if "rule" in rec:
                gap = torch.minimum(gap, rec.pop("rule"))
            rec["margin"] = gap.float().cpu()
            return vals[:, :k], idx[:, :k]
        wm.apply_decoder_step, wbeam._stable_top_k = step, topk
        wbeam._process_logits = proc
        try:
            yield self
        finally:
            wm.apply_decoder_step, wbeam._stable_top_k = step_fn, topk_fn
            wbeam._process_logits = proc_fn


def beam_rank(out_dir, mesh, mesh_name, size, dtype, device,
              timed) -> None:
    """The beam cases on this rank's shards and its data rank's clip:
    outputs, per-step hidden states and K5's launches of a run that
    compares the ranks' choices every step; then, without that check,
    collectives per step (with `timed` timed, and the ms per step)."""
    group = mesh.model_group
    dev, cfg, shards, enc = _decoder_setup(mesh, size, dtype, device)
    res = {"mesh": (mesh.size, mesh.rank, mesh.model_size, mesh.model_rank),
           "card": torch.cuda.get_device_name(dev) if dev.type == "cuda"
           else "cpu", "cases": {}}
    for case, dcfg in BEAMS.items():
        def run(check=False):
            with torch.no_grad():
                return wbeam.generate_beam(shards, cfg, dcfg, enc,
                                           model_group=group,
                                           check_ranks=check)
        _build.reset_stats()
        spy = BeamSpy(cfg, dcfg.num_beams)
        with spy.active():
            out = run(check=True)   # the ranks' choices compared each step
        launches = {k: (s.launches, s.plain_cuda_calls)
                    for k, s in _build.STATS.items()}
        wall = None
        if timed:
            _sync(dev)
            t0 = time.perf_counter()
            run()
            _sync(dev)
            wall = time.perf_counter() - t0
        with counted_collectives(dev, timed=timed) as rec:
            t0 = time.perf_counter()
            run()
            _sync(dev)
            timed_wall = time.perf_counter() - t0
        res["cases"][case] = {
            **{k: out[k].cpu() for k in BEAM_KEYS},
            "record": spy.steps, "steps": len(spy.steps),
            "launches": launches, "wall_s": wall,
            "timed_wall_s": timed_wall, "collectives": rec}
    torch.save(res, os.path.join(
        out_dir, f"beam_{mesh_name}_{size}_{dtype}_rank"
        f"{distributed.process_index()}.pt"))


def one_card_beam(size: str, dtype: str, n_clips: int, device: str,
                  timed: bool = True) -> dict:
    """Each beam case on one card (no group), each clip encoded and
    decoded alone, the batch shape each data rank runs (at another batch
    the GEMMs round otherwise, and int8's quantization of q and of the
    self cache turns such rounding into whole steps), with its `BeamSpy`
    record per clip (with `timed`, clip 0 once more to time it); also
    the largest embedding row's norm."""
    dev = torch.device(device)
    cfg = whisper_cfg(size, str(dev))
    full = cp.to_device(cp.init(EmotionWhisperConfig(whisper=cfg),
                                torch.Generator().manual_seed(0)),
                        dev)["whisper"]
    mel = clips(n_clips, cfg, dev, _dtype(dtype))
    table = full["decoder"]["embed"]["table"].to(_dtype(dtype)).float()
    out = {"emb_norm": float(table.norm(dim=1).max()), "cases": {}}
    with torch.no_grad():
        encs = [wm.encode(full, cfg, mel[i:i + 1]) for i in range(n_clips)]
        for case, dcfg in BEAMS.items():
            got, records, wall = [], [], None
            for i, enc in enumerate(encs):
                spy = BeamSpy(cfg, dcfg.num_beams)
                with spy.active():
                    got.append(wbeam.generate_beam(full, cfg, dcfg, enc))
                records.append(spy.steps)
                if timed and i == 0:
                    _sync(dev)
                    t0 = time.perf_counter()
                    wbeam.generate_beam(full, cfg, dcfg, enc)
                    _sync(dev)
                    wall = time.perf_counter() - t0
            out["cases"][case] = {
                **{k: torch.cat([g[k].cpu() for g in got]) for k in
                   BEAM_KEYS},
                "record": records, "steps": [len(r) for r in records],
                "wall_s": wall,
                "prompt_len": len(wdecode.build_prompt(cfg, dcfg))}
    return out


def _first_divergence(got: torch.Tensor, want: torch.Tensor) -> int:
    """The first position where a kept beam of `got` (N, L) departs from
    every kept beam of `want`: over got's beams that want lacks, the
    least of each's longest common prefix with want's; L if the sets are
    equal."""
    pos = got.shape[-1]
    for g in got:
        same = (want == g).int().cumprod(dim=1).sum(dim=1)
        if int(same.max()) < got.shape[-1]:
            pos = min(pos, int(same.max()))
    return pos


def _step_dh(one_rec: dict, rank_rec: dict) -> float:
    """The largest hidden-state difference at one step between each of
    the rank's beams and the one-card beam of the same token history
    (beams with no such one-card beam left out)."""
    hist_o, h_o = one_rec["hist"], one_rec["hidden"]
    dh = 0.0
    for hist, h in zip(rank_rec["hist"], rank_rec["hidden"]):
        match = (hist_o == hist).all(dim=1)
        if match.any():
            dh = max(dh, float((h_o[match] - h).norm(dim=-1).min()))
    return dh


def hold_beam(one: dict, ranks: list, case: str, dtype: str) -> dict:
    """Holds each rank's beams to one card's on its clip. The model ranks
    of a data rank must return the same outputs, and each must have
    launched K5 once a step. float32: the kept beams (as a set) and
    their lengths equal, the scores within 1e-5 relative, and the best
    hypothesis one card's (or, where one card's two best scores lie
    within that 1e-5, either of them: `best_tie`).
    bf16: equal, or else the first position where a kept beam departs
    from one card's (`_first_divergence`) must come at or after a step
    (past the forced prompt) whose one-card deciding margin (`BeamSpy`)
    lies under 2 * sum over the generated steps so far of 2 * penalty *
    |dh| * max|e_v| + MARGIN_SLACK (dh: the step's largest hidden-state
    difference between beams of the same history; a log-probability
    moves by at most twice a logit's move, a logit by |dh| max|e_v|, the
    penalty scales it, and a gap between two candidates' scores moves by
    at most both moves). Returns per data row {"equal", "score_rel",
    "first_divergence", "step_under_bound", ...}."""
    want_all = one["cases"][case]
    rows = {}
    for r in ranks:
        d_rank, t = r["mesh"][1], r["mesh"][2]
        got_all = r["cases"][case]
        peer = ranks[d_rank * t]["cases"][case]
        for k in BEAM_KEYS:
            if not torch.equal(got_all[k], peer[k]):
                raise AssertionError(f"{case}: the model ranks of data rank "
                                     f"{d_rank} returned different {k}")
        k5 = got_all["launches"]["permute_rows"]
        if k5[1] or (k5[0] and k5[0] != got_all["steps"]):
            raise AssertionError(f"{case}: K5 {k5} over "
                                 f"{got_all['steps']} steps")
        want = {k: v[d_rank:d_rank + 1] for k, v in want_all.items()
                if k in BEAM_KEYS}
        pos = _first_divergence(got_all["beam_tokens"][0],
                                want["beam_tokens"][0])
        equal = pos == want["beam_tokens"].shape[-1]
        rel, best_tie = None, False
        if equal:    # want's kept beams in got's order
            order = [int((want["beam_tokens"][0] == g).all(1).int().argmax())
                     for g in got_all["beam_tokens"][0]]
            equal = torch.equal(got_all["beam_lengths"][0],
                                want["beam_lengths"][0][order])
            w = want["beam_scores"][0][order]
            rel = float(((got_all["beam_scores"][0] - w).abs()
                         / w.abs()).max())
            # the best of the set: one card's, or, where one card's two
            # best scores lie within the scores' 1e-5 relative agreement,
            # either of them
            ws = want["beam_scores"][0]
            tied = (ws >= ws.max() - 1e-5 * ws.max().abs()).nonzero()[:, 0]
            best_tie = len(tied) > 1 and not torch.equal(
                got_all["tokens"], want["tokens"])
            equal = equal and any(
                torch.equal(got_all["tokens"][0], want["beam_tokens"][0][i])
                and int(got_all["lengths"][0]) == int(
                    want["beam_lengths"][0][i]) for i in tied.tolist())
        row = {"equal": equal, "score_rel": rel, "best_tie": best_tie,
               "steps": got_all["steps"]}
        if dtype == "float32" and (not equal or rel > 1e-5):
            raise AssertionError(
                f"{case}: float32 TP beams of data rank {d_rank} differ from "
                f"one card (first at position {pos}, scores {rel}; lengths "
                f"{got_all['beam_lengths'][0].tolist()} against "
                f"{want['beam_lengths'][0].tolist()}, scores "
                f"{got_all['beam_scores'][0].tolist()} against "
                f"{want['beam_scores'][0].tolist()})")
        if not equal:
            acc, first = 0.0, None
            for rec_o, rec_t in zip(want_all["record"][d_rank],
                                    got_all["record"]):
                if rec_o["pos"] != rec_t["pos"]:
                    break
                if rec_o["pos"] < want_all["prompt_len"]:
                    continue     # forced tokens: the scores stay frozen
                acc += 2 * BEAMS[case].repetition_penalty * one["emb_norm"] \
                    * _step_dh(rec_o, rec_t)
                bound = 2 * acc + MARGIN_SLACK
                margin = float(rec_o["margin"][0])
                if margin < bound:
                    first = (rec_o["pos"], margin, bound)
                    break
            row.update(first_divergence=pos)
            if first is None or first[0] > pos:
                raise AssertionError(
                    f"{case}: bf16 TP beams differ at position {pos} with "
                    f"no earlier step whose one-card margin is under its "
                    f"bound ({first})")
            row.update(position_under_bound=first[0], margin=first[1],
                       bound=first[2])
        rows[d_rank] = row
    return rows


def _cls_cfg(device) -> UrbanSoundConfig:
    """UrbanSoundConfig() on the card; on the CPU the test widths with 4
    heads (a model axis of 4 splits them)."""
    if str(device).startswith("cuda"):
        return UrbanSoundConfig()
    return UrbanSoundConfig(conv_dim=32, encoder_dim=32,
                            num_encoder_blocks=2, num_heads=4,
                            cnn_dims=(32, 48))


def _cls_batch(device, rows: slice) -> dict:
    """Rows `rows` of a seeded batch of CLS_BATCH 4 s clips at 22.05 kHz
    (0.3 * randn) with labels, on `device`."""
    rng = np.random.default_rng(24)
    wav = (0.3 * rng.standard_normal((CLS_BATCH, 88200))).astype(np.float32)
    label = rng.integers(0, 10, CLS_BATCH)
    return {"waveform": torch.from_numpy(wav[rows]).to(device),
            "label": torch.from_numpy(label[rows]).to(device)}


def classifier_step(mesh: Mesh, dtype: str, device) -> dict:
    """One classifier train step (dropout 0.1) on this rank's shards (the
    whole tree without a model group) and its data rank's rows: the mean
    loss over the data ranks, the whole gradients, every whole leaf after
    the step, K3's launches."""
    from audio_transformers_tpu_torch.train import classifier as tc
    from audio_transformers_tpu_torch.train import common, optim
    dev = torch.device(device)
    cfg = _cls_cfg(dev)
    params, state = cp.to_device(us.init(
        cfg, torch.Generator().manual_seed(0)), dev)
    group = mesh.model_group
    axes = us.param_axes(params, cfg, mesh.model_size) if group else None
    if axes is not None:
        params = tp.shard_params(params, mesh.model_size, mesh.model_rank,
                                 axes)
    params = cp.set_trainable(params, frozen=())
    tcfg = TrainConfig(batch_size=CLS_BATCH, compute_dtype=dtype,
                       optimizer=OptimizerConfig(name="adam",
                                                 learning_rate=1e-3,
                                                 schedule="constant"))
    opt = optim.build_optimizer(tcfg.optimizer, params, model_group=group,
                                axes=axes)
    step, _ = tc.make_steps(cfg, MelConfig.urbansound(), tcfg, opt, mesh,
                            tensor_parallel=True)
    per = CLS_BATCH // mesh.size
    batch = _cls_batch(dev, slice(mesh.rank * per, (mesh.rank + 1) * per))
    gen = common.rank_generator(
        torch.Generator(device=dev).manual_seed(24), mesh)
    _build.reset_stats()
    # cuDNN's default weight-gradient algorithms for the convolutions sum
    # in no fixed order, so the ranks' replicated leaves would differ by
    # rounding; the deterministic ones let the check ask for equal bits
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _, m = step(params, state, batch, gen)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    grads = cp.map_tensors(params, lambda t: t.grad)
    splits = (tp.split_leaves(axes) if axes is not None
              else [None] * len(cp.leaves_with_path(params)))
    return {"loss": common.mean_over_ranks(m, mesh)["loss"],
            "grads": {p: g.float().cpu() for p, g in cp.leaves_with_path(
                tp.gather_params(grads, group, axes) if axes else grads)},
            "whole_leaves": {p: t.detach().cpu() for (p, t), sp in zip(
                cp.leaves_with_path(params), splits) if sp is None},
            "k3": (_build.STATS["log_mel"].launches,
                   _build.STATS["log_mel"].plain_cuda_calls)}


def classifier_rank(out_dir, mesh, mesh_name, dtype, device) -> None:
    dev = distributed.process_device(device)
    res = classifier_step(mesh, dtype, dev)
    res["mesh"] = (mesh.size, mesh.rank, mesh.model_size, mesh.model_rank)
    torch.save(res, os.path.join(
        out_dir, f"classifier_{mesh_name}_{dtype}_rank"
        f"{distributed.process_index()}.pt"))


def _hold_classifier(out_dir, mesh_name, dtype, device, n) -> dict:
    """The TP classifier step against one card's (see the module note)."""
    ranks = _load(out_dir, f"classifier_{mesh_name}_{dtype}", n)
    one = classifier_step(Mesh(1, 0), dtype, device)
    rel = abs(ranks[0]["loss"] - one["loss"]) / abs(one["loss"])
    g_ratio = max(float((ranks[0]["grads"][p] - g).abs().max())
                  / (1e-4 * max(1.0, float(g.abs().max())))
                  for p, g in one["grads"].items())
    if rel > (1e-6 if dtype == "float32" else 2e-2):
        raise AssertionError(f"{mesh_name} classifier {dtype}: loss "
                             f"{ranks[0]['loss']} against one card's "
                             f"{one['loss']}")
    if dtype == "float32" and g_ratio > 1.0:
        raise AssertionError(f"{mesh_name} classifier: gradients at "
                             f"{g_ratio:.3g} of 1e-4 max(1, |g|)")
    for r in ranks:
        peer = ranks[r["mesh"][1] * r["mesh"][2]]
        for p, t in r["whole_leaves"].items():
            if not torch.equal(t, peer["whole_leaves"][p]):
                raise AssertionError(f"{mesh_name} classifier: whole leaf "
                                     f"{p} differs over the model ranks")
        if str(device).startswith("cuda") and (r["k3"][0] == 0 or r["k3"][1]):
            raise AssertionError(f"{mesh_name} classifier: K3 {r['k3']}")
    return {"mesh": mesh_name, "dtype": dtype, "loss": ranks[0]["loss"],
            "one_card_loss": one["loss"], "loss_rel": rel,
            "grad_share_of_tol": g_ratio,
            "k3_launches_rank0": ranks[0]["k3"][0]}


def _hold_beams(out_dir, mesh_name, size, dtype, device, n, timed) -> dict:
    ranks = _load(out_dir, f"beam_{mesh_name}_{size}_{dtype}", n)
    one = one_card_beam(size, dtype, ranks[0]["mesh"][0], device, timed)
    out = {"mesh": mesh_name, "size": size, "dtype": dtype,
           "card": ranks[0]["card"], "cases": {}}
    for case in BEAMS:
        r0 = ranks[0]["cases"][case]
        steps = r0["steps"]
        res = {"rows": hold_beam(one, ranks, case, dtype),
               "collectives_per_step": {k: v[0] / steps for k, v in
                                        r0["collectives"].items()},
               "k5_launches_rank0": r0["launches"]["permute_rows"][0],
               "k3_launches_rank0": r0["launches"]["log_mel"][0]}
        if str(device).startswith("cuda"):
            for r in ranks:
                if r["cases"][case]["launches"]["permute_rows"][0] \
                        != r["cases"][case]["steps"]:
                    raise AssertionError(f"{case}: rank {r['mesh']} did not "
                                         f"launch K5 once a step")
        if timed:
            coll = sum(v[1] for v in r0["collectives"].values())
            res.update(ms_per_step=1e3 * r0["wall_s"] / steps,
                       one_card_ms_per_step=1e3 * one["cases"][case][
                           "wall_s"] / one["cases"][case]["steps"][0],
                       collective_ms_per_step=1e3 * coll / steps,
                       collective_share=coll / r0["timed_wall_s"])
        out["cases"][case] = res
    return out


@contextmanager
def gathered_logits():
    """The train step's cross-entropy as it ran before the vocab-parallel
    one: every rank gathers the B x T x V logits (`tensor.gather_vocab`)
    and takes F.cross_entropy of the whole rows (for comparison)."""
    from audio_transformers_tpu_torch.train import whisper_emotion as tw
    saved = tw.token_cross_entropy

    def gathered(logits, targets, model_group=None, vocab_size=None):
        return saved(tp.gather_vocab(logits, model_group, vocab_size),
                     targets)
    tw.token_cross_entropy = gathered
    try:
        yield
    finally:
        tw.token_cross_entropy = saved


def train_rank(out_dir: str, mesh: Mesh, mesh_name: str,
               device: str = "cuda") -> None:
    """One rank of the TP train step (on one process with no group where
    `mesh_name` is "one"): whisper-tiny (the test widths on the CPU),
    batch 2 over the data axis, float32, flash attention on the card.
    The first step from the same parameters through the logits gathered
    to every rank and through the vocab-parallel cross-entropy, each
    route's collectives counted; the two routes' largest gradient
    difference over its tolerance; then two more vocab-parallel steps,
    timed. Saves its mean losses, launches and rank 0's gradients to
    <out_dir>/train_<mesh>_rank<r>.pt."""
    from audio_transformers_tpu_torch.data.synthetic import SyntheticSeq2Seq
    from audio_transformers_tpu_torch.train import common, optim
    from audio_transformers_tpu_torch.train import whisper_emotion as tw

    dev = distributed.process_device(device)
    cfg = EmotionWhisperConfig(whisper=whisper_cfg("tiny", str(dev)),
                               num_emotion_classes=4)
    w = cfg.whisper
    mel_cfg = MelConfig.whisper()
    tcfg = TrainConfig(batch_size=2, compute_dtype="float32",
                       attn_impl="flash" if dev.type == "cuda" else "xla",
                       optimizer=OptimizerConfig(name="adamw",
                                                 learning_rate=1e-4,
                                                 schedule="constant",
                                                 grad_clip_norm=1.0))
    full = cp.to_device(cp.init(cfg, torch.Generator().manual_seed(0)), dev)
    axes = (emo.param_axes(full, cfg, mesh.model_size)
            if mesh.model_group is not None else None)
    ds = SyntheticSeq2Seq(
        num_samples=2, num_classes=4, vocab_size=w.vocab_size,
        max_label_len=24, duration=2 * w.max_source_positions
        * mel_cfg.hop_length / mel_cfg.sample_rate,
        bos_id=w.decoder_start_token_id, eos_id=w.eos_token_id,
        pad_id=w.pad_token_id)
    batch = common.batch_to_device(
        next(ds.batcher(2).train_epochs(epoch=0)), dev)
    res, grads = {"routes": {}}, {}
    for route in ("gathered", "parallel"):
        params = cp.set_trainable(cp.map_tensors(
            tp.shard_params(full, mesh.model_size, mesh.model_rank, axes)
            if axes is not None else full, lambda t: t.detach().clone()))
        opt = optim.build_optimizer(tcfg.optimizer, params,
                                    decay_mask=optim.frozen_leaf_decay_mask,
                                    model_group=mesh.model_group, axes=axes)
        step, _ = tw.make_steps(cfg, mel_cfg, tcfg, opt, dev, mesh)
        _build.reset_stats()
        with counted_collectives(dev, timed=False) as rec:
            if route == "gathered":
                with gathered_logits():
                    m = step(params, batch)
            else:
                m = step(params, batch)
        tree = cp.map_tensors(params, lambda t: (
            t.grad if t.grad is not None else torch.zeros_like(t)))
        grads[route] = dict(cp.leaves_with_path(
            tp.gather_params(tree, mesh.model_group, axes)
            if axes is not None else tree))
        res["routes"][route] = {
            "loss": common.mean_over_ranks(m, mesh)["loss"],
            "collectives": {k: v[0] for k, v in rec.items()}}
    res["launches"] = {k: (s.launches, s.plain_cuda_calls)
                       for k, s in _build.STATS.items()}
    res["loss"] = res["routes"]["parallel"]["loss"]
    res["route_grad_ratio"] = max(
        float((grads["parallel"][p] - g).abs().max())
        / (1e-4 * max(1.0, float(g.abs().max())))
        for p, g in grads["gathered"].items())
    if distributed.process_index() == 0:
        res["grads"] = {p: g.detach().cpu()
                        for p, g in grads["parallel"].items()}
    del grads
    # a second step, its collectives counted and timed (the card
    # synchronised around each), then a third timed alone
    with counted_collectives(dev, timed=True) as rec:
        t0 = time.perf_counter()
        step(params, batch)
        _sync(dev)
        res["timed_wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    step(params, batch)
    _sync(dev)
    res.update(wall_s=time.perf_counter() - t0, collectives=rec)
    torch.save(res, os.path.join(
        out_dir, f"train_{mesh_name}_rank{distributed.process_index()}.pt"))


def _load(out_dir, prefix, n):
    return [torch.load(os.path.join(out_dir, f"{prefix}_rank{r}.pt"),
                       weights_only=False) for r in range(n)]


def run_mesh(out_dir, mesh_name, size, dtypes, device, backend=None,
             rank_device=None, timed=True, train=False, beams=False,
             classifier=False) -> dict:
    """The checks of one mesh in one launch: the decode in each of
    `dtypes`, with `beams` the beam cases, with `classifier` the
    classifier step and with `train` the train step; returns {"decode":
    [the decodes' numbers], "beam": [...], "classifier": [...], "train":
    the train step's or None}. `device` is this process's (the one-card
    references), `rank_device` the ranks' (default `device`)."""
    n = {"model2": 2, "data2model2": 4, "model4": 4}[mesh_name]
    launch("tp_multicard:rank_main", n,
           [out_dir, mesh_name, size, list(dtypes), rank_device or device,
            backend, timed, train, beams, classifier],
           timeout=900, env={"PYTHONPATH": SCRIPTS, "OMP_NUM_THREADS": "1"})
    return {"decode": [_hold_mesh(out_dir, mesh_name, size, dtype, device, n,
                                  timed) for dtype in dtypes],
            "beam": [_hold_beams(out_dir, mesh_name, size, dtype, device, n,
                                 timed) for dtype in dtypes] if beams else [],
            "classifier": [_hold_classifier(out_dir, mesh_name, dtype,
                                            device, n) for dtype in dtypes]
            if classifier else [],
            "train": _hold_train(out_dir, mesh_name, device, n)
            if train else None}


def _hold_mesh(out_dir, mesh_name, size, dtype, device, n, timed) -> dict:
    ranks = _load(out_dir, f"decode_{mesh_name}_{size}_{dtype}", n)
    d = ranks[0]["mesh"][0]
    one = one_card_decode(size, dtype, d, device, timed)
    rows = hold_decode(one, ranks, dtype)
    r0 = ranks[0]
    per_step = {k: v[0] / r0["positions"] for k, v in
                r0["collectives"].items()}
    coll_s = sum(v[1] for v in r0["collectives"].values())
    for r in ranks:
        for k in ("decode_cross_attention", "fused_greedy_step_partials",
                  "log_mel"):
            if str(device).startswith("cuda") and r["launches"][k][0] == 0:
                raise AssertionError(f"{mesh_name}: rank {r['mesh']} did "
                                     f"not launch {k}")
            if r["launches"][k][1]:
                raise AssertionError(f"{k}'s plain version ran on CUDA")
        for b, e in r.get("k1_rows", {}).items():
            if e > K1_TOL_BF16:
                raise AssertionError(f"K1 at {b} x {r['mesh']} rows: {e}")
    fed = r0["positions"]   # the one card ran as many: same tokens
    times = {"ms_per_step": 1e3 * r0["wall_s"] / fed,
             "one_card_ms_per_step": 1e3 * one["wall_s"] / fed,
             "collective_ms_per_step": 1e3 * coll_s / fed,
             "collective_share": coll_s / r0["timed_wall_s"]} \
        if timed else {}
    return {"mesh": mesh_name, "size": size, "dtype": dtype,
            "card": r0["card"], "rows": rows, **times,
            "collectives_per_step": per_step,
            "launches_rank0": {k: r0["launches"][k][0] for k in
                               ("decode_cross_attention",
                                "fused_greedy_step_partials", "log_mel")},
            "k1_rows_err": {str(b): e for b, e in
                            r0.get("k1_rows", {}).items()}}


def _hold_train(out_dir, mesh_name, device, n) -> dict:
    ranks = _load(out_dir, f"train_{mesh_name}", n)
    train_rank(out_dir, Mesh(1, 0), "one", device)
    one = _load(out_dir, "train_one", 1)[0]
    r0 = ranks[0]
    rel = abs(r0["loss"] - one["loss"]) / abs(one["loss"])
    routes = r0["routes"]
    route_rel = abs(routes["gathered"]["loss"] - routes["parallel"]["loss"]) \
        / abs(routes["gathered"]["loss"])
    g_ratio = max(float((r0["grads"][p] - g).abs().max())
                  / (1e-4 * max(1.0, float(g.abs().max())))
                  for p, g in one["grads"].items())
    if rel > 1e-6 or route_rel > 1e-6:
        raise AssertionError(f"{mesh_name}: TP step loss {r0['loss']} "
                             f"against one card's {one['loss']} and the "
                             f"gathered route's {routes['gathered']['loss']}")
    if g_ratio > 1.0 or max(r["route_grad_ratio"] for r in ranks) > 1.0:
        raise AssertionError(f"{mesh_name}: TP step gradients at {g_ratio:.3g}"
                             f" of 1e-4 max(1, |g|) against one card's")
    if str(device).startswith("cuda"):
        for r in ranks:
            for k in ("log_mel", "flash_attention_fwd",
                      "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
                if r["launches"][k][0] == 0 or r["launches"][k][1]:
                    raise AssertionError(f"{mesh_name}: {k} {r['launches']}")
    return {"mesh": mesh_name, "loss": r0["loss"],
            "one_card_loss": one["loss"], "loss_rel": rel,
            "gathered_route_loss_rel": route_rel,
            "grad_share_of_tol": g_ratio,
            "route_grad_share_of_tol": max(r["route_grad_ratio"]
                                           for r in ranks),
            "collectives_per_step_gathered": routes["gathered"]["collectives"],
            "collectives_per_step_parallel": routes["parallel"]["collectives"],
            "ms_per_step": 1e3 * r0["wall_s"],
            "one_card_ms_per_step": 1e3 * one["wall_s"],
            "collectives_per_step": {k: v[0] for k, v in
                                     r0["collectives"].items()},
            "collective_ms_per_step": 1e3 * sum(
                v[1] for v in r0["collectives"].values()),
            "collective_share": sum(v[1] for v in r0["collectives"].values())
            / r0["timed_wall_s"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
            print("tp_multicard: needs 4 CUDA devices", file=sys.stderr)
            return 1
        import subprocess
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip()
        print(smi, flush=True)
        _build.build_all()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        device, dtypes = "cuda:0", ("float32", "bfloat16")
    else:
        device, dtypes = "cpu", ("float32",)
    results = []
    with tempfile.TemporaryDirectory(prefix="tp_multicard_") as out:
        for mesh_name, size, train, classifier in (
                ("model2", "tiny", True, False),
                ("data2model2", "tiny", True, True),
                ("model4", "base", False, True)):
            t0 = time.perf_counter()
            got = run_mesh(out, mesh_name, size, dtypes, device,
                           rank_device=args.device, train=train, beams=True,
                           classifier=classifier)
            for r in (got["decode"] + got["beam"] + got["classifier"]
                      + ([got["train"]] if got["train"] else [])):
                print(json.dumps(r), flush=True)
                results.append(r)
            print(f"{mesh_name} {size}: {time.perf_counter() - t0:.1f} s",
                  flush=True)
    print(json.dumps({"ok": True, "results": len(results)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
