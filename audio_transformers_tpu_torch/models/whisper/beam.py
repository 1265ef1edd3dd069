"""Beam-search decoding on PyTorch tensors.

The port of `audio_transformers_tpu/models/whisper/beam.generate_beam`:
HF `BeamSearchScorer` semantics (transformers/generation/beam_search.py),
held token for token to the reference and, through it, to HF
`generate(num_beams=N)`:

  - scores are log-softmaxed BEFORE the logit processors
    (`decode._process_logits`); suppress and begin-suppress REPLACE the
    masked log-probs by NEG_INF, the repetition penalty acts on log-probs,
    the no-repeat-ngram ban skips finished rows, and with
    `return_timestamps` the whisper timestamp rule, its probability rule
    included, acts on the log-probs;
  - 2N candidates per step, in lax.top_k's stable first-occurrence order;
    EOS candidates ranked in the top N retire to a kept-N hypothesis set
    with replace-the-worst updates (HF BeamHypotheses), non-EOS candidates
    fill the N continuing beams in rank order;
  - a retired hypothesis scores sum_logprobs / generated_len**lp, with
    generated_len counting the EOS;
  - a batch row is done when it holds N hypotheses and (early_stopping)
    or (the best running score over the current length cannot beat the
    worst kept one); beams stay frozen through the forced prompt and once
    their row is done;
  - at budget exhaustion the N running beams are offered to the set with
    the same rule;
  - `hiddens` come from one teacher-forced `apply_decoder` over the
    winners, so positions after EOS are not zero, unlike greedy.

The reference runs the search as one compiled `lax.while_loop`. Here the
loop runs on the host, one decoder step per iteration, with one host sync
per step (the all-rows-done test), as the greedy loop has. Beams live as
B*N decoder rows; the cross K/V stays at B rows, shared by the beams of a
row (`model.apply_decoder_step(beams=N)`). Every step reorders each
per-beam buffer (the self K/V of every layer, their scales in int8 mode,
the seen mask and the token rows) by the chosen parents in ONE launch of
the row-gather kernel K5 (`ops.permute.permute_rows`), into a second set
of buffers allocated once; then the two sets swap. The port's cache is
written in place, so it cannot be gathered in place.

Under tensor parallelism (a `model_group`; `params` this rank's shards,
`emotion.param_axes`) each rank keeps the self and cross K/V of its
heads and runs the decoder step on them (its o and fc2 projections end
in an all-reduce, so the hidden state is whole on every rank). The step
gathers the rank's vocab shard of the logits to whole rows
(`tensor.gather_vocab`, B*N x V floats a step); every rank then runs the
same log-softmax, processors, top-k and hypothesis bookkeeping on the
same numbers, keeps the whole-vocab seen mask, and so picks the same
parents and tokens: K5 reorders each rank's own caches with them, one
launch a step on every rank. `check_ranks` compares a checksum of them
over the group every step (a debug check: it costs a collective and a
host sync a step).
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from audio_transformers_tpu_torch.core.config import (DecodeConfig,
                                                      WhisperConfig)
from audio_transformers_tpu_torch.models.whisper import model as wm
from audio_transformers_tpu_torch.models.whisper.decode import (
    _SPACE_TOKEN, _process_logits, build_prompt, suppress_masks)
from audio_transformers_tpu_torch.ops.decode_logits import pad_vocab
from audio_transformers_tpu_torch.ops.permute import permute_rows
from audio_transformers_tpu_torch.parallel import tensor as tp

_SCORE_FLOOR = -1.0e9   # HF's initial score for beams 1..N-1
_EMPTY = -1.0e30        # empty hypothesis slot (any real score beats it)
_BUCKET = 128           # row width of one bucket in `_stable_top_k`


def resolve_beam_reorder(impl: str) -> str:
    """"auto" and "pallas" -> "pallas": the row-gather kernel K5
    (`ops.permute.permute_rows`; its plain version on the CPU), the only
    reorder of the port. The reference's "take" (a gather per buffer, its
    A/B baseline) is K5's plain version `ops.permute.permute_rows_reference`
    here, and its "mm" (a one-hot matrix product) works around XLA's
    lowering of a row gather inside a TPU while-loop; neither is an
    option of the port."""
    if impl in ("auto", "pallas"):
        return "pallas"
    if impl in ("take", "mm"):
        raise NotImplementedError(
            f"beam_reorder={impl!r} is not ported: the port reorders with "
            f"the K5 copy ('auto'/'pallas'); 'take' is its plain version "
            f"permute_rows_reference, and 'mm' a one-hot matrix product "
            f"that works around XLA's in-loop row gather on the TPU")
    raise ValueError(f"unknown beam_reorder {impl!r}")


def resolve_beam_topk(impl: str) -> str:
    """"auto" and "merged" -> "merged": HF's (B, N*V) candidate buffer, the
    reference's choice off the TPU and the only one of the port. The
    reference's "perbeam" (top-k of each beam's row before adding its
    score, its TPU choice) may order a rounding-made tie differently and
    is not ported."""
    if impl in ("auto", "merged"):
        return "merged"
    if impl == "perbeam":
        raise NotImplementedError(
            "beam_topk='perbeam' is the reference's TPU choice; the port "
            "takes the top 2N of the merged (B, N*V) buffer ('auto'/"
            "'merged')")
    raise ValueError(f"unknown beam_topk {impl!r}")


def _masked_argmax_top_k(x: torch.Tensor, k: int):
    """Exact top-k over the last axis of (B, n) x in lax.top_k's stable
    first-occurrence tie order: k argmax passes, each masking its winner
    to -inf (`torch.argmax` returns the first maximum). Returns (B, k)
    values and int64 indices."""
    cur = x.clone()
    vals, idxs = [], []
    for _ in range(k):
        i = cur.argmax(dim=-1, keepdim=True)
        vals.append(cur.gather(1, i))
        idxs.append(i)
        cur.scatter_(1, i, float("-inf"))
    return torch.cat(vals, dim=1), torch.cat(idxs, dim=1)


def _stable_top_k(x: torch.Tensor, k: int):
    """Exact stable top-k, as `_masked_argmax_top_k`, reading the (B, n)
    buffer once: reduce 128-wide buckets to their maxima, take the top-k
    buckets (earliest first on ties), gather their k*128 candidates in
    ascending bucket order, and finish on that small union. Every bucket
    holding a top-k element has a maximum >= the k-th value, and at most
    k-1 buckets lie strictly above it, so the union holds every first
    occurrence of the top-k values in the original order."""
    b, n = x.shape
    nb = -(-n // _BUCKET)
    if nb <= 2 * k:
        return _masked_argmax_top_k(x, k)
    pad = nb * _BUCKET - n
    xp = F.pad(x, (0, pad), value=float("-inf")) if pad else x
    xb = xp.reshape(b, nb, _BUCKET)
    _, bidx = _masked_argmax_top_k(xb.amax(dim=-1), k)
    bsel = bidx.sort(dim=1).values                        # ascending
    cand = xb.gather(1, bsel[:, :, None].expand(b, k, _BUCKET)).reshape(
        b, k * _BUCKET)
    vals, ci = _masked_argmax_top_k(cand, k)
    return vals, bsel.gather(1, ci // _BUCKET) * _BUCKET + ci % _BUCKET


def _offer(hyp_tokens, hyp_scores, hyp_lens, accept, norm, hist, length):
    """Replace-the-worst hypothesis update, in place (HF BeamHypotheses.add:
    add iff fewer than N are kept or the score beats the worst; empty slots
    at _EMPTY make both one rule). accept and norm (B,), hist (B, L),
    length an int."""
    b = torch.arange(hyp_scores.shape[0], device=hyp_scores.device)
    worst = hyp_scores.argmin(dim=1)
    cur_worst = hyp_scores[b, worst]
    do = accept & (norm > cur_worst)
    hyp_tokens[b, worst] = torch.where(do[:, None], hist,
                                       hyp_tokens[b, worst])
    hyp_scores[b, worst] = torch.where(do, norm, cur_worst)
    hyp_lens[b, worst] = torch.where(do, length, hyp_lens[b, worst])


def _length_norm(generated: int, length_penalty: float) -> float:
    """max(generated, 1) ** length_penalty in float32, as the reference."""
    return float(np.float32(max(generated, 1)) ** np.float32(length_penalty))


def _check_ranks(parent: torch.Tensor, tokens: torch.Tensor, group) -> None:
    """Raises unless every rank of the model `group` holds these parents
    and tokens: a checksum of each, compared over the group."""
    w = torch.arange(1, parent.numel() + 1, device=parent.device)
    mine = torch.stack([(parent.reshape(-1) * w).sum(),
                        (tokens.reshape(-1) * w).sum()])
    if not all(torch.equal(x, mine) for x in tp.all_gather(mine, group)):
        raise AssertionError("the model ranks chose different beams")


@torch.no_grad()
def generate_beam(params: dict, cfg: WhisperConfig, dcfg: DecodeConfig,
                  enc: torch.Tensor, *,
                  prompt: Optional[Tuple[int, ...]] = None,
                  suppress_ids: Tuple[int, ...] = (),
                  begin_suppress_ids: Optional[Tuple[int, ...]] = None,
                  max_len: Optional[int] = None, model_group=None,
                  check_ranks: bool = False) -> dict:
    """Beam-search decode from encoder states enc (B, T, D). Returns a dict
    shaped like `decode.generate`'s:
      tokens  (B, L) int32 - the best hypothesis, pad after EOS
      hiddens (B, L, D)    - teacher-forced decoder hiddens of `tokens`
      lengths (B,) int32   - valid token count incl. prompt and EOS
    plus the kept set: beam_tokens (B, N, L) int32, beam_scores (B, N)
    float32 (length-normalized, empty slots at -1e30) and beam_lengths
    (B, N) int32. With a `model_group`, `params` are this rank's shards
    and every rank returns the same results (see the module note);
    `check_ranks` then asserts every step that the ranks chose the same
    parents and tokens."""
    n_beams = dcfg.num_beams
    if n_beams < 2:
        raise ValueError("generate_beam needs num_beams >= 2; use "
                         "decode.generate for greedy decoding")
    if dcfg.temperature and dcfg.temperature > 0.0:
        raise ValueError("beam search is deterministic; temperature>0 "
                         "with num_beams>1 is not supported")
    if dcfg.kv_quant == "int4":
        warnings.warn(
            "num_beams>1 with kv_quant='int4' dequantizes the cross K/V "
            "to float32 for the beams' batched products (the nibble-packed "
            "layout has none) — prefer kv_quant='int8' when beam-decoding "
            "for speed",
            stacklevel=2)
    resolve_beam_reorder(dcfg.beam_reorder)
    resolve_beam_topk(dcfg.beam_topk)
    if prompt is None:
        prompt = build_prompt(cfg, dcfg)
    p_len = len(prompt)
    batch, dev = enc.shape[0], enc.device
    n_rows = batch * n_beams
    vocab = cfg.vocab_size
    length = max_len or min(p_len + dcfg.max_new_tokens,
                            cfg.max_target_positions)
    if begin_suppress_ids is None:
        begin_suppress_ids = ((_SPACE_TOKEN, cfg.eos_token_id)
                              if dcfg.suppress_blank else ())

    tokens = torch.full((n_rows, length), cfg.pad_token_id, dtype=torch.long,
                        device=dev)
    tokens[:, :p_len] = torch.tensor(prompt, dtype=torch.long, device=dev)
    # HF's beam-score init: beam 0 at 0, the rest at -1e9, so that the
    # identical post-prompt beams do not fill the first top-k
    scores = torch.full((batch, n_beams), _SCORE_FLOOR, dtype=torch.float32,
                        device=dev)
    scores[:, 0] = 0.0
    # beams gate self-KV quantization on beam_self_kv_min (default 0)
    self_quant = dcfg.kv_quant if length >= dcfg.beam_self_kv_min else "none"
    if self_quant == "int4":
        self_quant = "int8"      # int4 covers only the cross K/V
    cache = wm.init_cache(cfg, n_rows, max_len=length, dtype=enc.dtype,
                          device=dev, quant=self_quant,
                          model_size=tp.model_size(model_group))
    cross = wm.beam_cross(wm.precompute_cross_attention(
        params, cfg, enc, quant=dcfg.kv_quant))
    sp = wm.prepare_decode_params(params, cfg, dtype=enc.dtype)
    table = sp["embed"]["table"].float()     # compute-dtype values, exact

    hyp_tokens = torch.full((batch, n_beams, length), cfg.pad_token_id,
                            dtype=torch.long, device=dev)
    hyp_scores = torch.full((batch, n_beams), _EMPTY, dtype=torch.float32,
                            device=dev)
    hyp_lens = torch.zeros((batch, n_beams), dtype=torch.long, device=dev)
    done = torch.zeros(batch, dtype=torch.bool, device=dev)

    rows = torch.arange(n_rows, device=dev)
    b_idx = torch.arange(batch, device=dev)
    beam_iota = torch.arange(n_beams, device=dev)[None, :]
    masks = suppress_masks(vocab, suppress_ids, begin_suppress_ids, dev)
    # seen-token mask for the repetition penalty, int8 at the padded vocab
    # width so that its rows stay 16-byte aligned for the reorder
    track_seen = dcfg.repetition_penalty != 1.0
    seen = None
    if track_seen:
        seen = torch.zeros((n_rows, pad_vocab(vocab)), dtype=torch.int8,
                           device=dev)
        seen[rows, tokens[:, 0]] = 1

    # every per-beam buffer, flattened for one reorder launch per step,
    # and a second set of the same buffers to gather into
    keys = [k for k in ("k", "v", "k_scale", "v_scale") if k in cache]
    n_layers = cfg.decoder_layers

    def flat(cache, seen, tokens):
        return ([a for k in keys for a in cache[k]]
                + ([seen] if track_seen else []) + [tokens])

    def unflat(bufs, old):
        c = {k: bufs[j * n_layers:(j + 1) * n_layers]
             for j, k in enumerate(keys)}
        c["index"], c["pos"] = old["index"], old["pos"]
        return c, (bufs[-2] if track_seen else None), bufs[-1]

    spare = [torch.empty_like(a) for a in flat(cache, seen, tokens)]

    while cache["index"] < length - 1 and not bool(done.all()):
        i = cache["index"]
        hidden, cache = wm.apply_decoder_step(sp, cfg, tokens[:, i], cache,
                                              cross, beams=n_beams,
                                              model_group=model_group)
        pos = i + 1
        logits = tp.gather_vocab(torch.matmul(hidden.float(), table.t()),
                                 model_group, vocab)
        logp = _process_logits(
            torch.log_softmax(logits, dim=-1),
            tokens, pos, cfg, dcfg, p_len, masks,
            seen=seen[:, :vocab] if track_seen else None,
            finished=done.repeat_interleave(n_beams))

        cand = (logp + scores.reshape(n_rows, 1)).reshape(
            batch, n_beams * vocab)
        top_s, top_i = _stable_top_k(cand, 2 * n_beams)
        cand_beam = top_i // vocab
        cand_tok = top_i % vocab
        is_eos = cand_tok == cfg.eos_token_id

        # continuing beams: the first N non-EOS candidates, in rank order
        rank_ne = torch.cumsum(~is_eos, dim=1)              # 1-based
        slot = torch.where(~is_eos & (rank_ne <= n_beams), rank_ne - 1,
                           n_beams)                         # N = drop
        sel = torch.zeros((batch, n_beams + 1), dtype=torch.long,
                          device=dev).scatter_(
            1, slot, torch.arange(2 * n_beams, device=dev).expand(
                batch, -1))[:, :n_beams]
        nxt_scores = top_s.gather(1, sel)
        nxt_tok = cand_tok.gather(1, sel)
        parent = cand_beam.gather(1, sel)

        # EOS candidates ranked in the top N retire, in rank order
        in_prompt = pos < p_len
        denom = _length_norm(pos + 1 - p_len, dcfg.length_penalty)
        if not in_prompt:
            tok3 = tokens.reshape(batch, n_beams, length)
            for j in range(n_beams):
                hist = tok3[b_idx, cand_beam[:, j]]
                hist[:, pos] = cfg.eos_token_id
                _offer(hyp_tokens, hyp_scores, hyp_lens,
                       is_eos[:, j] & ~done, top_s[:, j] / denom, hist,
                       pos + 1)
            # stop rule (HF BeamHypotheses.is_done)
            full = (hyp_scores > _EMPTY / 2).sum(dim=1) == n_beams
            if dcfg.early_stopping:
                done = done | full
            else:
                done = done | (full & (hyp_scores.amin(dim=1)
                                       >= top_s[:, 0] / denom))

        # forced prompt and finished rows: freeze the beams
        if in_prompt:
            nxt_tok = torch.full_like(nxt_tok, prompt[pos])
        freeze = done[:, None] | in_prompt
        nxt_tok = torch.where(done[:, None], cfg.pad_token_id, nxt_tok)
        parent = torch.where(freeze, beam_iota, parent)
        scores = torch.where(freeze, scores, nxt_scores)

        if check_ranks and model_group is not None:
            _check_ranks(parent, nxt_tok, model_group)
        # reorder every per-beam buffer by its parent (HF _reorder_cache)
        # into the spare set, swap, then append this step's tokens
        flat_parent = (b_idx[:, None] * n_beams + parent).reshape(-1)
        bufs = flat(cache, seen, tokens)
        gathered = permute_rows(bufs, flat_parent, out=spare)
        spare = bufs
        cache, seen, tokens = unflat(gathered, cache)
        nxt = nxt_tok.reshape(-1)
        tokens[:, pos] = nxt
        if track_seen:
            seen[rows, nxt] = 1

    # budget exhausted: offer the N running beams (HF finalize), beam 0
    # first; no EOS is appended
    fin_len = cache["index"] + 1
    denom = _length_norm(fin_len - p_len, dcfg.length_penalty)
    tok3 = tokens.reshape(batch, n_beams, length)
    for n in range(n_beams):
        _offer(hyp_tokens, hyp_scores, hyp_lens, ~done, scores[:, n] / denom,
               tok3[:, n], fin_len)

    best = hyp_scores.argmax(dim=1)
    out_tokens = hyp_tokens[b_idx, best]
    out_lens = hyp_lens[b_idx, best]
    # hiddens for pooling: one teacher-forced pass over the winners
    hiddens = wm.apply_decoder(params, cfg, enc, out_tokens, attn_impl="xla",
                               model_group=model_group)
    return {"tokens": out_tokens.to(torch.int32),
            "hiddens": hiddens.to(enc.dtype),
            "lengths": out_lens.to(torch.int32),
            "beam_tokens": hyp_tokens.to(torch.int32),
            "beam_scores": hyp_scores,
            "beam_lengths": hyp_lens.to(torch.int32)}
