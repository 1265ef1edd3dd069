"""KV-cached greedy and sampled decoding on PyTorch tensors.

The reference (`audio_transformers_tpu/models/whisper/decode.py`) runs the
whole decode as one compiled `lax.while_loop`. Here the loop runs on the
host, one decoder step per iteration, with the same early exit: it stops
once every row has emitted EOS (one host sync per step for that test),
then feeds the last token once more so the hidden state of the last
written position exists for pooling. Hidden states of positions never
fed stay zero, as in the reference; the emotion head pools over all of
them.

Every greedy token comes from `ops.decode_logits.fused_greedy_step`: the
tied vocab projection, the additive suppress vector (static list,
begin-suppress at the first generated position, padded vocab tail, and
<|notimestamps|> when timestamps are on), the seen-mask repetition
penalty, the no-repeat-ngram ban and, with `return_timestamps`, the
whisper timestamp rules (three bounds per row and the probability rule),
then argmax. On a CUDA device that is the hand-written kernel K2; on the
CPU its plain version. With `logits_impl="xla"`, and always with
`temperature` > 0 (`resolve_logits_impl`), the full (B, V) float32 logits
(`hidden @ table.T`, a plain product, as the reference leaves it to XLA)
go through `_process_logits`, the processor chain with the full timestamp
rule, and the token is their argmax (the lowest id wins a tie) or, when
sampling, `argmax(logits / T + g)` with Gumbel noise g (`gumbel_noise`),
which is what `jax.random.categorical` computes. `step_attn` picks the
decoder step's cross-attention (`model.resolve_step_attn`). Positions
inside the forced prompt take the prompt token.

Under tensor parallelism (`model_group`, the parameters this rank's shards
of `models/whisper/model.py:param_axes`) each rank runs the decoder step
on its heads and hidden units and K2 in its vocab-shard mode over its
columns of the padded table: one all-gather of the (B, 2..6) row partials
over the model group, then `merge_partials`, on every rank. The "xla"
logits, and so sampling, gather the rank's logits to the whole vocab
(`gather_vocab`); sampling draws the same noise on every rank (the
generator seeded alike). So every rank holds the same tokens and
`finished` flags, and leaves the loop at the same step.

With the recorder on (`core/tracing.py`), a greedy call is a
`decode.generate` span around `cross_kv`, `decode.prepare` (the
step-ready weights, padded table and masks; CUDA events on the card) and
one `decode.step` per loop iteration, which holds `decode.blocks` (the
decoder step), `decode.logits` (the token: K2 or the logits and
processors, the n-gram ban, the seen marks) and `decode.sync` (the loop's
one device read, the `finished` test). The counter `decode.steps` counts
the decoder steps, the final feed included.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

from audio_transformers_tpu_torch.core import tracing
from audio_transformers_tpu_torch.core.config import (DecodeConfig,
                                                      WhisperConfig)
from audio_transformers_tpu_torch.models.whisper import model as wm
from audio_transformers_tpu_torch.ops import decode_logits as dl
from audio_transformers_tpu_torch.ops import logit_processors as lp
from audio_transformers_tpu_torch.parallel import tensor as tp

# Begin-suppress defaults: " " and <|endoftext|> (whisper generation config).
_SPACE_TOKEN = 220

# The standard non-speech suppress list of the openai/whisper multilingual
# generation configs (v2 vocab, 51865 ids).
WHISPER_MULTILINGUAL_SUPPRESS: Tuple[int, ...] = (
    1, 2, 7, 8, 9, 10, 14, 25, 26, 27, 28, 29, 31, 58, 59, 60, 61, 62, 63,
    90, 91, 92, 93, 359, 503, 522, 542, 873, 893, 902, 918, 922, 931, 1350,
    1853, 1982, 2460, 2627, 3246, 3253, 3268, 3536, 3846, 3961, 4183, 4667,
    6585, 6647, 7273, 9061, 9383, 10428, 10929, 11938, 12033, 12331, 12562,
    13793, 14157, 14635, 15265, 15618, 16553, 16604, 18362, 18956, 20075,
    21675, 22520, 26130, 26161, 26435, 28279, 29464, 31650, 32302, 32470,
    36865, 42863, 47425, 49870, 50254, 50258, 50358, 50359, 50360, 50361,
    50362,
)


def default_suppress_ids(cfg: WhisperConfig) -> Tuple[int, ...]:
    """The non-speech suppress list a pretrained whisper checkpoint carries
    in its generation_config.json; empty for other vocabularies. large-v3
    (51866) shifts the specials from 50358 on by one."""
    if cfg.vocab_size == 51865:
        return WHISPER_MULTILINGUAL_SUPPRESS
    if cfg.vocab_size == 51866:
        return tuple(i + 1 if i >= 50358 else i
                     for i in WHISPER_MULTILINGUAL_SUPPRESS)
    return ()


def build_prompt(cfg: WhisperConfig, dcfg: DecodeConfig) -> Tuple[int, ...]:
    """The forced decoder prefix: <|startoftranscript|> [lang] [task]
    [<|notimestamps|>]."""
    prompt = [cfg.decoder_start_token_id]
    if dcfg.forced_language_token is not None:
        prompt.append(dcfg.forced_language_token)
    if dcfg.forced_task_token is not None:
        prompt.append(dcfg.forced_task_token)
    if not dcfg.return_timestamps:
        prompt.append(cfg.no_timestamps_token_id)
    return tuple(prompt)


def suppress_masks(vocab: int, suppress_ids: Sequence[int],
                   begin_suppress_ids: Sequence[int], device=None
                   ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(static, begin) (vocab,) bool masks for `_process_logits`: the
    suppress list, and the suppress list with the begin-suppress ids (the
    first generated position); None where a list is empty."""
    def mask(ids):
        if not len(ids):
            return None
        m = torch.zeros(vocab, dtype=torch.bool, device=device)
        m[torch.tensor(list(ids), device=device)] = True
        return m
    return (mask(tuple(suppress_ids)),
            mask(tuple(suppress_ids) + tuple(begin_suppress_ids)))


def _process_logits(logits: torch.Tensor, tokens: torch.Tensor, pos: int,
                    cfg: WhisperConfig, dcfg: DecodeConfig, prompt_len: int,
                    masks, *, seen: Optional[torch.Tensor] = None,
                    finished: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's processor chain on (B, V) float32 logits (or beam
    log-probs), in its order: suppress and begin-suppress (`masks`, from
    `suppress_masks`) set NEG_INF, the repetition penalty over `seen`
    ((B, V) 0/1: the ids of tokens[:, :pos]; needed when the penalty is
    on), the no-repeat-ngram ban (rows `finished` ban nothing), and with
    `return_timestamps` the full whisper timestamp rule."""
    static_mask, begin_mask = masks
    mask = begin_mask if pos == prompt_len else static_mask
    if mask is not None:
        logits = torch.where(mask, lp.NEG_INF, logits)
    if dcfg.repetition_penalty != 1.0:
        logits = lp.repetition_penalty(logits, seen, dcfg.repetition_penalty)
    n = dcfg.no_repeat_ngram_size
    if n and tokens.shape[1] >= n:
        ban = lp.ngram_ban_mask(tokens, pos, n, logits.shape[-1], finished)
        logits = torch.where(ban != 0, lp.NEG_INF, logits)
    if dcfg.return_timestamps:
        logits = lp.whisper_timestamp_rules(
            logits, tokens, pos, begin_index=prompt_len,
            timestamp_begin=cfg.timestamp_begin_id,
            eos_token_id=cfg.eos_token_id,
            no_timestamps_token_id=cfg.no_timestamps_token_id)
    return logits


def resolve_logits_impl(dcfg: DecodeConfig) -> str:
    """`DecodeConfig.logits_impl` -> "fused" (K2, `fused_greedy_step`) or
    "xla" (the logits materialised, `_process_logits`, argmax). Sampling
    always takes "xla", as in the reference: it needs the whole
    distribution, which K2 never materialises. "auto" is "fused" on every
    device (on the CPU K2's plain version runs); the reference's "auto"
    is its kernel on a TPU for some processor chains and XLA elsewhere.
    Anything else raises ValueError."""
    impl = dcfg.logits_impl
    if impl not in ("auto", "fused", "xla"):
        raise ValueError(f"unknown logits_impl {impl!r}")
    if dcfg.temperature and dcfg.temperature > 0.0:
        return "xla"
    return "fused" if impl == "auto" else impl


def gumbel_noise(shape: Tuple[int, ...],
                 generator: torch.Generator) -> torch.Tensor:
    """float32 Gumbel(0, 1) noise of `shape` on the generator's device:
    -log(-log(u)) with u uniform in [finfo.tiny, 1), as jax.random.gumbel
    draws it. The sampling loop of `generate` draws once per step, forced
    prompt steps included, as the reference splits its key once per step;
    a test replays the reference's noise by replacing this function."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


@torch.no_grad()
@tracing.spanned("decode.generate")
def generate(params: dict, cfg: WhisperConfig, dcfg: DecodeConfig,
             enc: torch.Tensor, *,
             prompt: Optional[Tuple[int, ...]] = None,
             suppress_ids: Tuple[int, ...] = (),
             generator: Optional[torch.Generator] = None,
             model_group=None) -> dict:
    """Greedy decode from encoder states enc (B, T, D), or with
    `dcfg.temperature` > 0 sampled decode, drawing from `generator` (on
    enc's device; a fresh one seeded 0 by default, as the reference's
    PRNGKey(0)). With a `model_group`, `params` are this rank's shards
    (tensor parallelism; a given generator must be seeded alike on every
    rank of the group). Returns a dict:
      tokens  (B, L) int32 - prompt + generated, pad after EOS
      hiddens (B, L, D)    - decoder last hidden per fed position (zero
                             for positions never fed)
      lengths (B,) int32   - valid token count incl. prompt and EOS
    """
    if dcfg.num_beams > 1:
        raise ValueError("num_beams > 1 decodes through "
                         "beam.generate_beam, not generate")
    sampling = bool(dcfg.temperature and dcfg.temperature > 0.0)
    fused = resolve_logits_impl(dcfg) == "fused"
    step_attn = wm.resolve_step_attn(dcfg.step_attn)
    if prompt is None:
        prompt = build_prompt(cfg, dcfg)
    p_len = len(prompt)
    batch, dev = enc.shape[0], enc.device
    length = min(p_len + dcfg.max_new_tokens, cfg.max_target_positions)
    # whisper generation-config default: " " and EOS are suppressed at the
    # first generated position
    begin_suppress_ids = ((_SPACE_TOKEN, cfg.eos_token_id)
                          if dcfg.suppress_blank else ())

    prompt_t = torch.tensor(prompt, dtype=torch.long, device=dev)
    tokens = torch.full((batch, length), cfg.pad_token_id, dtype=torch.long,
                        device=dev)
    tokens[:, :p_len] = prompt_t
    hiddens = torch.zeros((batch, length, cfg.d_model), dtype=enc.dtype,
                          device=dev)
    self_quant = dcfg.kv_quant if length >= dcfg.self_kv_min else "none"
    if self_quant == "int4":
        self_quant = "int8"   # int4 covers only the cross K/V
    t_size = tp.model_size(model_group)
    cache = wm.init_cache(cfg, batch, max_len=length, dtype=enc.dtype,
                          device=dev, quant=self_quant, model_size=t_size)
    cross = wm.precompute_cross_attention(params, cfg, enc,
                                          quant=dcfg.kv_quant)
    with tracing.span("decode.prepare", device=dev):
        step_params = wm.prepare_decode_params(params, cfg, dtype=enc.dtype)
        # the rank's columns [v0, v0 + width) of the padded vocab
        v0, v1, width = tp.vocab_shard(cfg.vocab_size, t_size,
                                       tp.model_rank(model_group))
        if fused:
            # the fused step's padded operands, built once outside the
            # loop: the rank's columns of the padded table, bias and masks
            v_pad = dl.pad_vocab(cfg.vocab_size)
            table_t = torch.zeros((cfg.d_model, width), dtype=enc.dtype,
                                  device=dev)
            table_t[:, :v1 - v0] = step_params["embed"]["table"].t()
            # the timestamp rules' one position-independent mask:
            # <|notimestamps|> is always suppressed
            static_ids = tuple(suppress_ids) + (
                (cfg.no_timestamps_token_id,) if dcfg.return_timestamps
                else ())
            add_base = lp.suppress_vector(
                v_pad, static_ids, vocab=cfg.vocab_size,
                device=dev)[v0:v0 + width].clone()
            add_begin = lp.suppress_vector(
                v_pad, static_ids + tuple(begin_suppress_ids),
                vocab=cfg.vocab_size, device=dev)[v0:v0 + width].clone()
            ts_begin = (cfg.timestamp_begin_id if dcfg.return_timestamps
                        else None)
        else:
            # compute-dtype values
            table = step_params["embed"]["table"].float()
            masks = suppress_masks(cfg.vocab_size, suppress_ids,
                                   begin_suppress_ids, dev)
        if sampling and generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        # seen-token mask for the repetition penalty: seeded with position
        # 0 and extended by every token written (prompt-forced and post-EOS
        # pads included), so it always marks exactly the ids in
        # tokens[:, :pos]
        track_seen = dcfg.repetition_penalty != 1.0
        rows = torch.arange(batch, device=dev)
        seen = None
        if track_seen:
            seen = torch.zeros((batch, width), dtype=torch.int8, device=dev)
            _mark_seen(seen, rows, tokens[:, 0], v0, model_group)
        n = dcfg.no_repeat_ngram_size
        use_ban = bool(n) and length >= n
        finished = torch.zeros(batch, dtype=torch.bool, device=dev)

    def next_token(hidden, pos):
        """The (B,) tokens at `pos`: the forced prompt, K2, or the logits
        and processors (with the step's noise when sampling)."""
        if sampling:
            noise = gumbel_noise((batch, cfg.vocab_size), generator)
        if pos < p_len:
            return prompt_t[pos].expand(batch)
        if not fused:
            logits = tp.gather_vocab(torch.matmul(hidden.float(), table.t()),
                                     model_group, cfg.vocab_size)
            logits = _process_logits(
                logits, tokens, pos, cfg, dcfg, p_len, masks,
                seen=(_whole_seen(seen, model_group, cfg.vocab_size)
                      if track_seen else None),
                finished=finished)
            if sampling:
                logits = logits / dcfg.temperature + noise
            return torch.argmax(logits, dim=-1)
        ban = (lp.ngram_ban_mask(tokens, pos, n, width, finished,
                                 offset=None if model_group is None
                                 else v0)
               if use_ban else None)
        ts_bounds = None
        if dcfg.return_timestamps:
            ts_bounds = lp.timestamp_row_bounds(
                tokens, pos, begin_index=p_len,
                timestamp_begin=cfg.timestamp_begin_id,
                eos_token_id=cfg.eos_token_id)
        step = functools.partial(
            dl.fused_greedy_step, hidden, table_t,
            add_begin if pos == p_len else add_base, seen=seen, ban=ban,
            penalty=dcfg.repetition_penalty, ts_bounds=ts_bounds,
            timestamp_begin=ts_begin)
        if model_group is None:
            return step().long()
        return dl.merge_partials(_gather_rows(
            step(vocab_offset=v0, partials=True), model_group)).long()

    def feed(i):
        """The decoder step on the token at `i`: its hidden state kept,
        its K/V written to the cache."""
        nonlocal cache
        with tracing.span("decode.blocks"):
            hidden, cache = wm.apply_decoder_step(
                step_params, cfg, tokens[:, i], cache, cross,
                model_group=model_group, step_attn=step_attn)
            hiddens[:, i] = hidden
        tracing.count("decode.steps")
        return hidden

    done = batch == 0   # finished.all() of no rows
    while cache["index"] < length - 1 and not done:
        with tracing.span("decode.step"):
            i = cache["index"]
            hidden = feed(i)
            pos = i + 1   # position being generated
            with tracing.span("decode.logits"):
                nxt = next_token(hidden, pos)
                if pos >= p_len:
                    nxt = torch.where(finished, cfg.pad_token_id, nxt)
                    finished |= nxt == cfg.eos_token_id
                tokens[:, pos] = nxt
                if track_seen:
                    _mark_seen(seen, rows, nxt, v0, model_group)
            # the loop's one device read, after the step's launches
            with tracing.span("decode.sync"):
                done = bool(finished.all())

    # feed the final token once more for the last position's hidden state
    feed(cache["index"])

    positions = torch.arange(length, device=dev)[None, :]
    is_eos = (tokens == cfg.eos_token_id) & (positions >= p_len)
    first_eos = is_eos.int().argmax(dim=1)
    lengths = torch.where(is_eos.any(dim=1), first_eos + 1, length)
    return {"tokens": tokens.to(torch.int32), "hiddens": hiddens,
            "lengths": lengths.to(torch.int32)}


def _mark_seen(seen: torch.Tensor, rows: torch.Tensor, ids: torch.Tensor,
               v0: int, group) -> None:
    """Marks ids (B,) in the seen mask; under a model `group` the mask is
    the vocab columns [v0, v0 + width), and ids outside them leave it as
    it is."""
    if group is None:
        seen[rows, ids] = 1
        return
    local = ids - v0
    hit = ((local >= 0) & (local < seen.shape[1])).to(seen.dtype)
    local = local.clamp(0, seen.shape[1] - 1)
    seen[rows, local] = seen[rows, local] | hit


def _whole_seen(seen: torch.Tensor, group, vocab: int) -> torch.Tensor:
    """The (B, vocab) seen mask from every rank's columns."""
    if group is None:
        return seen[:, :vocab]
    start, stop, _ = tp.vocab_shard(vocab, tp.model_size(group),
                                    tp.model_rank(group))
    return tp.gather_vocab(seen[:, :stop - start].float(), group, vocab)


def _gather_rows(parts: torch.Tensor, group) -> torch.Tensor:
    """(t, B, K): every model rank's (B, K) row partials, in rank order."""
    return torch.stack(tp.all_gather(parts, group))


def generate_with_fallback(params: dict, cfg: WhisperConfig,
                           dcfg: DecodeConfig, enc: torch.Tensor, *,
                           prompt: Optional[Tuple[int, ...]] = None,
                           suppress_ids: Tuple[int, ...] = (),
                           tokenizer=None,
                           generator: Optional[torch.Generator] = None,
                           fallback_temperature: float = 0.7,
                           model_group=None) -> dict:
    """`generate`, then whisper's anti-repetition fallback: rows whose
    transcript's zlib compression ratio exceeds
    `dcfg.compression_ratio_threshold` (of the tokenizer's text, or else
    of the int32 id bytes) are decoded again with temperature sampling
    (0.7, from `generator`, by default seeded 0 as the reference's
    PRNGKey(0)) and merged back. A threshold of None or 0 turns it off.

    The reference gathers the flagged rows into a power-of-two bucket, a
    fixed compile shape for the TPU; the port decodes exactly the flagged
    rows again. Rows are independent, so the tokens are the same."""
    import numpy as np

    from audio_transformers_tpu_torch.infer.metrics import \
        compression_ratio

    out = generate(params, cfg, dcfg, enc, prompt=prompt,
                   suppress_ids=suppress_ids, model_group=model_group)
    threshold = dcfg.compression_ratio_threshold
    if not threshold:
        return out
    if prompt is None:
        prompt = build_prompt(cfg, dcfg)
    p_len = len(prompt)
    tokens = out["tokens"].cpu().numpy()
    lengths = out["lengths"].cpu().numpy()
    flagged = []
    for b in range(tokens.shape[0]):
        ids = tokens[b, p_len: int(lengths[b])]
        sample = (tokenizer.decode([int(t) for t in ids])
                  if tokenizer is not None else ids.astype(np.int32).tobytes())
        if compression_ratio(sample) > threshold:
            flagged.append(b)
    if not flagged:
        return out
    idx = torch.tensor(flagged, device=enc.device)
    hot = dcfg.replace(temperature=fallback_temperature)
    resampled = generate(params, cfg, hot, enc[idx], prompt=prompt,
                         suppress_ids=suppress_ids, generator=generator,
                         model_group=model_group)
    merged = dict(out)
    for k in ("tokens", "hiddens", "lengths"):
        merged[k] = out[k].index_copy(0, idx, resampled[k])
    return merged
