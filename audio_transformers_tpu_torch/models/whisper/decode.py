"""KV-cached greedy decoding on PyTorch tensors.

The reference (`audio_transformers_tpu/models/whisper/decode.py`) runs the
whole decode as one compiled `lax.while_loop`. Here the loop runs on the
host, one decoder step per iteration, with the same early exit: it stops
once every row has emitted EOS (one host sync per step for that test),
then feeds the last token once more so the hidden state of the last
written position exists for pooling. Hidden states of positions never
fed stay zero, as in the reference; the emotion head pools over all of
them.

Every generated token comes from `ops.decode_logits.fused_greedy_step`:
the tied vocab projection, the additive suppress vector (static list,
begin-suppress at the first generated position, padded vocab tail), the
seen-mask repetition penalty and the no-repeat-ngram ban, then argmax.
On a CUDA device that is the hand-written kernel; on the CPU its plain
version. Positions inside the forced prompt take the prompt token and do
not call it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from audio_transformers_tpu_torch.core.config import (DecodeConfig,
                                                      WhisperConfig)
from audio_transformers_tpu_torch.models.whisper import model as wm
from audio_transformers_tpu_torch.ops import decode_logits as dl
from audio_transformers_tpu_torch.ops import logit_processors as lp

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


def _check_supported(dcfg: DecodeConfig) -> None:
    if dcfg.temperature and dcfg.temperature > 0.0:
        raise NotImplementedError("temperature sampling is not ported yet")
    if dcfg.return_timestamps:
        raise NotImplementedError("timestamped decoding is not ported yet")
    if dcfg.num_beams > 1:
        raise NotImplementedError("num_beams > 1 decodes through "
                                  "beam.generate_beam, not generate")


@torch.no_grad()
def generate(params: dict, cfg: WhisperConfig, dcfg: DecodeConfig,
             enc: torch.Tensor, *,
             prompt: Optional[Tuple[int, ...]] = None,
             suppress_ids: Tuple[int, ...] = ()) -> dict:
    """Greedy decode from encoder states enc (B, T, D). Returns a dict:
      tokens  (B, L) int32 - prompt + generated, pad after EOS
      hiddens (B, L, D)    - decoder last hidden per fed position (zero
                             for positions never fed)
      lengths (B,) int32   - valid token count incl. prompt and EOS
    """
    _check_supported(dcfg)
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
    cache = wm.init_cache(cfg, batch, max_len=length, dtype=enc.dtype,
                          device=dev, quant=self_quant)
    cross = wm.precompute_cross_attention(params, cfg, enc,
                                          quant=dcfg.kv_quant)
    step_params = wm.prepare_decode_params(params, cfg, dtype=enc.dtype)

    # the fused step's padded operands, built once outside the loop
    v_pad = dl.pad_vocab(cfg.vocab_size)
    table_t = torch.zeros((cfg.d_model, v_pad), dtype=enc.dtype, device=dev)
    table_t[:, :cfg.vocab_size] = step_params["embed"]["table"].t()
    add_base = lp.suppress_vector(v_pad, suppress_ids, vocab=cfg.vocab_size,
                                  device=dev)
    add_begin = lp.suppress_vector(v_pad, tuple(suppress_ids)
                                   + tuple(begin_suppress_ids),
                                   vocab=cfg.vocab_size, device=dev)
    # seen-token mask for the repetition penalty: seeded with position 0
    # and extended by every token written (prompt-forced and post-EOS pads
    # included), so it always marks exactly the ids in tokens[:, :pos]
    track_seen = dcfg.repetition_penalty != 1.0
    rows = torch.arange(batch, device=dev)
    seen = None
    if track_seen:
        seen = torch.zeros((batch, v_pad), dtype=torch.int8, device=dev)
        seen[rows, tokens[:, 0]] = 1
    n = dcfg.no_repeat_ngram_size
    use_ban = bool(n) and length >= n
    finished = torch.zeros(batch, dtype=torch.bool, device=dev)

    while cache["index"] < length - 1 and not bool(finished.all()):
        i = cache["index"]
        hidden, cache = wm.apply_decoder_step(step_params, cfg, tokens[:, i],
                                              cache, cross)
        hiddens[:, i] = hidden
        pos = i + 1   # position being generated
        if pos < p_len:
            nxt = prompt_t[pos].expand(batch)
        else:
            ban = (lp.ngram_ban_mask(tokens, pos, n, v_pad, finished)
                   if use_ban else None)
            nxt = dl.fused_greedy_step(
                hidden, table_t, add_begin if pos == p_len else add_base,
                seen=seen, ban=ban,
                penalty=dcfg.repetition_penalty).long()
            nxt = torch.where(finished, cfg.pad_token_id, nxt)
            finished |= nxt == cfg.eos_token_id
        tokens[:, pos] = nxt
        if track_seen:
            seen[rows, nxt] = 1

    # feed the final token once more for the last position's hidden state
    i = cache["index"]
    hidden, cache = wm.apply_decoder_step(step_params, cfg, tokens[:, i],
                                          cache, cross)
    hiddens[:, i] = hidden

    positions = torch.arange(length, device=dev)[None, :]
    is_eos = (tokens == cfg.eos_token_id) & (positions >= p_len)
    first_eos = is_eos.int().argmax(dim=1)
    lengths = torch.where(is_eos.any(dim=1), first_eos + 1, length)
    return {"tokens": tokens.to(torch.int32), "hiddens": hiddens,
            "lengths": lengths.to(torch.int32)}


def generate_with_fallback(params: dict, cfg: WhisperConfig,
                           dcfg: DecodeConfig, enc: torch.Tensor, *,
                           prompt: Optional[Tuple[int, ...]] = None,
                           suppress_ids: Tuple[int, ...] = (),
                           tokenizer=None) -> dict:
    """`generate`, then whisper's anti-repetition fallback: rows whose
    transcript's zlib compression ratio exceeds
    `dcfg.compression_ratio_threshold` would be re-decoded with
    temperature sampling. With no threshold (the pipeline's setting) the
    greedy result is returned unchanged; the re-decode itself is not
    ported yet and raises when a row is flagged."""
    import numpy as np

    from audio_transformers_tpu_torch.infer.metrics import \
        compression_ratio

    out = generate(params, cfg, dcfg, enc, prompt=prompt,
                   suppress_ids=suppress_ids)
    threshold = dcfg.compression_ratio_threshold
    if not threshold:
        return out
    p_len = len(prompt if prompt is not None else build_prompt(cfg, dcfg))
    tokens = out["tokens"].cpu().numpy()
    lengths = out["lengths"].cpu().numpy()
    for b in range(tokens.shape[0]):
        ids = tokens[b, p_len: int(lengths[b])]
        sample = (tokenizer.decode([int(t) for t in ids])
                  if tokenizer is not None else ids.astype(np.int32).tobytes())
        if compression_ratio(sample) > threshold:
            raise NotImplementedError(
                "the temperature re-decode of the fallback is not ported yet")
    return out
