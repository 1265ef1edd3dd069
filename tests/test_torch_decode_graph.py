"""The decoder step's static form on the CPU, at WhisperConfig.test()'s
widths: the step body (`model._decoder_step`) writes the column of the
cache's device position alone, in the float32 and bfloat16 caches and
the int8 self cache, and that position advances with the host index;
what lies in the cache's columns past the position never reaches the
step; a capture's launch counts are its own thread's; and `generate`
off the card captures nothing.
The captured decode itself is held to the eager loop on the card, in
`tests/test_torch_cuda.py`.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from audio_transformers_tpu_torch.core import params as cp
from audio_transformers_tpu_torch.core import tracing
from audio_transformers_tpu_torch.core.config import (DecodeConfig,
                                                      EmotionWhisperConfig,
                                                      WhisperConfig)
from audio_transformers_tpu_torch.models.whisper import decode as dec
from audio_transformers_tpu_torch.models.whisper import model as wm

W = WhisperConfig.test()
LENGTH = 8
BATCH = 3


@pytest.fixture(scope="module")
def params():
    cfg = EmotionWhisperConfig(whisper=W, num_emotion_classes=4)
    return cp.init(cfg, torch.Generator().manual_seed(0))["whisper"]


@pytest.fixture(scope="module")
def enc(params):
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (BATCH, 2 * W.max_source_positions, W.n_mels)).astype(np.float32))
    with torch.no_grad():
        return wm.encode(params, W, mel)


def _tokens(seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, W.vocab_size, (LENGTH, BATCH)))


def _buffers(cache):
    return {(k, i): t for k in ("k", "v", "k_scale", "v_scale")
            for i, t in enumerate(cache.get(k, []))}


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("step_attn", ["fused", "xla"])
def test_step_writes_the_column_of_its_device_position(params, enc, quant,
                                                       dtype, step_attn):
    """The step reads its position from the cache's 0-d tensor, which
    advances with the host index; the body (`model._decoder_step`, the
    part a captured step holds) writes that column alone and leaves both
    indices as they are."""
    sp = wm.prepare_decode_params(params, W, dtype=dtype)
    cross = wm.precompute_cross_attention(params, W, enc.to(dtype))
    cache = wm.init_cache(W, BATCH, max_len=LENGTH, dtype=dtype, quant=quant)
    toks = _tokens(1)
    with torch.no_grad():
        for pos in range(LENGTH):
            assert cache["pos"].dtype == torch.long
            assert cache["pos"].shape == () and int(cache["pos"]) == pos
            before = {k: t.clone() for k, t in _buffers(cache).items()}
            h_body = wm._decoder_step(sp, W, toks[pos], cache, cross,
                                      step_attn=step_attn)
            assert cache["index"] == int(cache["pos"]) == pos
            for key, t in _buffers(cache).items():
                assert t[..., pos].abs().sum() > 0, (pos, key)
                assert torch.equal(t[..., :pos], before[key][..., :pos])
                assert not t[..., pos + 1:].any(), (pos, key)
            for key, t in before.items():      # the same step, stepped
                _buffers(cache)[key].copy_(t)
            h_step, cache = wm.apply_decoder_step(sp, W, toks[pos], cache,
                                                  cross, step_attn=step_attn)
            assert h_step.dtype == dtype
            assert torch.equal(h_body, h_step), pos
    assert cache["index"] == int(cache["pos"]) == LENGTH


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_columns_past_the_position_never_reach_the_step(params, enc, quant):
    """The step attends over the whole static cache; columns past its
    position are masked to probability 0, so whatever they hold (here
    large values where the clean cache holds zeros) changes nothing."""
    sp = wm.prepare_decode_params(params, W)
    cross = wm.precompute_cross_attention(params, W, enc)
    clean, dirty = (wm.init_cache(W, BATCH, max_len=LENGTH, quant=quant)
                    for _ in range(2))
    gen = torch.Generator().manual_seed(2)
    for t in _buffers(dirty).values():
        t.copy_((torch.randn(t.shape, generator=gen) * 100).to(t.dtype))
    toks = _tokens(3)
    with torch.no_grad():
        for step in range(LENGTH):
            h_clean, clean = wm.apply_decoder_step(sp, W, toks[step], clean,
                                                   cross)
            h_dirty, dirty = wm.apply_decoder_step(sp, W, toks[step], dirty,
                                                   cross)
            assert torch.equal(h_clean, h_dirty), step
    for key, t in _buffers(clean).items():
        assert torch.equal(_buffers(dirty)[key], t), key


def test_capture_is_allowed_on_the_card_without_a_model_group(enc):
    card = SimpleNamespace(is_cuda=True)
    assert dec._capture_allowed(card, None)
    assert not dec._capture_allowed(card, object())      # all-reduces
    assert not dec._capture_allowed(enc, None)           # the CPU


@pytest.mark.parametrize("route", ["fused", "xla", "sampled"])
def test_generate_on_the_cpu_captures_nothing(params, enc, route):
    dcfg = DecodeConfig(max_new_tokens=6, repetition_penalty=1.15,
                        no_repeat_ngram_size=3,
                        logits_impl="xla" if route == "xla" else "fused",
                        temperature=0.7 if route == "sampled" else 0.0)
    tracing.disable()
    tracing.drain()
    tracing.enable()
    try:
        out = dec.generate(params, W, dcfg, enc,
                           generator=torch.Generator().manual_seed(4))
    finally:
        tracing.disable()
    rec = tracing.drain()
    assert rec.counter("decode.steps") > 1
    assert rec.counter("decode.graph_captures") == 0
    assert rec.counter("decode.graph_replays") == 0
    assert not rec.of("decode.capture")
    assert out["tokens"].shape == (BATCH, len(dec.build_prompt(W, dcfg)) + 6)


def test_a_tally_counts_its_own_threads_launches():
    """What a capture records (`_build.tally`) is its thread's launches
    alone: another thread's launches meanwhile go to `STATS`."""
    import threading

    from audio_transformers_tpu_torch.ops import _build
    name = "decode_cross_attention"
    before = (_build.STATS[name].launches,
              _build.STATS[name].plain_cuda_calls)
    other = threading.Thread(target=lambda: [_build.count_launch(name)
                                             for _ in range(3)])
    with _build.tally() as counts:
        _build.count_launch(name)
        _build.count_launch(name)
        _build.count_plain(name, SimpleNamespace(is_cuda=True))
        _build.count_plain(name, SimpleNamespace(is_cuda=False))
        other.start()
        other.join()
    _build.count_launch(name)
    assert (counts[name].launches, counts[name].plain_cuda_calls) == (2, 1)
    assert set(counts) == {name}
    assert (_build.STATS[name].launches - before[0],
            _build.STATS[name].plain_cuda_calls - before[1]) == (4, 0)
