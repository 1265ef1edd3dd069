"""The port's whisper model and greedy decode against the JAX reference on
the CPU, at WhisperConfig.test() with JAX-initialised weights bridged into
the port. Everything runs in float32.

  encode, precompute_cross_attention, decoder step hiddens  <= 1e-4
  generate: tokens and lengths equal, hiddens <= 1e-4
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_transformers_tpu.core.config import (DecodeConfig,
                                                EmotionWhisperConfig,
                                                WhisperConfig)
from audio_transformers_tpu.models.whisper import decode as jdec
from audio_transformers_tpu.models.whisper import emotion as jemo
from audio_transformers_tpu.models.whisper import model as jwm
from audio_transformers_tpu_torch.core import params as cp
from audio_transformers_tpu_torch.models.whisper import decode as dec
from audio_transformers_tpu_torch.models.whisper import emotion as emo
from audio_transformers_tpu_torch.models.whisper import model as wm

TINY = EmotionWhisperConfig(whisper=WhisperConfig.test(),
                            num_emotion_classes=4)
W = TINY.whisper
TOL = 1e-4
# the pipeline's decode configuration (infer/pipeline.analyze_windows)
PIPE_DCFG = DecodeConfig(max_new_tokens=24, repetition_penalty=1.15,
                         no_repeat_ngram_size=3)


def _np(x):
    return np.asarray(x.detach().cpu()) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.fixture(scope="module")
def pair():
    jp = jax.tree.map(np.asarray, jemo.init(jax.random.PRNGKey(0), TINY))
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((3, 2 * W.max_source_positions,
                               W.n_mels)).astype(np.float32)
    enc_j = np.array(jwm.encode(jp["whisper"], W, jnp.asarray(mel)))
    return jp, cp.from_jax_params(jp), mel, enc_j


def test_encode_matches_jax(pair):
    _, tp, mel, enc_j = pair
    enc = wm.encode(tp["whisper"], W, torch.from_numpy(mel))
    assert enc.shape == (3, W.max_source_positions, W.d_model)
    np.testing.assert_allclose(_np(enc), enc_j, atol=TOL, rtol=0)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_precompute_cross_matches_jax(pair, quant):
    jp, tp, _, enc_j = pair
    want = jwm.precompute_cross_attention(jp["whisper"], W,
                                          jnp.asarray(enc_j), quant=quant)
    got = wm.precompute_cross_attention(tp["whisper"], W,
                                        torch.from_numpy(enc_j), quant=quant)
    assert sorted(got) == sorted(want)
    for name in want:
        for g, w in zip(got[name], want[name]):
            assert tuple(g.shape) == w.shape and g.is_contiguous()
            if name in ("k", "v") and quant == "int8":
                # a value on a rounding boundary may flip by one step
                assert g.dtype == torch.int8
                assert np.abs(_np(g).astype(int)
                              - np.asarray(w).astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(_np(g), np.asarray(w),
                                           atol=1e-5, rtol=0)


def test_int4_waits_and_int8_self_cache_matches_jax(pair):
    _, tp, _, enc_j = pair
    with pytest.raises(NotImplementedError):
        wm.precompute_cross_attention(tp["whisper"], W,
                                      torch.from_numpy(enc_j), quant="int4")
    want = jwm.init_cache(W, 2, max_len=9, quant="int8")
    got = wm.init_cache(W, 2, max_len=9, quant="int8")
    assert sorted(got) == sorted(want) and got["index"] == 0
    for name in ("k", "v", "k_scale", "v_scale"):
        assert len(got[name]) == len(want[name]) == W.decoder_layers
        for g, w in zip(got[name], want[name]):
            assert tuple(g.shape) == w.shape
            assert str(g.dtype).split(".")[-1] == str(w.dtype)
            np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_decoder_steps_match_jax(pair):
    jp, tp, _, enc_j = pair
    b, length = enc_j.shape[0], 8
    jcache = jwm.init_cache(W, b, max_len=length)
    jcross = jwm.precompute_cross_attention(jp["whisper"], W,
                                            jnp.asarray(enc_j))
    cache = wm.init_cache(W, b, max_len=length)
    cross = wm.precompute_cross_attention(tp["whisper"], W,
                                          torch.from_numpy(enc_j))
    sp = wm.prepare_decode_params(tp["whisper"], W)
    toks = np.random.default_rng(1).integers(0, W.vocab_size, (length, b))
    for step in range(length):
        hj, jcache = jwm.apply_decoder_step(
            jp["whisper"], W, jnp.asarray(toks[step], jnp.int32), jcache,
            jcross, attn_impl="xla")
        h, cache = wm.apply_decoder_step(sp, W, torch.from_numpy(toks[step]),
                                         cache, cross)
        np.testing.assert_allclose(_np(h), np.asarray(hj), atol=TOL, rtol=0)
    assert cache["index"] == length
    np.testing.assert_allclose(_np(cache["k"][1]), np.asarray(jcache["k"][1]),
                               atol=TOL, rtol=0)


def _generate_both(pair, dcfg, *, jax_dcfg=None, suppress_ids=()):
    jp, tp, _, enc_j = pair
    want = jdec.generate(jp["whisper"], W, jax_dcfg or dcfg,
                         jnp.asarray(enc_j), suppress_ids=suppress_ids)
    got = dec.generate(tp["whisper"], W, dcfg, torch.from_numpy(enc_j),
                       suppress_ids=suppress_ids)
    return got, want


def _assert_decode_equal(got, want):
    assert got["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(_np(got["tokens"]),
                                  np.asarray(want["tokens"]))
    np.testing.assert_array_equal(_np(got["lengths"]),
                                  np.asarray(want["lengths"]))
    np.testing.assert_allclose(_np(got["hiddens"]),
                               np.asarray(want["hiddens"]), atol=TOL, rtol=0)


# Restricting the vocabulary to EOS and a few ids makes rows finish at
# different steps, which exercises the early exit and the extra final
# step whose zero hiddens the emotion head pools over.
_FEW = tuple(i for i in range(W.vocab_size) if i not in (0, 5, 6, 7))


@pytest.mark.parametrize("case", ["pipeline", "greedy", "early_exit",
                                  "ngram_only", "penalty_only"])
def test_generate_matches_jax(pair, case):
    dcfg = {"pipeline": PIPE_DCFG,
            "greedy": DecodeConfig(max_new_tokens=24),
            "early_exit": PIPE_DCFG,
            "ngram_only": DecodeConfig(max_new_tokens=24,
                                       no_repeat_ngram_size=2),
            "penalty_only": DecodeConfig(max_new_tokens=24,
                                         repetition_penalty=1.3)}[case]
    suppress = _FEW if case == "early_exit" else ()
    got, want = _generate_both(pair, dcfg, suppress_ids=suppress)
    _assert_decode_equal(got, want)
    if case == "early_exit":
        lengths = _np(got["lengths"])
        assert lengths.max() < got["tokens"].shape[1]
        assert len(set(lengths.tolist())) > 1
        # the extra final step fed the last EOS; later positions stay zero
        fed = int(lengths.max())
        assert float(got["hiddens"][:, fed - 1].abs().min()) > 0.0
        assert float(got["hiddens"][:, fed:].abs().sum()) == 0.0


def test_generate_matches_jax_fused_kernels(pair):
    # int8 cross K/V: the JAX side runs its Pallas cross-attention and
    # greedy-step kernels (interpreted), whose arithmetic the port's
    # kernels share (q and p never quantized)
    dcfg = PIPE_DCFG.replace(max_new_tokens=10, kv_quant="int8")
    got, want = _generate_both(
        pair, dcfg, jax_dcfg=dcfg.replace(step_attn="fused",
                                          logits_impl="fused"))
    _assert_decode_equal(got, want)


def test_generate_int8_self_cache_matches_jax(pair):
    # self_kv_min=0 quantizes the self cache at this short budget too (the
    # default 192 gates it to long decodes); JAX runs its interpreted
    # kernels for the int8 cross K/V, as above
    dcfg = PIPE_DCFG.replace(max_new_tokens=10, kv_quant="int8",
                             self_kv_min=0)
    got, want = _generate_both(
        pair, dcfg, jax_dcfg=dcfg.replace(step_attn="fused",
                                          logits_impl="fused"))
    _assert_decode_equal(got, want)


def test_generate_unported_modes_raise(pair):
    _, tp, _, enc_j = pair
    enc = torch.from_numpy(enc_j)
    for dcfg in (DecodeConfig(temperature=0.7),
                 DecodeConfig(return_timestamps=True),
                 DecodeConfig(num_beams=2)):
        with pytest.raises(NotImplementedError):
            dec.generate(tp["whisper"], W, dcfg, enc)


def test_fallback_without_threshold_is_greedy(pair):
    _, tp, _, enc_j = pair
    enc = torch.from_numpy(enc_j)
    a = dec.generate(tp["whisper"], W, PIPE_DCFG, enc)
    b = dec.generate_with_fallback(tp["whisper"], W, PIPE_DCFG, enc)
    for k in a:
        assert torch.equal(a[k], b[k])


def test_prompt_and_suppress_ids_match_jax():
    for cfg in (W, WhisperConfig(), WhisperConfig.large_v3()):
        assert dec.default_suppress_ids(cfg) == jdec.default_suppress_ids(cfg)
        for dcfg in (DecodeConfig(), DecodeConfig(
                forced_language_token=cfg.lang_en_token_id,
                forced_task_token=cfg.transcribe_token_id,
                return_timestamps=True)):
            assert dec.build_prompt(cfg, dcfg) == jdec.build_prompt(cfg, dcfg)


@pytest.mark.parametrize("masked", [False, True])
def test_sequence_emotion_matches_jax(pair, masked):
    jp, tp, _, _ = pair
    rng = np.random.default_rng(5)
    h = rng.standard_normal((3, 11, W.d_model)).astype(np.float32)
    lengths = np.array([4, 11, 7], np.int32) if masked else None
    want = jemo.sequence_emotion_from_hiddens(
        jp, jnp.asarray(h), None if lengths is None else jnp.asarray(lengths))
    got = emo.sequence_emotion_from_hiddens(
        tp, torch.from_numpy(h),
        None if lengths is None else torch.from_numpy(lengths))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=0)
