"""The port's whisper model and decode against the JAX reference on the
CPU, at WhisperConfig.test() with JAX-initialised weights bridged into the
port. Everything runs in float32.

  encode, precompute_cross_attention, decoder step hiddens  <= 1e-4
  int4 precompute_cross_attention on exact projections       bit-equal
  generate: tokens and lengths equal, hiddens <= 1e-4
  timestamped generate (kv_quant none, int8, int4): tokens and lengths
    equal, hiddens <= 1e-5
  sampled generate and the fallback re-decode, the reference's Gumbel
    noise replayed: tokens and lengths equal, hiddens <= 1e-5
  whisper_timestamp_rules and _process_logits                 <= 1e-6

The timestamp tests move the test config's timestamps to ids >= 600
(TS), so that rows mix text and timestamps.
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
from audio_transformers_tpu.ops import logit_processors as jlp
from audio_transformers_tpu_torch.core import params as cp
from audio_transformers_tpu_torch.models.whisper import decode as dec
from audio_transformers_tpu_torch.models.whisper import emotion as emo
from audio_transformers_tpu_torch.models.whisper import model as wm
from audio_transformers_tpu_torch.ops import logit_processors as lp

TINY = EmotionWhisperConfig(whisper=WhisperConfig.test(),
                            num_emotion_classes=4)
W = TINY.whisper
TOL = 1e-4
TS_TOL = 1e-5
# the test config with its timestamps at ids >= 600
TS = W.replace(timestamp_begin_id=600)
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


def test_int4_cross_and_int8_self_cache_match_jax(pair):
    # int4: the projections are made exact (weights in 1/16, encoder
    # states in 1/8, sums far inside float32's 24 bits), so that both
    # sides quantize the same K/V and the packed bytes and scales must
    # be the same bits
    jp, _, _, enc_j = pair
    rng = np.random.default_rng(3)
    blocks = jp["whisper"]["decoder"]["blocks"]
    exact = jax.tree.map(np.array, jp["whisper"])
    for bp in exact["decoder"]["blocks"]:
        for name in ("k", "v"):
            lin = bp["cross_attn"][name]
            lin["w"] = (rng.integers(-16, 17, lin["w"].shape) / 16.0
                        ).astype(np.float32)
            if "b" in lin:
                lin["b"] = (rng.integers(-8, 9, lin["b"].shape) / 8.0
                            ).astype(np.float32)
    assert len(blocks) == len(exact["decoder"]["blocks"])
    enc = (rng.integers(-16, 17, enc_j.shape) / 8.0).astype(np.float32)
    want = jwm.precompute_cross_attention(exact, W, jnp.asarray(enc),
                                          quant="int4")
    got = wm.precompute_cross_attention(
        cp.from_jax_params({"whisper": exact})["whisper"], W,
        torch.from_numpy(enc), quant="int4")
    assert sorted(got) == sorted(want)
    for name in want:
        for g, w in zip(got[name], want[name]):
            assert tuple(g.shape) == w.shape and g.is_contiguous(), name
            assert str(g.dtype).split(".")[-1] == str(w.dtype), name
            np.testing.assert_array_equal(_np(g), np.asarray(w),
                                          err_msg=name)
    with pytest.raises(ValueError, match="even"):
        wm.precompute_cross_attention(
            cp.from_jax_params({"whisper": exact})["whisper"], W,
            torch.from_numpy(enc[:, :-1]), quant="int4")
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


def _assert_decode_equal(got, want, tol=TOL):
    assert got["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(_np(got["tokens"]),
                                  np.asarray(want["tokens"]))
    np.testing.assert_array_equal(_np(got["lengths"]),
                                  np.asarray(want["lengths"]))
    np.testing.assert_allclose(_np(got["hiddens"]),
                               np.asarray(want["hiddens"]), atol=tol, rtol=0)


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


class JaxGumbel:
    """Stands in for `decode.gumbel_noise`: the Gumbel noise the reference's
    sampling loop draws, jax.random.categorical's over (rows, V) from one
    key split per loop step of PRNGKey(0). A new generator (each generate
    call) starts the sequence again. `rows(n)` gives the reference's batch
    for n decoded rows (the fallback's power-of-two bucket); the first n
    rows of its noise are the port's."""

    def __init__(self, rows=None):
        self.rows, self.gen, self.key = rows, None, None
        self.calls = 0

    def __call__(self, shape, generator):
        if generator is not self.gen:
            self.gen, self.key = generator, jax.random.PRNGKey(0)
        self.key, sub = jax.random.split(self.key)
        self.calls += 1
        n = shape[0] if self.rows is None else self.rows(shape[0])
        g = np.asarray(jax.random.gumbel(sub, (n, shape[1]), jnp.float32))
        return torch.from_numpy(g[:shape[0]].copy())


def test_generate_modes_match_jax_and_beams_raise(pair, monkeypatch):
    # temperature and timestamps, held to JAX generate; num_beams > 1 is
    # generate_beam's
    jp, tp, _, enc_j = pair
    enc = torch.from_numpy(enc_j)
    with pytest.raises(ValueError, match="generate_beam"):
        dec.generate(tp["whisper"], W, DecodeConfig(num_beams=2), enc)
    noise = JaxGumbel()
    monkeypatch.setattr(dec, "gumbel_noise", noise)
    for dcfg in (DecodeConfig(max_new_tokens=16, temperature=0.7),
                 DecodeConfig(max_new_tokens=16, return_timestamps=True),
                 DecodeConfig(max_new_tokens=16, temperature=1.3,
                              return_timestamps=True, **_CHAIN)):
        want = jdec.generate(jp["whisper"], TS, dcfg, jnp.asarray(enc_j),
                             rng=jax.random.PRNGKey(0))
        got = dec.generate(tp["whisper"], TS, dcfg, enc)
        _assert_decode_equal(got, want, TS_TOL)
    # one draw per loop step, forced prompt steps included: 17 steps
    # after the two-id prompt of the first decode, 16 after the timestamp
    # prompt (one id) of the third; none of their rows ends early
    assert noise.calls == 17 + 16


_CHAIN = dict(repetition_penalty=1.1, no_repeat_ngram_size=3)


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
def test_timestamped_generate_matches_jax(pair, quant):
    # segment evaluation's decode: timestamps, repetition penalty 1.1,
    # no-repeat 3-gram; greedy rows through K2's timestamp mode. int8
    # cross K/V hold the JAX kernels' arithmetic (q and p never
    # quantized), so JAX runs its interpreted kernels there; int4 takes
    # its XLA oracle, which is K1's arithmetic
    jp, tp, _, enc_j = pair
    dcfg = DecodeConfig(max_new_tokens=24, return_timestamps=True,
                        kv_quant=quant, self_kv_min=0, **_CHAIN)
    jdcfg = (dcfg.replace(step_attn="fused", logits_impl="fused")
             if quant == "int8" else dcfg)
    want = jdec.generate(jp["whisper"], TS, jdcfg, jnp.asarray(enc_j))
    got = dec.generate(tp["whisper"], TS, dcfg, torch.from_numpy(enc_j))
    _assert_decode_equal(got, want, TS_TOL)
    toks = _np(got["tokens"])[:, 1:]
    # rows mix timestamps and text
    assert (toks >= TS.timestamp_begin_id).any()
    assert ((toks < TS.timestamp_begin_id) & (toks > 0)).any()


def test_sampling_with_replayed_noise_matches_jax(pair, monkeypatch):
    jp, tp, _, enc_j = pair
    monkeypatch.setattr(dec, "gumbel_noise", JaxGumbel())
    dcfg = DecodeConfig(max_new_tokens=20, temperature=0.7, kv_quant="int4",
                        **_CHAIN)
    want = jdec.generate(jp["whisper"], W, dcfg, jnp.asarray(enc_j),
                         rng=jax.random.PRNGKey(0))
    got = dec.generate(tp["whisper"], W, dcfg, torch.from_numpy(enc_j))
    _assert_decode_equal(got, want, TS_TOL)
    greedy = dec.generate(tp["whisper"], W, dcfg.replace(temperature=0.0),
                          torch.from_numpy(enc_j))
    assert not torch.equal(got["tokens"], greedy["tokens"])


def test_gumbel_noise_is_seeded_and_in_range():
    a = dec.gumbel_noise((4, 1000), torch.Generator().manual_seed(0))
    b = dec.gumbel_noise((4, 1000), torch.Generator().manual_seed(0))
    assert a.dtype == torch.float32 and torch.equal(a, b)
    assert torch.isfinite(a).all()
    # Gumbel(0, 1): mean 0.5772, variance pi^2 / 6
    assert abs(a.mean().item() - 0.5772) < 0.05
    assert abs(a.var().item() - np.pi ** 2 / 6) < 0.15


@pytest.mark.parametrize("threshold", [1.0, 1.7])
def test_fallback_matches_jax(pair, monkeypatch, threshold):
    # thresholds that flag one row (1.7) or all (1.0) of the timestamped
    # decode: the flagged rows are decoded again at temperature 0.7 and
    # merged back; the reference decodes them in a power-of-two bucket
    jp, tp, _, enc_j = pair
    batch = enc_j.shape[0]
    dcfg = DecodeConfig(max_new_tokens=24, return_timestamps=True,
                        compression_ratio_threshold=threshold, **_CHAIN)
    greedy = dec.generate(tp["whisper"], TS, dcfg, torch.from_numpy(enc_j))

    def bucket(n):
        b = 1
        while b < n:
            b *= 2
        return min(b, batch)
    noise = JaxGumbel(rows=bucket)
    monkeypatch.setattr(dec, "gumbel_noise", noise)
    want = jdec.generate_with_fallback(jp["whisper"], TS, dcfg,
                                       jnp.asarray(enc_j))
    got = dec.generate_with_fallback(tp["whisper"], TS, dcfg,
                                     torch.from_numpy(enc_j))
    _assert_decode_equal(got, want, TS_TOL)
    changed = (_np(got["tokens"]) != _np(greedy["tokens"])).any(axis=1)
    assert noise.calls > 0 and changed.any()
    if threshold == 1.2:
        assert changed.tolist() == [True, False, False]


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


def _history(rng, b, length, pos, tb, vocab):
    """Token rows with a prompt of one id, then a mix of text ids and
    timestamps up to pos."""
    toks = np.zeros((b, length), np.int32)
    toks[:, 0] = 1
    for i in range(b):
        for p in range(1, pos):
            toks[i, p] = (rng.integers(tb, vocab) if rng.random() < 0.4
                          else rng.integers(5, tb))
    return toks


@pytest.mark.parametrize("pos", [1, 2, 3, 9])
def test_timestamp_rules_match_jax(pos):
    rng = np.random.default_rng(pos)
    b, length, vocab, tb = 6, 12, TS.vocab_size, TS.timestamp_begin_id
    toks = _history(rng, b, length, pos, tb, vocab)
    # rows ending in a timestamp pair, a lone timestamp, and text
    toks[0, pos - 1] = tb + 5
    if pos > 2:
        toks[1, pos - 2:pos] = [tb + 3, tb + 7]
    logits = rng.standard_normal((b, vocab)).astype(np.float32) * 3.0
    logits[2, tb:] += 4.0       # timestamps outweigh text: text banned
    kw = dict(begin_index=1, timestamp_begin=tb, eos_token_id=TS.eos_token_id,
              no_timestamps_token_id=TS.no_timestamps_token_id)
    want = np.asarray(jlp.whisper_timestamp_rules(
        jnp.asarray(logits), jnp.asarray(toks), pos, **kw))
    got = _np(lp.whisper_timestamp_rules(torch.from_numpy(logits),
                                         torch.from_numpy(toks).long(), pos,
                                         **kw))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    for j, t in zip(jlp.timestamp_row_bounds(
            jnp.asarray(toks), pos, begin_index=1, timestamp_begin=tb,
            eos_token_id=TS.eos_token_id),
            lp.timestamp_row_bounds(torch.from_numpy(toks).long(), pos,
                                    begin_index=1, timestamp_begin=tb,
                                    eos_token_id=TS.eos_token_id)):
        np.testing.assert_array_equal(_np(t), np.asarray(j))


@pytest.mark.parametrize("case", ["timestamps", "chain", "beam_logp"])
def test_process_logits_matches_jax(case):
    rng = np.random.default_rng(len(case))
    b, length, pos, vocab = 5, 14, 8, TS.vocab_size
    toks = _history(rng, b, length, pos, TS.timestamp_begin_id, vocab)
    toks[:, 4:7] = toks[:, 1:4]        # an n-gram to ban
    logits = rng.standard_normal((b, vocab)).astype(np.float32) * 2.0
    if case == "beam_logp":
        logits = np.array(jax.nn.log_softmax(jnp.asarray(logits)))
    finished = np.array([False, True, False, False, True])
    dcfg = DecodeConfig(return_timestamps=case != "chain",
                        repetition_penalty=1.3, no_repeat_ngram_size=3)
    suppress, begin = (17, 300), (220 % vocab, 0)
    masks = dec.suppress_masks(vocab, suppress, begin)
    # the first generated position (the begin-suppress ids join in) and a
    # later one; the seen mask of tokens[:, :p], as the decode loops carry
    for p, fin in ((1, None), (pos, finished)):
        seen = np.array(jlp.seen_mask(jnp.asarray(toks), p, vocab))
        want = np.asarray(jdec._process_logits(
            jnp.asarray(logits), jnp.asarray(toks), p, TS, dcfg, 1, suppress,
            begin, seen=jnp.asarray(seen),
            finished=None if fin is None else jnp.asarray(fin),
            ngram_impl="mask" if case == "beam_logp" else "auto"))
        got = _np(dec._process_logits(
            torch.from_numpy(logits), torch.from_numpy(toks).long(), p, TS,
            dcfg, 1, masks, seen=torch.from_numpy(seen),
            finished=None if fin is None else torch.from_numpy(fin)))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
