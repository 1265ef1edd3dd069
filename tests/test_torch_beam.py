"""The port's beam search against the JAX reference on the CPU, at
WhisperConfig.test() with JAX-initialised weights bridged into the port,
in float32; and straight against HF `generate(num_beams=N)`.

  top-k helpers                     equal to jax.lax.top_k, ties included
  int8 self-cache decode steps      hiddens <= 1e-4, int8 columns within 1
  apply_decoder_step(beams=3)       hiddens <= 1e-4 (cross none and int8)
  generate_beam                     tokens, lengths, beam_tokens and
                                    beam_lengths equal; beam_scores <= 1e-4;
                                    hiddens <= 1e-4; the port's "merged"
                                    top-k also against JAX "perbeam"
  K5 and its plain version          every generate_beam output equal
  EmotionWhisperPipeline(num_beams=2).analyze: texts equal, probs <= 1e-5

Random weights give near-uniform log-probs, so no hypothesis ends before
the budget. The "eos-prone" weights tilt the tied projection towards EOS
(the final layer norm gets a bias u and EOS's embedding row is 0.012 u),
so that hypotheses retire at different steps and rows finish early.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_transformers_tpu.core.config import (DecodeConfig,
                                                EmotionWhisperConfig,
                                                WhisperConfig)
from audio_transformers_tpu.data.tokenizer import ByteTokenizer
from audio_transformers_tpu.infer import pipeline as jpipe
from audio_transformers_tpu.models.whisper import beam as jbeam
from audio_transformers_tpu.models.whisper import emotion as jemo
from audio_transformers_tpu.models.whisper import model as jwm
from audio_transformers_tpu.utils.audio import synth_clip
from audio_transformers_tpu_torch.core import params as cp
from audio_transformers_tpu_torch.infer.pipeline import EmotionWhisperPipeline
from audio_transformers_tpu_torch.models.whisper import beam as tbeam
from audio_transformers_tpu_torch.models.whisper import model as wm
from audio_transformers_tpu_torch.ops.permute import permute_rows_reference

TINY = EmotionWhisperConfig(whisper=WhisperConfig.test(),
                            num_emotion_classes=4)
W = TINY.whisper
TOL = 1e-4
SCORE_TOL = 1e-4
PROB_TOL = 1e-5
EOS_BIAS = 0.012
# the pipeline's processors (infer/pipeline.analyze_windows)
CHAIN = dict(repetition_penalty=1.15, no_repeat_ngram_size=3)
SUPPRESS = (5, 17, 300, 1000)


def _np(x):
    return np.asarray(x.detach().cpu()) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _eos_prone(jp):
    jp = jax.tree.map(np.array, jp)
    u = np.random.default_rng(9).standard_normal(W.d_model).astype(
        np.float32)
    jp["whisper"]["decoder"]["ln"]["bias"] = u
    jp["whisper"]["decoder"]["embed"]["table"][W.eos_token_id] = EOS_BIAS * u
    return jp


@pytest.fixture(scope="module")
def models():
    """{"random" | "eos": (jax whisper params, port whisper params)} and the
    encoder states both decode from (the encoder is shared)."""
    jp = jax.tree.map(np.asarray, jemo.init(jax.random.PRNGKey(0), TINY))
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((3, 2 * W.max_source_positions,
                               W.n_mels)).astype(np.float32)
    enc = np.array(jwm.encode(jp["whisper"], W, jnp.asarray(mel)))
    trees = {"random": jp, "eos": _eos_prone(jp)}
    return ({k: (t["whisper"], cp.from_jax_params(t)["whisper"])
             for k, t in trees.items()}, enc)


@pytest.fixture(scope="module")
def jax_beam(models):
    """JAX generate_beam results, each computed once per module."""
    weights, enc = models

    @functools.lru_cache(maxsize=None)
    def run(model, dcfg, suppress):
        out = jbeam.generate_beam(weights[model][0], W, dcfg,
                                  jnp.asarray(enc), suppress_ids=suppress)
        return {k: np.asarray(v) for k, v in out.items()}
    return run


def _port_beam(models, model, dcfg, suppress=()):
    weights, enc = models
    return tbeam.generate_beam(weights[model][1], W, dcfg,
                               torch.from_numpy(enc), suppress_ids=suppress)


def _assert_beam_equal(got, want):
    for k in ("tokens", "lengths", "beam_tokens", "beam_lengths"):
        assert got[k].dtype == torch.int32, k
        np.testing.assert_array_equal(_np(got[k]), want[k], err_msg=k)
    np.testing.assert_allclose(_np(got["beam_scores"]), want["beam_scores"],
                               atol=SCORE_TOL, rtol=0)
    np.testing.assert_allclose(_np(got["hiddens"]), want["hiddens"],
                               atol=TOL, rtol=0)


# --------------------------------------------------------------------------
# top-k helpers against lax.top_k
# --------------------------------------------------------------------------


def _tie_rows():
    k = 4
    n = 20 * tbeam._BUCKET + 37
    x = np.full((5, n), -5.0, np.float32)
    for b in range(12):                       # k-th value tied in 12 buckets
        x[0, b * tbeam._BUCKET + 7] = 2.0
    x[0, 3] = 9.0
    x[1, tbeam._BUCKET - 1] = 4.0             # ties across a bucket edge
    x[1, tbeam._BUCKET] = 4.0
    x[1, 5 * tbeam._BUCKET + 2] = 4.0
    x[2, [200, 201, 205]] = 3.0               # several in one bucket
    x[2, 9 * tbeam._BUCKET] = 3.0
    x[3, n - 1] = 8.0                         # maxima in the padded bucket
    x[3, n - 2] = 8.0
    x[4, :] = 1.0                             # a fully tied row
    return x, k


@pytest.mark.parametrize("case", ["random0", "random1", "ties_short",
                                  "ties_bucketed", "integers_large"])
@pytest.mark.parametrize("fn", ["_stable_top_k", "_masked_argmax_top_k"])
def test_top_k_matches_lax(case, fn):
    rng = np.random.default_rng(len(case))
    if case.startswith("random"):
        x, k = rng.standard_normal((7, 4093)).astype(np.float32), 8
    elif case == "ties_short":
        x, k = np.zeros((2, 64), np.float32), 6
        x[0, [5, 20, 33]] = 7.0
        x[0, [6, 21]] = 3.0
        x[1, :] = 1.0
    elif case == "ties_bucketed":
        x, k = _tie_rows()
    else:
        x = rng.integers(-40, 40, size=(3, 6 * 51865 // 10)).astype(
            np.float32)
        k = 8
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    got_v, got_i = getattr(tbeam, fn)(torch.from_numpy(x), k)
    np.testing.assert_array_equal(_np(got_v), np.asarray(want_v))
    np.testing.assert_array_equal(_np(got_i), np.asarray(want_i))


# --------------------------------------------------------------------------
# the decoder step: int8 self cache, beams
# --------------------------------------------------------------------------


def test_int8_self_cache_steps_match_jax(models):
    weights, enc = models
    jpw, tpw = weights["random"]
    b, length = enc.shape[0], 8
    jcache = jwm.init_cache(W, b, max_len=length, quant="int8")
    jcross = jwm.precompute_cross_attention(jpw, W, jnp.asarray(enc))
    cache = wm.init_cache(W, b, max_len=length, quant="int8")
    cross = wm.precompute_cross_attention(tpw, W, torch.from_numpy(enc))
    sp = wm.prepare_decode_params(tpw, W)
    toks = np.random.default_rng(1).integers(0, W.vocab_size, (length, b))
    for step in range(length):
        hj, jcache = jwm.apply_decoder_step(
            jpw, W, jnp.asarray(toks[step], jnp.int32), jcache, jcross,
            attn_impl="xla")
        h, cache = wm.apply_decoder_step(sp, W, torch.from_numpy(toks[step]),
                                         cache, cross)
        np.testing.assert_allclose(_np(h), np.asarray(hj), atol=TOL, rtol=0)
    for li in range(W.decoder_layers):
        for name in ("k", "v"):
            assert cache[name][li].dtype == torch.int8
            diff = np.abs(_np(cache[name][li]).astype(int)
                          - np.asarray(jcache[name][li]).astype(int))
            assert diff.max() <= 1      # a rounding boundary may flip
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(_np(cache[name][li]),
                                       np.asarray(jcache[name][li]),
                                       atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("quant,self_quant", [("none", "none"),
                                              ("int8", "none"),
                                              ("int8", "int8")])
def test_beam_step_matches_jax(models, quant, self_quant):
    weights, enc = models
    jpw, tpw = weights["random"]
    n_beams, batch, length = 3, enc.shape[0], 6
    rows = n_beams * batch
    jcross = jwm.precompute_cross_attention(jpw, W, jnp.asarray(enc),
                                            quant=quant)
    cross = wm.beam_cross(wm.precompute_cross_attention(
        tpw, W, torch.from_numpy(enc), quant=quant))
    jsp = jwm.prepare_decode_params(jpw, W)
    sp = wm.prepare_decode_params(tpw, W)
    jcache = jwm.init_cache(W, rows, max_len=length, quant=self_quant)
    cache = wm.init_cache(W, rows, max_len=length, quant=self_quant)
    toks = np.random.default_rng(2).integers(0, W.vocab_size,
                                             (length, rows))
    for step in range(length):
        hj, jcache = jwm.apply_decoder_step(
            jpw, W, jnp.asarray(toks[step], jnp.int32), jcache, jcross,
            step_params=jsp, attn_impl="xla", beams=n_beams)
        h, cache = wm.apply_decoder_step(sp, W, torch.from_numpy(toks[step]),
                                         cache, cross, beams=n_beams)
        np.testing.assert_allclose(_np(h), np.asarray(hj), atol=TOL, rtol=0)


def test_beam_step_never_calls_k1(models, monkeypatch):
    weights, enc = models
    tpw = weights["random"][1]

    def refuse(*a, **k):
        raise AssertionError("K1 called on the beam path")
    monkeypatch.setattr(wm, "decode_cross_attention", refuse)
    cross = wm.precompute_cross_attention(tpw, W, torch.from_numpy(enc))
    cache = wm.init_cache(W, 6, max_len=4)
    sp = wm.prepare_decode_params(tpw, W)
    h, _ = wm.apply_decoder_step(sp, W, torch.arange(6), cache,
                                 wm.beam_cross(cross), beams=2)
    assert h.shape == (6, W.d_model)
    with pytest.raises(ValueError, match="beam_cross"):
        wm.apply_decoder_step(sp, W, torch.arange(6), cache, cross, beams=2)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_beam_cross_makes_float32_operands_once(models, quant):
    # bf16 cross K/V become float32 copies; p is rounded to bf16 as the
    # reference's cp.astype(vq.dtype), while int8 K/V meet float32 p
    tpw = models[0]["random"][1]
    enc = torch.from_numpy(models[1]).bfloat16()
    cross = wm.precompute_cross_attention(
        cp.map_tensors(tpw, lambda t: t.bfloat16()), W, enc, quant=quant)
    got = wm.beam_cross(cross)
    for name in ("k", "v"):
        for a, b in zip(got[name], cross[name]):
            assert a.dtype == torch.float32
            assert torch.equal(a, b.float())
    assert got["p_dtype"] == (torch.bfloat16 if quant == "none"
                              else torch.float32)
    if quant == "int8":
        assert got["k_scale"] is cross["k_scale"]


# --------------------------------------------------------------------------
# generate_beam against JAX generate_beam
# --------------------------------------------------------------------------

GRID = {
    "n2": DecodeConfig(max_new_tokens=20, num_beams=2),
    "n3_lp2": DecodeConfig(max_new_tokens=20, num_beams=3,
                           length_penalty=2.0),
    "n4_early": DecodeConfig(max_new_tokens=20, num_beams=4,
                             early_stopping=True),
}
CHAINED = {
    "pipeline_chain": DecodeConfig(max_new_tokens=20, num_beams=3, **CHAIN),
    "int8": DecodeConfig(max_new_tokens=20, num_beams=3, kv_quant="int8",
                         **CHAIN),
    "int8_cross_bf16_self": DecodeConfig(max_new_tokens=20, num_beams=2,
                                         kv_quant="int8",
                                         beam_self_kv_min=192, **CHAIN),
}


@pytest.mark.parametrize("model", ["random", "eos"])
@pytest.mark.parametrize("case", sorted(GRID))
def test_generate_beam_matches_jax(models, jax_beam, model, case):
    dcfg = GRID[case]
    got = _port_beam(models, model, dcfg)
    want = jax_beam(model, dcfg, ())
    _assert_beam_equal(got, want)
    if model == "eos" and dcfg.length_penalty == 1.0:
        # hypotheses retire at EOS before the budget (length_penalty 2
        # favours the full-length ones)
        assert (want["beam_lengths"] < want["beam_tokens"].shape[-1]).any()


@pytest.mark.parametrize("case", sorted(CHAINED))
def test_generate_beam_chain_matches_jax(models, jax_beam, case):
    # the pipeline's processors, a suppress list and begin-suppress
    dcfg = CHAINED[case]
    got = _port_beam(models, "eos", dcfg, SUPPRESS)
    want = jax_beam("eos", dcfg, SUPPRESS)
    _assert_beam_equal(got, want)
    assert not np.isin(want["tokens"], SUPPRESS).any()


@pytest.mark.parametrize("model", ["random", "eos"])
def test_merged_matches_jax_perbeam(models, jax_beam, model):
    # the port's one top-k ("merged") against the reference's TPU choice
    # ("perbeam"): the same search on these inputs
    dcfg = CHAINED["pipeline_chain"]
    got = _port_beam(models, model, dcfg, SUPPRESS)
    want = jax_beam(model, dcfg.replace(beam_topk="perbeam"), SUPPRESS)
    _assert_beam_equal(got, want)


@pytest.mark.parametrize("case", ["n3_lp2", "int8"])
def test_reorder_take_equals_k5(models, monkeypatch, case):
    # the K5 wrapper against its plain version (one index_select per
    # buffer, the reference's "take") patched in: the same search bit for
    # bit
    dcfg = {**GRID, **CHAINED}[case]
    a = _port_beam(models, "eos", dcfg)
    monkeypatch.setattr(tbeam, "permute_rows", permute_rows_reference)
    b = _port_beam(models, "eos", dcfg)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_rejected_modes(models):
    weights, enc = models
    tpw = weights["random"][1]
    e = torch.from_numpy(enc)
    with pytest.raises(ValueError, match="num_beams"):
        tbeam.generate_beam(tpw, W, DecodeConfig(num_beams=1), e)
    with pytest.raises(ValueError, match="temperature"):
        tbeam.generate_beam(tpw, W, DecodeConfig(num_beams=3,
                                                 temperature=0.7), e)
    for dcfg in (DecodeConfig(num_beams=2, kv_quant="int4"),
                 DecodeConfig(num_beams=2, return_timestamps=True)):
        with pytest.raises(NotImplementedError):
            tbeam.generate_beam(tpw, W, dcfg, e)
    # the reference's TPU alternatives are not options of the port
    for kw, what in ((dict(beam_reorder="mm"), "one-hot"),
                     (dict(beam_reorder="take"), "permute_rows_reference"),
                     (dict(beam_topk="perbeam"), "merged")):
        with pytest.raises(NotImplementedError, match=what):
            tbeam.generate_beam(tpw, W, DecodeConfig(num_beams=2, **kw), e)
    assert tbeam.resolve_beam_reorder("auto") == "pallas"
    assert tbeam.resolve_beam_reorder("pallas") == "pallas"
    assert tbeam.resolve_beam_topk("auto") == "merged"
    assert tbeam.resolve_beam_topk("merged") == "merged"
    with pytest.raises(ValueError):
        tbeam.resolve_beam_reorder("bogus")
    with pytest.raises(ValueError):
        tbeam.resolve_beam_topk("bogus")


# --------------------------------------------------------------------------
# straight against HF generate(num_beams=N)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hf_pair():
    from transformers import WhisperConfig as HFConfig
    from transformers import WhisperForConditionalGeneration

    from audio_transformers_tpu.models.whisper.load import (
        config_from_hf, from_torch_state_dict)

    hf_cfg = HFConfig(
        vocab_size=500, num_mel_bins=80, d_model=64,
        encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=2, decoder_attention_heads=2,
        encoder_ffn_dim=128, decoder_ffn_dim=128,
        max_source_positions=50, max_target_positions=64,
        pad_token_id=0, bos_token_id=0, eos_token_id=0,
        decoder_start_token_id=1,
    )
    torch.manual_seed(0)
    tm = WhisperForConditionalGeneration(hf_cfg).eval()
    cfg = config_from_hf(hf_cfg)
    params, _ = from_torch_state_dict(tm.state_dict(), cfg)
    return tm, cfg, cp.from_jax_params(params)


def _hf_beam(tm, mel_np, prompt, max_new, num_beams, *, length_penalty=1.0,
             early_stopping=False, processors=()):
    from transformers import GenerationConfig
    from transformers.generation.logits_process import LogitsProcessorList
    from transformers.generation.utils import GenerationMixin

    gc = GenerationConfig(
        max_new_tokens=max_new, do_sample=False, num_beams=num_beams,
        length_penalty=length_penalty, early_stopping=early_stopping,
        pad_token_id=0, eos_token_id=0, decoder_start_token_id=1)
    ids = torch.tensor([list(prompt)] * mel_np.shape[0], dtype=torch.long)
    with torch.no_grad():
        out = GenerationMixin.generate(
            tm, input_features=torch.from_numpy(mel_np.transpose(0, 2, 1)),
            decoder_input_ids=ids, generation_config=gc,
            logits_processor=LogitsProcessorList(list(processors)))
    return out.numpy()


@pytest.mark.parametrize("case", ["n3_lp2", "n3_chain"])
def test_matches_hf_beam_search(hf_pair, case):
    from transformers.generation.logits_process import (
        NoRepeatNGramLogitsProcessor, RepetitionPenaltyLogitsProcessor)

    tm, cfg, params = hf_pair
    mel = np.random.default_rng(11).standard_normal(
        (3, 2 * cfg.max_source_positions, cfg.n_mels)).astype(np.float32)
    prompt = (cfg.decoder_start_token_id,)
    if case == "n3_lp2":
        dcfg = DecodeConfig(max_new_tokens=16, num_beams=3,
                            length_penalty=2.0)
        want = _hf_beam(tm, mel, prompt, 16, 3, length_penalty=2.0)
    else:
        dcfg = DecodeConfig(max_new_tokens=14, num_beams=3, **CHAIN)
        want = _hf_beam(tm, mel, prompt, 14, 3, processors=[
            RepetitionPenaltyLogitsProcessor(1.15),
            NoRepeatNGramLogitsProcessor(3)])
    enc = wm.encode(params, cfg, torch.from_numpy(mel))
    out = tbeam.generate_beam(params, cfg, dcfg, enc, prompt=prompt,
                              begin_suppress_ids=())
    got, lengths = _np(out["tokens"]), _np(out["lengths"])
    for b in range(want.shape[0]):
        n = min(int(lengths[b]), want.shape[1])
        assert n > len(prompt)
        np.testing.assert_array_equal(got[b, :n], want[b, :n],
                                      err_msg=f"row {b}")


# --------------------------------------------------------------------------
# the pipeline
# --------------------------------------------------------------------------


def test_pipeline_num_beams_matches_jax():
    labels = {0: "happy", 1: "sad", 2: "calm", 3: "angry"}
    jp = jemo.init(jax.random.PRNGKey(0), TINY)
    tok = ByteTokenizer()
    jax_pipe = jpipe.EmotionWhisperPipeline(
        jp, TINY, idx_to_label=labels, tokenizer=tok,
        compute_dtype=jnp.float32, num_beams=2)
    port = EmotionWhisperPipeline(
        cp.from_jax_params(jax.tree.map(np.asarray, jp)), TINY,
        idx_to_label=labels, tokenizer=tok, device="cpu",
        compute_dtype=torch.float32, num_beams=2)
    wav = synth_clip(2.1, 16000, freq=330.0, seed=3)
    want = jax_pipe.analyze(wav, 16000, segment_duration=1.0,
                            max_new_tokens=10)
    got = port.analyze(wav, 16000, segment_duration=1.0, max_new_tokens=10)
    assert got["transcription"] == want["transcription"]
    assert len(got["segments"]) == len(want["segments"]) == 3
    for g, w in zip(got["segments"], want["segments"]):
        assert (g["text"], g["emotion"]) == (w["text"], w["emotion"])
        for k in w["emotion_probs"]:
            assert abs(g["emotion_probs"][k] - w["emotion_probs"][k]) \
                <= PROB_TOL
