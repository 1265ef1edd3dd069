"""Parity of the PyTorch port's ops with the JAX reference on the CPU:
nn primitives, log-mel (plain version), logit processors, pooling, the
weights bridge, and the port's freedom from JAX imports.

Inputs are made with numpy from a seed and handed to both packages;
float tolerances are stated per test."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_transformers_tpu.core.config import (EmotionWhisperConfig,
                                                MelConfig, WhisperConfig)
from audio_transformers_tpu.models.whisper import emotion as jemo
from audio_transformers_tpu.ops import logit_processors as jlp
from audio_transformers_tpu.ops import mel as jmel
from audio_transformers_tpu.ops import nn as jnn
from audio_transformers_tpu.ops import segment_pool as jsp
from audio_transformers_tpu.ops.mel_pallas import log_mel_pallas
from audio_transformers_tpu_torch.core import params as cp
from audio_transformers_tpu_torch.ops import logit_processors as lp
from audio_transformers_tpu_torch.ops import mel
from audio_transformers_tpu_torch.ops import nn
from audio_transformers_tpu_torch.ops.segment_pool import masked_sequence_mean

TINY = EmotionWhisperConfig(whisper=WhisperConfig.test(),
                            num_emotion_classes=4)
NN_TOL = 1e-4    # f32, sum-order differences only
MEL_TOL = 1e-4   # f32 rDFT/filterbank sums in another order, then log10


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, jemo.init(jax.random.PRNGKey(0), TINY))


# --------------------------------------------------------------------------
# nn primitives
# --------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["linear", "linear_nobias", "layer_norm",
                                "gelu", "conv1d", "conv1d_s2", "embedding",
                                "sinusoid", "mha", "mha_masked"])
def test_nn_matches_jax(op):
    rng = np.random.default_rng(0)
    b, t, d = 2, 9, 16
    x = _rand(rng, b, t, d)
    jlin = {"w": _rand(rng, d, 24), "b": _rand(rng, 24)}
    if op.startswith("linear"):
        if op == "linear_nobias":
            jlin.pop("b")
        want = jnn.linear(jlin, x)
        got = nn.linear(cp.from_jax_params(jlin), _t(x))
    elif op == "layer_norm":
        p = {"scale": _rand(rng, d), "bias": _rand(rng, d)}
        want = jnn.layer_norm(p, x)
        got = nn.layer_norm(cp.from_jax_params(p), _t(x))
    elif op == "gelu":
        want, got = jnn.gelu(x * 3), nn.gelu(_t(x * 3))
    elif op.startswith("conv1d"):
        stride = 2 if op == "conv1d_s2" else 1
        p = {"w": _rand(rng, 3, d, 12), "b": _rand(rng, 12)}
        want = jnn.conv1d(p, x, stride=stride, padding=1)
        got = nn.conv1d(cp.from_jax_params(p), _t(x), stride=stride,
                        padding=1)
    elif op == "embedding":
        p = {"table": _rand(rng, 50, d)}
        ids = rng.integers(0, 50, (b, t))
        want = jnn.embedding_lookup(p, ids)
        got = nn.embedding_lookup(cp.from_jax_params(p), _t(ids))
    elif op == "sinusoid":
        want = jnn.sinusoidal_embeddings(40, 18)
        got = nn.sinusoidal_embeddings(40, 18)
    else:
        p = jax.tree.map(np.asarray,
                         jnn.mha_init(jax.random.PRNGKey(1), d, 4,
                                      k_bias=False))
        kv = _rand(rng, b, 13, d)
        mask = None
        if op == "mha_masked":
            mask = rng.random((b, 1, t, 13)) > 0.3
            mask[..., 0] = True
        want = jnn.multihead_attention(p, x, kv, num_heads=4, mask=mask)
        got = nn.multihead_attention(
            cp.from_jax_params(p), _t(x), _t(kv), num_heads=4,
            mask=None if mask is None else _t(mask))
    want = np.asarray(want)
    assert _np(got).shape == want.shape
    np.testing.assert_allclose(_np(got), want, atol=NN_TOL, rtol=0)


# --------------------------------------------------------------------------
# log-mel (plain version; the kernel's tests are in test_torch_kernels.py)
# --------------------------------------------------------------------------


def test_mel_numpy_helpers_equal_reference():
    for cfg in (MelConfig.whisper(), MelConfig.urbansound()):
        np.testing.assert_array_equal(mel.mel_filter_bank(cfg),
                                      jmel.mel_filter_bank(cfg))
        for a, b in zip(mel._windowed_bases(cfg), jmel._windowed_bases(cfg)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mel.hann_window(400), jmel.hann_window(400))
    for a, b in zip(mel.dft_bases(64), jmel.dft_bases(64)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("oracle", ["xla", "pallas", "numpy"])
@pytest.mark.parametrize("cfg_name,n", [("whisper", 8000), ("whisper", 300),
                                        ("urbansound", 11025)])
def test_log_mel_matches_jax(oracle, cfg_name, n):
    cfg = getattr(MelConfig, cfg_name)()
    rng = np.random.default_rng(1)
    wav = (0.3 * rng.standard_normal((2, n))).astype(np.float32)
    got = _np(mel.log_mel(_t(wav), cfg))
    if oracle == "xla":
        want = np.asarray(jmel.log_mel_xla(jnp.asarray(wav), cfg, "highest"))
    elif oracle == "pallas":
        want = np.asarray(log_mel_pallas(jnp.asarray(wav), cfg,
                                         interpret=True))
    else:
        if n <= cfg.n_fft:   # the batched paths zero-pad short clips first
            wav = np.pad(wav, ((0, 0), (0, cfg.n_fft + 1 - n)))
        want = np.stack([mel.reference_log_mel(w, cfg) for w in wav])
        np.testing.assert_array_equal(
            want, np.stack([jmel.reference_log_mel(w, cfg) for w in wav]))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=MEL_TOL, rtol=0)


# --------------------------------------------------------------------------
# logit processors and pooling
# --------------------------------------------------------------------------


def test_neg_inf_is_float32_min():
    assert lp.NEG_INF == jlp.NEG_INF == float(np.finfo(np.float32).min)


@pytest.mark.parametrize("pos", [0, 2, 3, 7, 15, 24])
def test_ngram_masks_match_jax(pos):
    rng = np.random.default_rng(pos)
    toks = rng.integers(0, 6, (4, 24))   # small alphabet: many repeats
    vocab = 8
    for n in (2, 3):
        want = np.asarray(jlp.ngram_banned_mask(jnp.asarray(toks), pos, n,
                                                vocab))
        got = _np(lp.ngram_ban_mask(_t(toks), pos, n, vocab)) != 0
        np.testing.assert_array_equal(got, want)
        jf, jc, js = jlp.ngram_window_match(jnp.asarray(toks), pos, n)
        f, c, s = lp.ngram_window_match(_t(toks), pos, n)
        np.testing.assert_array_equal(_np(f), np.asarray(jf))
        np.testing.assert_array_equal(_np(c), np.asarray(jc))
        np.testing.assert_array_equal(_np(s), np.asarray(js))


def test_ngram_ban_skips_finished_rows():
    toks = torch.tensor([[1, 2, 1, 2, 1], [1, 2, 1, 2, 1]])
    finished = torch.tensor([False, True])
    ban = lp.ngram_ban_mask(toks, 5, 3, 4, finished)
    assert ban[0].tolist() == [0, 0, 1, 0] and ban[1].sum() == 0


def test_repetition_penalty_matches_jax():
    rng = np.random.default_rng(3)
    logits = (5 * rng.standard_normal((3, 20))).astype(np.float32)
    logits[0, :4] = jlp.NEG_INF          # suppressed and seen: -> -inf
    toks = rng.integers(0, 20, (3, 10))
    want = np.asarray(jlp.repetition_penalty(jnp.asarray(logits),
                                             jnp.asarray(toks), 10, 1.15))
    seen = np.zeros((3, 20), np.int8)
    np.put_along_axis(seen, toks, 1, axis=1)
    got = _np(lp.repetition_penalty(_t(logits), _t(seen), 1.15))
    np.testing.assert_array_equal(got, want)


def test_suppress_vector():
    add = lp.suppress_vector(16, (1, 5), vocab=12)
    want = np.zeros(16, np.float32)
    want[[1, 5, 12, 13, 14, 15]] = lp.NEG_INF
    np.testing.assert_array_equal(_np(add), want)


@pytest.mark.parametrize("seed", range(4))
def test_timestamp_row_bounds_match_jax(seed):
    rng = np.random.default_rng(seed)
    tb, begin, eos = 10, 2, 0
    toks = rng.integers(0, 16, (5, 12))
    toks[:, 0], toks[:, 1] = 1, 3
    for pos in range(begin, 12):
        want = jlp.timestamp_row_bounds(jnp.asarray(toks), pos,
                                        begin_index=begin, timestamp_begin=tb,
                                        eos_token_id=eos)
        got = lp.timestamp_row_bounds(_t(toks), pos, begin_index=begin,
                                      timestamp_begin=tb, eos_token_id=eos)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), np.asarray(w))


def test_masked_sequence_mean_matches_jax():
    rng = np.random.default_rng(4)
    h = _rand(rng, 3, 7, 5)
    mask = rng.random((3, 7)) > 0.5
    mask[2] = False                       # falls back to the full mean
    want = np.asarray(jsp.masked_sequence_mean(jnp.asarray(h),
                                               jnp.asarray(mask)))
    got = _np(masked_sequence_mean(_t(h), _t(mask)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# --------------------------------------------------------------------------
# weights bridge, seeded init, no JAX in the port
# --------------------------------------------------------------------------


def test_bridge_roundtrip_is_bit_exact(jparams):
    back = cp.to_jax_params(cp.from_jax_params(jparams))
    flat_a, tree_a = jax.tree.flatten(jparams)
    flat_b, tree_b = jax.tree.flatten(back)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_bridge_roundtrip_bf16(jparams):
    bf = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)),
                      jparams)
    port = cp.from_jax_params(bf)
    assert port["emotion_head"]["w"].dtype == torch.bfloat16
    back = cp.to_jax_params(port)
    for a, b in zip(jax.tree.leaves(bf), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_bridge_layouts(jparams):
    port = cp.from_jax_params(jparams)
    jw = jparams["whisper"]
    np.testing.assert_array_equal(
        _np(port["whisper"]["encoder"]["conv1"]["w"]),
        jw["encoder"]["conv1"]["w"].transpose(2, 1, 0))
    np.testing.assert_array_equal(
        _np(port["whisper"]["decoder"]["blocks"][0]["fc1"]["w"]),
        jw["decoder"]["blocks"][0]["fc1"]["w"].T)
    np.testing.assert_array_equal(_np(port["whisper"]["encoder"]["pos"]),
                                  jw["encoder"]["pos"])


def test_seeded_init_matches_jax_tree(jparams):
    port = cp.init(TINY, torch.Generator().manual_seed(0))
    back = cp.to_jax_params(port)
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        assert a.shape == b.shape and a.dtype == b.dtype
    again = cp.init(TINY, torch.Generator().manual_seed(0))
    assert torch.equal(port["whisper"]["decoder"]["embed"]["table"],
                       again["whisper"]["decoder"]["embed"]["table"])
    # f32 sin/cos of arguments up to ~64 rad differ by a few ulp of the
    # argument between the two libraries' implementations
    np.testing.assert_allclose(back["whisper"]["encoder"]["pos"],
                               jparams["whisper"]["encoder"]["pos"],
                               atol=1e-5)


def test_port_imports_no_jax():
    mods = ["core.params", "ops.nn", "ops.mel", "ops.mel_cuda",
            "ops.decode_attention", "ops.decode_logits",
            "ops.logit_processors", "ops.segment_pool", "ops._build",
            "models.whisper.model", "models.whisper.decode",
            "models.whisper.emotion", "infer.pipeline", "serve.http_server"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module('audio_transformers_tpu_torch.' + m)\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k == 'jax' or k.startswith(('jax.', 'jaxlib')))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
