"""`DecodeConfig.step_attn` and `logits_impl` in the port's greedy decode,
held to the JAX package's `generate` under the same DecodeConfig on the
CPU, at WhisperConfig.test()'s widths with one encoder and one decoder
layer (each case compiles a JAX decode), the port's seeded weights
bridged into JAX (`core.params.to_jax_params`), in float32.

  step_attn x logits_impl x kv_quant     tokens and lengths equal, hiddens
  ("fused"/"xla" each; none, int8,       within TOL (1e-5), int8 "xla"
  int4), the pipeline's processors       within TOL_P_STEP (5e-4: one
  (penalty 1.15, 3-gram ban)             quantization step of p)

"fused" is K1 and K2 (their plain versions here; JAX runs its Pallas
kernels interpreted), "xla" the reference's XLA arithmetic: with int8
cross K/V it quantizes q and p, which K1 never does, so the int8 "xla"
hiddens lie further than TOL from the "fused" ones (checked below).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_transformers_tpu.core.config import (DecodeConfig,
                                                EmotionWhisperConfig,
                                                WhisperConfig)
from audio_transformers_tpu.models.whisper import decode as jdec
from audio_transformers_tpu_torch.core import config as pcfg
from audio_transformers_tpu_torch.core import params as cp
from audio_transformers_tpu_torch.core.params import init as pinit
from audio_transformers_tpu_torch.models.whisper import decode as dec
from audio_transformers_tpu_torch.models.whisper import model as wm
from audio_transformers_tpu_torch.ops import decode_logits as dl

TINY = EmotionWhisperConfig(
    whisper=WhisperConfig.test().replace(encoder_layers=1, decoder_layers=1),
    num_emotion_classes=4)
W = TINY.whisper
# float32 sums in another order (the cases lie within 1.5e-6)
TOL = 1e-5
# int8 "xla" rounds p to int8 steps of max(p) / 127: a p on a step's edge
# can round the other way in the other package, whose softmax differs in
# the last ulp. One such step moved these hiddens by 2.6e-4; K1's
# arithmetic, which a port that ignored step_attn would run, lies 1.5e-3
# to 2.6e-3 from JAX's "xla" (five seeded draws of weights and features)
TOL_P_STEP = 5e-4
CHAIN = dict(max_new_tokens=8, repetition_penalty=1.15,
             no_repeat_ngram_size=3)
ROUTES = ("fused", "xla")
QUANTS = ("none", "int8", "int4")


def _np(x):
    return np.asarray(x.detach().cpu()) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.fixture(scope="module")
def pair():
    """(the whisper tree for JAX, the same for the port, encoder states
    (3, 64, 64) float32): the port's seeded init (JAX's eager init takes
    seconds) and encode of seeded mel features."""
    params = pinit(pcfg.EmotionWhisperConfig(
        whisper=pcfg.WhisperConfig(**W.__dict__), num_emotion_classes=4),
        torch.Generator().manual_seed(0))["whisper"]
    mel = np.random.default_rng(0).standard_normal(
        (3, 2 * W.max_source_positions, W.n_mels)).astype(np.float32)
    with torch.no_grad():
        enc = wm.encode(params, W, torch.from_numpy(mel)).numpy()
    return cp.to_jax_params(params), params, enc


class Routes:
    """Counts the calls of K1 (`model.decode_cross_attention`) and K2
    (`decode_logits.fused_greedy_step`) while patched in."""

    def __init__(self, monkeypatch):
        self.k1 = self.k2 = 0
        k1, k2 = wm.decode_cross_attention, dl.fused_greedy_step

        def count_k1(*a, **kw):
            self.k1 += 1
            return k1(*a, **kw)

        def count_k2(*a, **kw):
            self.k2 += 1
            return k2(*a, **kw)
        monkeypatch.setattr(wm, "decode_cross_attention", count_k1)
        monkeypatch.setattr(dl, "fused_greedy_step", count_k2)


@pytest.fixture(scope="module")
def port_runs(pair):
    """The port's decode of every case, {(step_attn, logits_impl, quant):
    (out, K1 calls, K2 calls)}."""
    _, tp, enc = pair
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for case in itertools.product(ROUTES, ROUTES, QUANTS):
            routes = Routes(mp)
            dcfg = DecodeConfig(step_attn=case[0], logits_impl=case[1],
                                kv_quant=case[2], **CHAIN)
            got = dec.generate(tp, W, dcfg, torch.from_numpy(enc))
            out[case] = (got, routes.k1, routes.k2)
    return out


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("logits_impl", ROUTES)
@pytest.mark.parametrize("step_attn", ROUTES)
def test_routes_match_jax(pair, port_runs, step_attn, logits_impl, quant):
    jp, _, enc = pair
    dcfg = DecodeConfig(step_attn=step_attn, logits_impl=logits_impl,
                        kv_quant=quant, **CHAIN)
    want = jdec.generate(jp, W, dcfg, jnp.asarray(enc))
    got, k1, k2 = port_runs[(step_attn, logits_impl, quant)]
    np.testing.assert_array_equal(_np(got["tokens"]),
                                  np.asarray(want["tokens"]))
    np.testing.assert_array_equal(_np(got["lengths"]),
                                  np.asarray(want["lengths"]))
    tol = TOL_P_STEP if (step_attn, quant) == ("xla", "int8") else TOL
    np.testing.assert_allclose(_np(got["hiddens"]),
                               np.asarray(want["hiddens"]), atol=tol,
                               rtol=0)
    # the fields pick the route: K1 once a layer a step, K2 once a
    # generated step, or never
    steps = int(got["lengths"].max())
    assert k1 == (steps * W.decoder_layers if step_attn == "fused" else 0)
    assert (k2 > 0) == (logits_impl == "fused")


def test_int8_xla_is_not_the_kernels_arithmetic(port_runs):
    """With int8 cross K/V the "xla" step quantizes q and p: its hiddens
    lie further than TOL_P_STEP from K1's, so a port that ignored
    step_attn would fail the "xla" int8 cases above."""
    fused = port_runs[("fused", "fused", "int8")][0]["hiddens"]
    xla = port_runs[("xla", "fused", "int8")][0]["hiddens"]
    assert float((fused - xla).abs().max()) > 2 * TOL_P_STEP


def test_auto_is_the_kernels(port_runs, pair):
    _, tp, enc = pair
    dcfg = DecodeConfig(kv_quant="int8", **CHAIN)
    assert wm.resolve_step_attn(dcfg.step_attn) == "fused"
    assert dec.resolve_logits_impl(dcfg) == "fused"
    got = dec.generate(tp, W, dcfg, torch.from_numpy(enc))
    want = port_runs[("fused", "fused", "int8")][0]
    for k in ("tokens", "lengths", "hiddens"):
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("field", ["step_attn", "logits_impl"])
def test_unknown_route_raises(pair, field):
    _, tp, enc = pair
    dcfg = DecodeConfig(**{field: "pallas"}, **CHAIN)
    with pytest.raises(ValueError, match=field):
        dec.generate(tp, W, dcfg, torch.from_numpy(enc))
    with pytest.raises(ValueError, match=field):
        (wm.resolve_step_attn(dcfg.step_attn) if field == "step_attn"
         else dec.resolve_logits_impl(dcfg))


def test_sampling_takes_the_xla_logits(pair, monkeypatch):
    """Sampling never reaches K2: "fused" resolves to "xla" and draws the
    same tokens from the same generator."""
    _, tp, enc = pair
    hot = DecodeConfig(temperature=0.7, **CHAIN)
    assert dec.resolve_logits_impl(hot.replace(logits_impl="fused")) \
        == "xla"
    outs = []
    for impl in ("fused", "xla"):
        routes = Routes(monkeypatch)
        outs.append(dec.generate(
            tp, W, hot.replace(logits_impl=impl), torch.from_numpy(enc),
            generator=torch.Generator().manual_seed(5)))
        assert routes.k2 == 0 and routes.k1 > 0
    for k in ("tokens", "lengths", "hiddens"):
        assert torch.equal(outs[0][k], outs[1][k]), k
