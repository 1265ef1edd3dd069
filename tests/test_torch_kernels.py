"""The plain PyTorch versions of the port's three CUDA kernels against the
JAX Pallas kernels they replace, run as the JAX tests run them on the CPU
(interpret=True) and against their XLA oracles; and the wrappers' CPU
dispatch. The kernels themselves run only on a GPU
(tests/test_torch_cuda.py, chip_smoke.py).

  K1 decode_cross_attention  f32, <= 1e-5 (sum order only)
  K2 fused_greedy_step       tokens equal, every mode
  K3 log_mel                 <= 1e-4 (f32 sums in another order, log10)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_transformers_tpu.core.config import MelConfig
from audio_transformers_tpu.ops import decode_attention as jda
from audio_transformers_tpu.ops import decode_logits as jdl
from audio_transformers_tpu.ops import logit_processors as jlp
from audio_transformers_tpu.ops.mel_pallas import log_mel_pallas
from audio_transformers_tpu_torch.ops import _build
from audio_transformers_tpu_torch.ops import decode_attention as da
from audio_transformers_tpu_torch.ops import decode_logits as dl
from audio_transformers_tpu_torch.ops import mel
from audio_transformers_tpu_torch.ops.mel_cuda import log_mel_cuda

K1_TOL = 1e-5
K3_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _np(x):
    return np.asarray(x.detach().cpu())


# --------------------------------------------------------------------------
# K1: decode-step cross-attention
# --------------------------------------------------------------------------


def _k1_inputs(rng, b=2, h=3, hd=16, t=40, quant="none"):
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, h, hd, t)).astype(np.float32)
    v = rng.standard_normal((b, h, hd, t)).astype(np.float32)
    if quant == "none":
        return q, k, v, None, None
    ks = (np.abs(k).max(axis=2) / 127.0).astype(np.float32)      # (B,H,T)
    vs = (np.abs(v).max(axis=3) / 127.0).astype(np.float32)      # (B,H,hd)
    kq = np.round(k / ks[:, :, None, :]).astype(np.int8)
    vq = np.round(v / vs[:, :, :, None]).astype(np.int8)
    return q, kq, vq, ks, vs


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("t,t_valid", [(40, None), (300, None), (256, 200)])
def test_k1_plain_matches_pallas(quant, t, t_valid):
    rng = np.random.default_rng(t)
    q, k, v, ks, vs = _k1_inputs(rng, t=t, quant=quant)
    kw = {} if ks is None else {"k_scale": ks, "v_scale": vs}
    want_kernel = np.asarray(jda.decode_cross_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        **{n: jnp.asarray(a) for n, a in kw.items()},
        block_t=128 if t_valid else None, t_valid=t_valid, interpret=True))
    tv = t_valid or t
    want_ref = np.asarray(jda.decode_cross_attention_reference(
        jnp.asarray(q), jnp.asarray(k[..., :tv]), jnp.asarray(v[..., :tv]),
        **{n: jnp.asarray(a[..., :tv] if n == "k_scale" else a)
           for n, a in kw.items()}))
    got = _np(da.decode_cross_attention(
        _t(q), _t(k), _t(v), **{n: _t(a) for n, a in kw.items()},
        t_valid=t_valid))
    np.testing.assert_allclose(got, want_kernel, atol=K1_TOL, rtol=0)
    np.testing.assert_allclose(got, want_ref, atol=K1_TOL, rtol=0)


def test_k1_custom_scale_and_bf16_dtype():
    rng = np.random.default_rng(7)
    q, k, v, _, _ = _k1_inputs(rng)
    want = np.asarray(jda.decode_cross_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.3))
    got = da.decode_cross_attention(_t(q), _t(k), _t(v), scale=0.3)
    np.testing.assert_allclose(_np(got), want, atol=K1_TOL, rtol=0)
    out = da.decode_cross_attention(_t(q).bfloat16(), _t(k).bfloat16(),
                                    _t(v).bfloat16())
    assert out.dtype == torch.bfloat16 and out.shape == q.shape


def test_k1_int4_waits():
    rng = np.random.default_rng(0)
    q, k, v, _, _ = _k1_inputs(rng)
    with pytest.raises(NotImplementedError):
        da.decode_cross_attention(_t(q), _t(k[..., :20]).to(torch.int8),
                                  _t(v[..., :20]).to(torch.int8),
                                  k_scale=torch.ones(2, 3, 2, 20),
                                  v_scale=torch.ones(2, 3, 16))


def test_pack_int4_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.integers(-8, 8, (3, 4, 10))
    want = np.asarray(jda.pack_int4(jnp.asarray(x)))
    got = _np(da.pack_int4(_t(x)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_np(da.unpack_int4(_t(want))),
                                  np.asarray(jda.unpack_int4(want)))
    np.testing.assert_array_equal(_np(da.unpack_int4(da.pack_int4(_t(x)))), x)


# --------------------------------------------------------------------------
# K2: fused greedy step
# --------------------------------------------------------------------------

V, VPAD, D, TB = 1900, 2048, 24, 1800


def _k2_inputs(seed, b=5):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((b, D)).astype(np.float32)
    table_t = np.zeros((D, VPAD), np.float32)
    table_t[:, :V] = rng.standard_normal((D, V)).astype(np.float32)
    add = np.zeros((1, VPAD), np.float32)
    add[0, V:] = jlp.NEG_INF
    add[0, rng.choice(V, 40, replace=False)] = jlp.NEG_INF
    seen = (rng.random((b, VPAD)) < 0.05).astype(np.int8)
    ban = (rng.random((b, VPAD)) < 0.01).astype(np.int8)
    return hidden, table_t, add, seen, ban


def _ts_bounds(seed, b=5):
    rng = np.random.default_rng(seed + 100)
    toks = rng.integers(0, V, (b, 12))
    toks[:, 0], toks[:, 1] = 1, 3
    ts_rows = rng.random((b, 12)) < 0.5
    toks = np.where(ts_rows, rng.integers(TB, V, (b, 12)), toks)
    pos = 2 + seed % 8
    return jlp.timestamp_row_bounds(jnp.asarray(toks), pos, begin_index=2,
                                    timestamp_begin=TB, eos_token_id=0)


@pytest.mark.parametrize("mode", ["plain", "seen", "ban", "seen_ban", "ts",
                                  "ts_seen_ban"])
@pytest.mark.parametrize("seed", range(3))
def test_k2_plain_tokens_equal_pallas(mode, seed):
    hidden, table_t, add, seen, ban = _k2_inputs(seed)
    kw = {}
    if "seen" in mode:
        kw["seen"], kw["penalty"] = seen, 1.15
    if "ban" in mode:
        kw["ban"] = ban
    if mode.startswith("ts"):
        kw["ts_bounds"], kw["timestamp_begin"] = _ts_bounds(seed), TB
    jkw = {n: (tuple(jnp.asarray(x) for x in a) if n == "ts_bounds"
               else jnp.asarray(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}
    want = np.asarray(jdl.fused_greedy_step(
        jnp.asarray(hidden), jnp.asarray(table_t), jnp.asarray(add),
        block_v=1024, interpret=True, **jkw))
    want_ref = np.asarray(jdl.fused_greedy_step_reference(
        jnp.asarray(hidden), jnp.asarray(table_t), jnp.asarray(add), **jkw))
    tkw = {n: (tuple(_t(np.asarray(x)) for x in a) if n == "ts_bounds"
               else _t(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}
    got = _np(dl.fused_greedy_step(_t(hidden), _t(table_t), _t(add), **tkw))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, want_ref)


def test_k2_ts_force_rule_is_exercised():
    # both branches of the probability rule occur across the seeds above
    forced = []
    for seed in range(3):
        hidden, table_t, add, _, _ = _k2_inputs(seed)
        bounds = tuple(_t(np.asarray(x)) for x in _ts_bounds(seed))
        tok = dl.fused_greedy_step(_t(hidden), _t(table_t), _t(add),
                                   ts_bounds=bounds, timestamp_begin=TB)
        forced += (_np(tok) >= TB).tolist()
    assert any(forced) and not all(forced)


def test_k2_ties_go_to_lowest_index():
    hidden = np.ones((2, 4), np.float32)
    table_t = np.zeros((4, 1024), np.float32)
    table_t[:, [7, 300, 900]] = 1.0      # equal maxima in separate tiles
    add = np.zeros((1, 1024), np.float32)
    want = np.asarray(jdl.fused_greedy_step(
        jnp.asarray(hidden), jnp.asarray(table_t), jnp.asarray(add),
        block_v=256, interpret=True))
    got = _np(dl.fused_greedy_step(_t(hidden), _t(table_t), _t(add)))
    assert got.tolist() == want.tolist() == [7, 7]


def test_k2_rejects_misuse():
    hidden, table_t, add, seen, _ = _k2_inputs(0)
    with pytest.raises(ValueError):
        dl.fused_greedy_step(_t(hidden), _t(table_t), _t(add), penalty=1.15)
    with pytest.raises(ValueError):
        dl.fused_greedy_step(_t(hidden), _t(table_t), _t(add),
                             seen=_t(seen))
    with pytest.raises(ValueError):
        dl.fused_greedy_step(_t(hidden), _t(table_t), _t(add[:, :100]))


def test_pad_vocab():
    assert dl.pad_vocab(51865) == jdl.pad_vocab(51865) == 52224
    assert dl.pad_vocab(1024) == 1024


# --------------------------------------------------------------------------
# K3: log-mel front end
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cfg_name,n", [("whisper", 16000), ("whisper", 4000),
                                        ("urbansound", 22050)])
def test_k3_plain_matches_pallas(cfg_name, n):
    cfg = getattr(MelConfig, cfg_name)()
    rng = np.random.default_rng(n)
    wav = (0.2 * rng.standard_normal((2, n))).astype(np.float32)
    want = np.asarray(log_mel_pallas(jnp.asarray(wav), cfg, interpret=True))
    got = _np(log_mel_cuda(_t(wav), cfg))
    assert got.shape == want.shape == (2, cfg.num_frames(n), cfg.n_mels)
    np.testing.assert_allclose(got, want, atol=K3_TOL, rtol=0)


def test_log_mel_precision_names():
    wav = torch.zeros(1, 1000)
    cfg = MelConfig.whisper()
    assert torch.equal(mel.log_mel(wav, cfg, precision="high"),
                       mel.log_mel(wav, cfg, precision="highest"))
    with pytest.raises(ValueError):
        mel.log_mel(wav, cfg, precision="low")


# --------------------------------------------------------------------------
# wrappers on the CPU: the plain version runs, no kernel is launched
# --------------------------------------------------------------------------


def test_cpu_dispatch_takes_plain_versions():
    _build.reset_stats()
    rng = np.random.default_rng(0)
    q, k, v, _, _ = _k1_inputs(rng)
    da.decode_cross_attention(_t(q), _t(k), _t(v))
    hidden, table_t, add, _, _ = _k2_inputs(0)
    dl.fused_greedy_step(_t(hidden), _t(table_t), _t(add))
    mel.log_mel(torch.zeros(1, 2000), MelConfig.whisper())
    for name, s in _build.STATS.items():
        assert s.launches == 0 and s.plain_cuda_calls == 0, name


def test_build_paths_are_keyed_by_source():
    paths = {name: _build.library_path(name)
             for name in _build.KERNEL_SOURCES}
    for name, p in paths.items():
        assert p.parent == _build.BUILD_DIR and p.name.startswith(name)
        assert (_build.CSRC / f"{name}.cu").exists()
    assert len(set(paths.values())) == len(paths)
    assert "-arch" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS
