"""The plain PyTorch versions of the port's three CUDA kernels against the
JAX Pallas kernels they replace, run as the JAX tests run them on the CPU
(interpret=True) and against their XLA oracles; and the wrappers' CPU
dispatch. The kernels themselves run only on a GPU
(tests/test_torch_cuda.py, chip_smoke.py).

  K1 decode_cross_attention  f32, <= 1e-5 (sum order only)
  K2 fused_greedy_step       tokens equal, every mode
  K3 log_mel                 <= 1e-4 (f32 sums in another order, log10)
"""

import re

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
from audio_transformers_tpu_torch.ops import mel_cuda as mc
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
@pytest.mark.parametrize("t,t_valid", [
    (40, None), (300, None), (256, 200),
    # on and next to the kernel's sub-tile and chunk edges (64, 128 or 256
    # keys, and whole multiples of them)
    (256, 1), (256, 31), (256, 32), (256, 33), (256, 63), (256, 64),
    (256, 65), (256, 127), (256, 128), (256, 129), (256, 256)])
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


_K1_PLAN_T = (1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 255, 256, 257, 511,
              512, 513, 700, 1500, 20000)


@pytest.mark.parametrize("hd", [1, 64])
@pytest.mark.parametrize("itemsize", [1, 2, 4])
@pytest.mark.parametrize("bh", [1, 6, 18, 24, 96, 288, 4096])
def test_k1_split_plan_covers_every_key_once(bh, itemsize, hd):
    tile = 256 // itemsize          # the kernel's sub-tile: 16 x 16 bytes
    per_sm = -(-2 * 132 // bh)      # splits that give two blocks per SM
    # splits whose partials (hd + 2 floats each) fit the kernel's ring of
    # 2 stages x K and V x hd rows x 17 16-byte segments, which the merge
    # stages them in
    cap = 2 * 2 * hd * 17 * 16 // (4 * (hd + 2))
    for t in _K1_PLAN_T:
        chunk, splits = da.split_plan(bh, t, itemsize, hd)
        # fixed for each (B*H, T): no state, no knob
        assert da.split_plan(bh, t, itemsize, hd) == (chunk, splits)
        # a chunk is a whole number of sub-tiles
        assert chunk >= tile and chunk % tile == 0
        # at least one block per (b, h); the splits tile [0, t) with no
        # gap or overlap, and the last one holds a key
        assert 1 <= splits <= cap
        starts = [i * chunk for i in range(splits)]
        assert starts[-1] < t <= starts[-1] + chunk
        covered = np.zeros(t, np.int64)
        for s in starts:
            covered[s:s + chunk] += 1
        assert (covered == 1).all()
        # two blocks per SM of the H100 wherever T has the sub-tiles for
        # it, else one sub-tile per split; or, where the ring bounds the
        # plan, more than half the splits it holds
        if 2 * splits <= cap:
            if -(-t // tile) >= per_sm:
                assert bh * splits >= 2 * 132
            else:
                assert chunk == tile


def test_k1_split_plan_at_the_serving_shapes():
    # whisper-tiny (6 heads of 64), T = 1500, bf16 cross K/V: B = 1, 4, 16
    assert da.split_plan(6, 1500, 2, 64) == (128, 12)
    assert da.split_plan(24, 1500, 2, 64) == (128, 12)
    assert da.split_plan(96, 1500, 2, 64) == (512, 3)
    assert da.split_plan(96, 1500, 1, 64) == (512, 3)
    # int4 plans its 750 packed bytes: 3 splits of one sub-tile (512 keys)
    assert da.split_plan(6, 750, 1, 64) == (256, 3)
    assert da.split_plan(96, 750, 1, 64) == (256, 3)
    # one (b, h) of long float32 K/V: the ring's 263 splits bound the plan
    assert da.split_plan(1, 20000, 4, 64) == (128, 157)


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


def _k1_int4_inputs(rng, b=2, h=3, hd=16, t=512):
    """Packed int4 K/V (B, H, hd, T/2) with even/odd K scales, as the
    reference's precompute_cross_attention(quant="int4") lays them out."""
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, h, hd, t)).astype(np.float32)
    v = rng.standard_normal((b, h, hd, t)).astype(np.float32)
    ks = (np.abs(k).max(axis=2) / 7.0).astype(np.float32)        # (B,H,T)
    vs = (np.abs(v).max(axis=3) / 7.0).astype(np.float32)        # (B,H,hd)
    kq = np.round(k / ks[:, :, None, :]).astype(np.int32)
    vq = np.round(v / vs[:, :, :, None]).astype(np.int32)
    kp = np.asarray(jda.pack_int4(jnp.asarray(kq)))
    vp = np.asarray(jda.pack_int4(jnp.asarray(vq)))
    ks2 = np.stack([ks[..., 0::2], ks[..., 1::2]], axis=2)       # (B,H,2,T/2)
    return q, kp, vp, ks2, vs


@pytest.mark.parametrize("t_valid", [None, 501, 256, 1])
def test_k1_int4_plain_matches_pallas(t_valid):
    # the int4 mode (a 4-D k_scale) against the JAX kernel interpreted and
    # its oracle; t_valid 501 is odd, so the high nibble of the last byte
    # is masked; T = 512 is the kernel's int4 time block at that length
    rng = np.random.default_rng(11)
    q, kp, vp, ks2, vs = _k1_int4_inputs(rng)
    jkw = {"k_scale": jnp.asarray(ks2), "v_scale": jnp.asarray(vs)}
    want_kernel = np.asarray(jda.decode_cross_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), **jkw,
        t_valid=t_valid, interpret=True))
    got = _np(da.decode_cross_attention(
        _t(q), _t(kp), _t(vp), k_scale=_t(ks2), v_scale=_t(vs),
        t_valid=t_valid))
    np.testing.assert_allclose(got, want_kernel, atol=K1_TOL, rtol=0)
    if t_valid is None or t_valid % 2 == 0:
        # the oracle has no t_valid: cut the packed bytes to the keys
        c = (t_valid or 512) // 2
        want_ref = np.asarray(jda.decode_cross_attention_reference(
            jnp.asarray(q), jnp.asarray(kp[..., :c]), jnp.asarray(vp[..., :c]),
            k_scale=jnp.asarray(ks2[..., :c]), v_scale=jnp.asarray(vs)))
        np.testing.assert_allclose(got, want_ref, atol=K1_TOL, rtol=0)
    # the packed keys are the int8 mode's keys with even/odd scales
    kq = _np(da.unpack_int4(_t(kp)))
    vq = _np(da.unpack_int4(_t(vp)))
    ks = ks2.transpose(0, 1, 3, 2).reshape(*ks2.shape[:2], -1)
    as_int8 = _np(da.decode_cross_attention(
        _t(q), _t(kq.astype(np.int8)), _t(vq.astype(np.int8)),
        k_scale=_t(ks), v_scale=_t(vs), t_valid=t_valid))
    np.testing.assert_allclose(got, as_int8, atol=K1_TOL, rtol=0)


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


@pytest.mark.parametrize("mode", ["seen_ban", "ts_seen_ban"])
@pytest.mark.parametrize("b", [1, 13])
def test_k2_plain_matches_pallas_at_batch(b, mode):
    # one row (the transcription window) and a batch that is not a
    # multiple of the kernels' 8-row groups
    hidden, table_t, add, seen, ban = _k2_inputs(b, b=b)
    kw = {"seen": seen, "penalty": 1.15, "ban": ban}
    if mode.startswith("ts"):
        kw["ts_bounds"], kw["timestamp_begin"] = _ts_bounds(b, b=b), TB
    jkw = {n: (tuple(jnp.asarray(x) for x in a) if n == "ts_bounds"
               else jnp.asarray(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}
    want = np.asarray(jdl.fused_greedy_step(
        jnp.asarray(hidden), jnp.asarray(table_t), jnp.asarray(add),
        block_v=1024, interpret=True, **jkw))
    tkw = {n: (tuple(_t(np.asarray(x)) for x in a) if n == "ts_bounds"
               else _t(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}
    got = _np(dl.fused_greedy_step(_t(hidden), _t(table_t), _t(add), **tkw))
    assert got.shape == (b,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("b", [1, 4, 16, 128])
@pytest.mark.parametrize("dim", [24, 64, 384, 512, 768, 1024, 1280])
def test_k2_plan_covers_every_id_once(dim, b):
    for v_pad in (1024, 52224):
        plan = dl.greedy_plan(b, dim, v_pad)
        assert plan.blocks == min(dl.H100_SMS, v_pad // dl.UNIT_V)
        ids = [dl.block_ids(plan, v_pad, i) for i in range(plan.blocks)]
        assert [v for r in ids for v in r] == list(range(v_pad))
        sizes = {len(r) for r in ids}
        assert min(sizes) >= dl.UNIT_V and max(sizes) - min(sizes) <= \
            dl.UNIT_V
        assert all(r.start % dl.UNIT_V == 0 for r in ids)
        # the row groups cover the batch exactly, the block fits
        assert plan.rows in dl.GROUP_ROWS
        assert (plan.groups - 1) * plan.rows < b <= plan.groups * plan.rows
        assert plan.smem == dl.sm90_smem_bytes(plan.rows, dim) \
            <= dl.SMEM_MAX
        # the table is read once per call up to B = 16 at every preset
        # width and up to B = 128 at whisper-tiny's
        if b <= 16 or dim <= 384:
            assert plan.groups == 1


def test_k2_plan_rejects_what_the_kernel_cannot_take():
    for dim, v_pad in ((20, 1024), (384, 1000), (0, 1024), (40000, 1024)):
        with pytest.raises(ValueError):
            dl.greedy_plan(1, dim, v_pad)


def test_k2_plan_constants_match_the_kernel_source():
    src = (_build.CSRC / "decode_logits_sm90.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert const("kUnit") == dl.UNIT_V
    assert const("kStageRows") == dl.STAGE_ROWS
    assert const("kThreads") == 256
    assert const("kStages") == dl.STAGES
    # Shape<NT>: units per warp by NT = rows / 8
    assert "static constexpr int UPW = NT <= 4 ? 4 : NT == 8 ? 2 : 1;" in src
    for rows, upw in dl.GROUP_UPW.items():
        nt = rows // 8
        assert upw == (4 if nt <= 4 else 2 if nt == 8 else 1)
    assert "constexpr int kMaxSmem = 232448 - 1024;" in src
    assert dl.SMEM_MAX == 232448 - 1024


def test_k2_source_routes_by_dtype():
    assert dict(dl.SOURCE) == {torch.bfloat16: "decode_logits_sm90",
                               torch.float32: "decode_logits"}
    assert set(dl.SOURCE.values()) <= set(_build.KERNEL_SOURCES)
    with pytest.raises(TypeError):
        dl.SOURCE[torch.float16] = "decode_logits"


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


def _radix_split(r):
    """The first factor A of the kernel's in-register DFT of r points
    (`Split` in csrc/mel.cu): 2, 3, 4 and 5 are direct (A = r); else 4, 5,
    3 or 2, the first that divides r."""
    if r in (2, 3, 4, 5):
        return r
    return next(a for a in (4, 5, 3, 2) if r % a == 0)


def _dft_emulated(v, r, rt, tw):
    """The kernel's in-register DFT of r points along axis 0 of v, in
    complex64, with tw[q] = W_rt^q from the float32 roots: direct for 2, 3,
    4, 5, else split r = a * b as the kernel does (a-point DFTs down the
    columns, the twiddle W_r^(n2 k1), b-point DFTs along the rows).
    Natural order out."""
    a = _radix_split(r)
    if a == r:
        k = np.arange(r)
        w = tw[(np.outer(k, k) % r) * (rt // r)]
        return np.einsum("kn,n...->k...", w, v).astype(np.complex64)
    b = r // a
    x = _dft_emulated(v.reshape(a, b, *v.shape[1:]), a, rt, tw)
    k1, n2 = np.meshgrid(np.arange(a), np.arange(b), indexing="ij")
    w = tw[((k1 * n2) % r) * (rt // r)]
    x = (x * w.reshape(a, b, *([1] * (v.ndim - 1)))).astype(np.complex64)
    y = _dft_emulated(np.swapaxes(x, 0, 1), b, rt, tw)        # [k2, k1]
    return y.reshape(r, *v.shape[1:])                          # k1 + a k2


def _fft_emulated(z, n_fft):
    """The kernel's two passes over z (n_fft, ...) complex64, with the
    tables the wrapper makes: z[n2 + R2 n1] -> R1-point DFTs over n1,
    times ptw[k1 R2 + n2], R2-point DFTs over n2 -> Z[k1 + R1 k2]."""
    r1, r2 = mc.fft_plan(n_fft)
    roots, ptw = mc.fft_tables(n_fft)
    x = _dft_emulated(z.reshape(r1, r2, *z.shape[1:]), r1, r1, roots[:r1])
    x = (x * ptw.reshape(r1, r2, *([1] * (z.ndim - 1)))).astype(np.complex64)
    y = _dft_emulated(np.swapaxes(x, 0, 1), r2, r2, roots[r1:])  # [k2, k1]
    return y.reshape(n_fft, *z.shape[1:])


@pytest.mark.parametrize("n_fft", [400, 1024])
def test_k3_fft_plan_matches_rfft(n_fft):
    rng = np.random.default_rng(n_fft)
    frames = rng.standard_normal((n_fft, 6)).astype(np.float32)
    frames *= mel.hann_window(n_fft)[:, None]
    # two frames as one complex signal, split by conjugate symmetry
    z = (frames[:, 0::2] + 1j * frames[:, 1::2]).astype(np.complex64)
    zk = _fft_emulated(z, n_fft)[: n_fft // 2 + 1]
    zm = _fft_emulated(z, n_fft)[(-np.arange(n_fft // 2 + 1)) % n_fft]
    spec_a = 0.5 * (zk + np.conj(zm))
    spec_b = (zk - np.conj(zm)) / 2j
    got = np.stack([spec_a, spec_b], axis=-1).reshape(n_fft // 2 + 1, 6)
    want = np.fft.rfft(frames.astype(np.float64), axis=0)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _pair_spectra(frames, n_fft):
    """The kernel's spectra of frames (n_fft, 2P) float32, paired (2p,
    2p + 1) into one complex signal and split by conjugate symmetry."""
    z = (frames[:, 0::2] + 1j * frames[:, 1::2]).astype(np.complex64)
    zz = _fft_emulated(z, n_fft)
    k = np.arange(n_fft // 2 + 1)
    zk, zm = zz[k], zz[(-k) % n_fft]
    out = np.empty((len(k), frames.shape[1]), np.complex64)
    out[:, 0::2] = 0.5 * (zk + np.conj(zm))
    out[:, 1::2] = (zk - np.conj(zm)) / 2j
    return out


def _k3_emulated(wav, cfg):
    """K3's log_eps features of wav (B, n) as the kernel computes them:
    frames in float32, the pair FFT, the power, the filterbank, the log."""
    padded = mel.prepare_waveform(torch.from_numpy(wav), cfg).numpy()
    t = (padded.shape[1] - cfg.n_fft) // cfg.hop_length + 1
    win = mel.hann_window(cfg.n_fft).astype(np.float32)
    fb = mel.mel_filter_bank(cfg).astype(np.float32)
    out = []
    for row in padded:
        frames = np.stack([row[i * cfg.hop_length:][:cfg.n_fft] * win
                           for i in range(t)]
                          + [np.zeros(cfg.n_fft, np.float32)] * (t % 2), 1)
        spec = _pair_spectra(frames, cfg.n_fft)[:, :t]
        power = (spec.real ** 2 + spec.imag ** 2).astype(np.float32)
        out.append(np.log(power.T @ fb + np.float32(mc.LOG_EPS)))
    return np.stack(out)


def test_k3_fft_error_unit_covers_the_emulated_kernel():
    """Each bin of the pair FFT errs by well under FFT_ERR * u * log2(N) *
    ||pair||_2, loud and quiet frames side by side included."""
    rng = np.random.default_rng(7)
    n = 1024
    frames = (0.3 * rng.standard_normal((n, 32))).astype(np.float32)
    frames *= mel.hann_window(n)[:, None].astype(np.float32)
    frames[:, 1::4] *= 1e-4
    frames[:, 2::4] = 0.0
    got = _pair_spectra(frames, n)
    want = np.fft.rfft(frames.astype(np.float64), axis=0)
    energy = (frames.astype(np.float64) ** 2).sum(0)
    pair = np.repeat(energy[0::2] + energy[1::2], 2)
    ratio = np.abs(got - want) / (2.0 ** -24 * np.log2(n) * np.sqrt(pair))
    assert ratio.max() <= mc.FFT_ERR / 4, ratio.max()


@pytest.mark.parametrize("signal", ["noise", "sine"])
@pytest.mark.parametrize("length", [512 * 128 + 1, 512 * 128 + 6, 512 * 40,
                                    66150, 512 * 129 + 3])
def test_k3_padded_clips_stay_within_the_pair_bound(signal, length):
    """UrbanSound's preset on clips zero-padded to 4 s: the emulated
    kernel against the plain version within K3_TOL + pair_error_bound.
    The lengths put the last frame with signal, or the first silent one,
    at either place of its pair."""
    cfg = MelConfig.urbansound()
    rng = np.random.default_rng(length)
    wav = np.zeros((3, 88200), np.float32)
    t = np.arange(length) / cfg.sample_rate
    wav[:, :length] = (0.3 * rng.standard_normal((3, length))
                       if signal == "noise" else
                       0.5 * np.sin(2 * np.pi * 440 * t)
                       + 0.05 * rng.standard_normal((3, length)))
    got = _k3_emulated(wav, cfg)
    plain = mel.log_mel_torch(torch.from_numpy(wav), cfg).numpy()
    power = mel.log_mel_torch(torch.from_numpy(wav),
                              cfg.replace(log_mode="none"))
    bound = mc.pair_error_bound(torch.from_numpy(wav), cfg, power).numpy()
    assert (np.abs(got - plain) <= K3_TOL + bound).all()
    # away from the padding the bound stays near float32's own rounding
    inside = bound[:, :length // cfg.hop_length - 2]
    assert np.median(inside) < 1e-4 and inside.max() < 1e-3


def test_k3_pair_bound_takes_log_eps_only():
    cfg = MelConfig.whisper()
    wav = torch.zeros((1, 4000))
    with pytest.raises(ValueError):
        mc.pair_error_bound(wav, cfg, torch.zeros((1, 26, 80)))


@pytest.mark.parametrize("n_fft", [401, 2048, 512, 300])
def test_k3_fft_plan_raises_for_what_it_cannot_factor(n_fft):
    with pytest.raises(ValueError):
        mc.fft_plan(n_fft)
    with pytest.raises(ValueError):
        mc.mel_plan(1, 3001, n_fft, 160, 132)


def test_k3_plan_constants_match_the_kernel_source():
    src = (_build.CSRC / "mel.cu").read_text()
    cases = dict(re.findall(
        r"case (\d+):(?:\s*//[^\n]*)?\s+return launch<(\d+, \d+)>", src))
    assert {int(k): tuple(map(int, v.split(", ")))
            for k, v in cases.items()} == mc.FFT_SPLITS
    for n_fft, (r1, r2) in mc.FFT_SPLITS.items():
        assert r1 * r2 == n_fft
    # the row strides of the shared-memory layout that mel_layout makes
    assert "constexpr int YS = R2 | 1;" in src
    assert "constexpr int PS = N / 2 + 1;" in src
    # Split<R>: direct for 2-5, else the first of 4, 5, 3, 2 dividing R
    assert ": R % 4 == 0                          ? 4" in src
    assert [_radix_split(r) for r in (2, 3, 4, 5, 8, 16, 20, 25, 32)] \
        == [2, 3, 4, 5, 4, 4, 4, 5, 4]


@pytest.mark.parametrize("cfg_name", ["whisper", "urbansound"])
def test_k3_bands_cover_the_filterbank(cfg_name):
    cfg = getattr(MelConfig, cfg_name)()
    fb = mel.mel_filter_bank(cfg)
    band, weights = mc.mel_bands(fb)
    lo, cnt, off = band.reshape(3, cfg.n_mels)
    dense = np.zeros_like(fb)
    for m in range(cfg.n_mels):
        dense[lo[m]:lo[m] + cnt[m], m] = weights[off[m]:off[m] + cnt[m]]
    assert np.array_equal(dense, fb)      # every nonzero, nothing else
    assert len(weights) < 0.07 * fb.size
    # the kernel's sum over a band's bins, in ascending order, has the
    # bits of the sum over every bin in the same order
    power = np.random.default_rng(0).exponential(
        size=(8, cfg.n_freqs)).astype(np.float32)
    for m in range(cfg.n_mels):
        sparse = np.zeros(8, np.float32)
        full = np.zeros(8, np.float32)
        for f in range(cfg.n_freqs):
            full = full + power[:, f] * fb[f, m]
        for i in range(cnt[m]):
            sparse = sparse + power[:, lo[m] + i] * weights[off[m] + i]
        assert full.dtype == sparse.dtype == np.float32
        assert np.array_equal(full, sparse), m


def _kernel_span(row, n, cfg, t0, fpb, t_total, mis):
    """The kernel's shared-memory span of the block at frame t0, for a row
    whose start lies `mis` floats past a 16-byte boundary: 16-byte chunks
    wholly inside the clip are copied, the rest of each chunk goes through
    the reflect / zero-pad index map. Returns span sample i at [i]."""
    hop, n_fft = cfg.hop_length, cfg.n_fft
    pad = n_fft // 2 if cfg.center else 0
    nf = min(fpb, t_total - t0)
    span = (nf - 1) * hop + n_fft
    j0 = t0 * hop - pad
    shift = (mis + j0) % 4
    length = n if n > n_fft else n_fft + 1
    xs = np.full(4 * ((span + shift + 3) // 4), np.nan, np.float32)
    for q in range(len(xs) // 4):
        j = j0 - shift + 4 * q
        if j >= 0 and j + 4 <= n:
            xs[4 * q: 4 * q + 4] = row[j: j + 4]
            continue
        for r in range(4):
            s = 4 * q + r
            if s < shift or s >= span + shift:
                continue
            jj = j + r
            jj = -jj if jj < 0 else 2 * (length - 1) - jj if jj >= length \
                else jj
            xs[s] = row[jj] if jj < n else 0.0
    return xs[shift: shift + span]


@pytest.mark.parametrize("n", [300, 401, 4000, 480000])
@pytest.mark.parametrize("center", [True, False])
def test_k3_load_index_map_matches_prepare_waveform(n, center):
    cfg = MelConfig.whisper().replace(center=center)
    row = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    want = mel.prepare_waveform(torch.from_numpy(row)[None], cfg)[0].numpy()
    t_total = (len(want) - cfg.n_fft) // cfg.hop_length + 1
    fpb = mc.mel_plan(1, t_total, cfg.n_fft, cfg.hop_length, 132)
    starts = range(0, t_total, fpb)
    if n == 480000:   # the blocks at the clip's two ends and one inside
        starts = [0, fpb * (t_total // (2 * fpb)), starts[-1]]
    for t0 in starts:
        for mis in range(4):
            got = _kernel_span(row, n, cfg, t0, fpb, t_total, mis)
            lo = t0 * cfg.hop_length
            assert np.array_equal(got, want[lo: lo + len(got)]), (t0, mis)


@pytest.mark.parametrize("n_fft,hop", [(400, 160), (1024, 512)])
@pytest.mark.parametrize("b,t_total", [(1, 3001), (4, 3001), (16, 3001),
                                       (1, 1), (3, 7), (2, 101)])
def test_k3_plan_covers_every_frame_once(n_fft, hop, b, t_total):
    fpb = mc.mel_plan(b, t_total, n_fft, hop, 132)
    assert fpb % 2 == 0 and 2 <= fpb <= mc.MAX_FRAMES
    assert mc.mel_layout(fpb, hop, n_fft)[1] <= mc._SMEM_LIMIT
    seen = np.zeros(t_total, np.int64)
    for t0 in range(0, t_total, fpb):                 # the kernel's blocks
        seen[t0: t0 + min(fpb, t_total - t0)] += 1
    assert (seen == 1).all()
    if b * t_total >= 2 * 132:      # every SM gets a block
        assert b * -(-t_total // fpb) >= 132


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
