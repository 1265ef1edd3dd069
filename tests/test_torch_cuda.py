"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on a GPU. Every test here needs a CUDA device and nvcc and
skips without them. The file imports no JAX, so it runs on a machine
without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances, each against the plain version on the same card:
  K1 decode_cross_attention: 1e-5 abs in float32 (sum order only);
     2e-2 abs in bfloat16 (one bf16 ulp of the output)
  K2 fused_greedy_step: tokens equal on rows whose plain top-2 gap
     exceeds 1e-3
  K3 log_mel: 2e-4 abs on the final features (f32 sum order, log10);
     and the float64 golden `reference_log_mel` within 2e-5 + 1e-5 |ref|,
     the tolerance the JAX package's golden test holds
  K4a/b/c flash attention: float32 max|err| <= 2e-5 * max(1, max|plain|)
     (sum order only); bfloat16 within two bf16 ulps at the tensor's
     largest magnitude (bf16 output rounding, p rounded against the
     kernel's running maximum), for dq and dk taken no smaller than
     2^-17 * d * max|dO| * max|v| * max(max|q|, max|k|): ds = p (dP -
     delta) cancels (exactly when Tk = 1) down to float32 sum-order noise
     of about 2^-24 * d * max|dO| * max|v| per entry
  K5 permute_rows: bit for bit (a pure copy)
"""

import math

import numpy as np
import pytest
import torch

from audio_transformers_tpu_torch.core import params as cp
from audio_transformers_tpu_torch.core.config import (DecodeConfig,
                                                      EmotionWhisperConfig,
                                                      MelConfig, WhisperConfig)
from audio_transformers_tpu_torch.models.whisper import decode as dec
from audio_transformers_tpu_torch.models.whisper import model as wm
from audio_transformers_tpu_torch.ops import _build
from audio_transformers_tpu_torch.ops import attention as att
from audio_transformers_tpu_torch.ops import decode_attention as da
from audio_transformers_tpu_torch.ops import decode_logits as dl
from audio_transformers_tpu_torch.ops import logit_processors as lp
from audio_transformers_tpu_torch.ops import mel
from audio_transformers_tpu_torch.ops import permute as pm

pytestmark = pytest.mark.cuda

K1_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
K2_GAP = 1e-3
K3_TOL = 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU)")
    # the plain versions are the oracle: keep their f32 math exact
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


# --------------------------------------------------------------------------
# K1
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape,t_valid", [((2, 3, 16, 40), None),
                                           ((4, 6, 64, 1500), None),
                                           ((1, 2, 64, 1024), 700)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_k1_matches_plain(cuda, shape, t_valid, dtype, quant):
    g = _gen(0)
    b, h, hd, t = shape
    q = torch.randn((b, h, hd), generator=g, device=cuda)
    k = torch.randn(shape, generator=g, device=cuda)
    v = torch.randn(shape, generator=g, device=cuda)
    kw = {}
    if quant == "int8":
        ks, vs = k.abs().amax(dim=2) / 127.0, v.abs().amax(dim=3) / 127.0
        k = torch.round(k / ks[:, :, None, :]).to(torch.int8)
        v = torch.round(v / vs[:, :, :, None]).to(torch.int8)
        kw = {"k_scale": ks, "v_scale": vs}
    else:
        k, v = k.to(dtype), v.to(dtype)
    q = q.to(dtype)
    before = _build.STATS["decode_cross_attention"].launches
    got = da.decode_cross_attention(q, k, v, t_valid=t_valid, **kw)
    assert _build.STATS["decode_cross_attention"].launches == before + 1
    tv = t_valid or t
    if t_valid:
        kw = {n: (x[..., :tv].contiguous() if n == "k_scale" else x)
              for n, x in kw.items()}
    want = da.decode_cross_attention_reference(
        q, k[..., :tv].contiguous(), v[..., :tv].contiguous(), **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= K1_TOL[dtype], err


_K1_MODES = (  # (q dtype, K/V dtype)
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16), (torch.float32, torch.int8),
    (torch.bfloat16, torch.int8))


def _k1_operands(cuda, b, t, q_dtype, kv_dtype, g, h=6, hd=64):
    q = torch.randn((b, h, hd), generator=g, device=cuda)
    k = torch.randn((b, h, hd, t), generator=g, device=cuda)
    v = torch.randn((b, h, hd, t), generator=g, device=cuda)
    kw = {}
    if kv_dtype == torch.int8:
        ks, vs = k.abs().amax(dim=2) / 127.0, v.abs().amax(dim=3) / 127.0
        k = torch.round(k / ks[:, :, None, :]).to(torch.int8)
        v = torch.round(v / vs[:, :, :, None]).to(torch.int8)
        kw = {"k_scale": ks, "v_scale": vs}
    return q.to(q_dtype), k.to(kv_dtype), v.to(kv_dtype), kw


@pytest.mark.parametrize("t,t_valid", [
    *((1500, tv) for tv in (1, 32, 33, 63, 64, 65, 127, 128, 129, 700,
                           1500)),
    (20000, 20000), (20000, 12345)])
@pytest.mark.parametrize("b", [1, 3, 4, 16, 48])
def test_k1_split_matches_plain(cuda, b, t, t_valid):
    # T split across blocks (split_plan), the partials merged by the last
    # block of each (b, h): every mode, t_valid on and around chunk
    # edges, T beyond the old shared-memory limit, two launches bit-equal
    g = _gen(b * 131 + t_valid)
    for q_dtype, kv_dtype in _K1_MODES:
        q, k, v, kw = _k1_operands(cuda, b, t, q_dtype, kv_dtype, g)
        before = _build.STATS["decode_cross_attention"].launches
        got = da.decode_cross_attention(q, k, v, t_valid=t_valid, **kw)
        got2 = da.decode_cross_attention(q, k, v, t_valid=t_valid, **kw)
        assert _build.STATS["decode_cross_attention"].launches == before + 2
        want = da.decode_cross_attention_reference(
            q, k[..., :t_valid].contiguous(), v[..., :t_valid].contiguous(),
            **{n: x[..., :t_valid].contiguous() if n == "k_scale" else x
               for n, x in kw.items()})
        torch.cuda.synchronize()
        mode = f"q {q_dtype}, K/V {kv_dtype}"
        assert got.dtype == q_dtype and got.shape == q.shape, mode
        assert torch.equal(got, got2), mode
        err = (got.float() - want.float()).abs().max().item()
        assert err <= K1_TOL[q_dtype], (mode, err)


@pytest.mark.parametrize("hd", [8, 64, 128])
def test_k1_long_row_merges_in_one_round(cuda, hd):
    # one (b, h) of 40000 keys: split_plan stops at the splits whose
    # partials the merging block stages at once (157 or 209 here)
    g = _gen(hd)
    for q_dtype, kv_dtype in _K1_MODES:
        q, k, v, kw = _k1_operands(cuda, 1, 40000, q_dtype, kv_dtype, g,
                                   h=1, hd=hd)
        got = da.decode_cross_attention(q, k, v, **kw)
        got2 = da.decode_cross_attention(q, k, v, **kw)
        want = da.decode_cross_attention_reference(q, k, v, **kw)
        torch.cuda.synchronize()
        mode = f"q {q_dtype}, K/V {kv_dtype}"
        assert torch.equal(got, got2), mode
        err = (got.float() - want.float()).abs().max().item()
        assert err <= K1_TOL[q_dtype], (mode, err)


def _k1_int4_operands(cuda, b, t, q_dtype, g, h=6, hd=64):
    """q and int4 K/V packed along time (B, H, hd, T/2), the K scales
    split even/odd (B, H, 2, T/2), as precompute_cross_attention makes
    them."""
    q = torch.randn((b, h, hd), generator=g, device=cuda)
    k = torch.randn((b, h, hd, t), generator=g, device=cuda)
    v = torch.randn((b, h, hd, t), generator=g, device=cuda)
    ks, vs = k.abs().amax(dim=2) / 7.0, v.abs().amax(dim=3) / 7.0
    kp = da.pack_int4(torch.round(k / ks[:, :, None, :]))
    vp = da.pack_int4(torch.round(v / vs[:, :, :, None]))
    ks2 = torch.stack([ks[..., 0::2], ks[..., 1::2]], dim=2).contiguous()
    return q.to(q_dtype), kp, vp, {"k_scale": ks2, "v_scale": vs}


@pytest.mark.parametrize("t,t_valid", [
    *((1500, tv) for tv in (1, 2, 63, 511, 512, 513, 1023, 1499, 1500)),
    (20000, 20000), (20000, 12345)])
@pytest.mark.parametrize("b", [1, 3, 4, 16, 48])
@pytest.mark.parametrize("hd", [8, 64, 128])
def test_k1_int4_matches_plain(cuda, hd, b, t, t_valid):
    # int4 (nibble-packed K/V, even/odd K scales): t_valid odd masks the
    # high nibble of the last byte; chunks of 256 bytes (512 keys); T
    # = 1500 puts the 750-byte rows 14 bytes off the 16-byte grid; two
    # launches bit-equal
    g = _gen(hd * 7 + b * 131 + t_valid)
    for q_dtype in (torch.float32, torch.bfloat16):
        q, kp, vp, kw = _k1_int4_operands(cuda, b, t, q_dtype, g, hd=hd)
        before = _build.STATS["decode_cross_attention"].launches
        got = da.decode_cross_attention(q, kp, vp, t_valid=t_valid, **kw)
        got2 = da.decode_cross_attention(q, kp, vp, t_valid=t_valid, **kw)
        assert _build.STATS["decode_cross_attention"].launches == before + 2
        want = da.decode_cross_attention_reference(q, kp, vp,
                                                   t_valid=t_valid, **kw)
        torch.cuda.synchronize()
        assert got.dtype == q_dtype and got.shape == q.shape
        assert torch.equal(got, got2), q_dtype
        err = (got.float() - want.float()).abs().max().item()
        assert err <= K1_TOL[q_dtype], (q_dtype, err)


@pytest.mark.parametrize("hd", [8, 64, 128])
def test_k1_int4_long_row_merges_in_one_round(cuda, hd):
    g = _gen(hd + 1)
    for q_dtype in (torch.float32, torch.bfloat16):
        q, kp, vp, kw = _k1_int4_operands(cuda, 1, 40000, q_dtype, g, h=1,
                                          hd=hd)
        got = da.decode_cross_attention(q, kp, vp, t_valid=39999, **kw)
        got2 = da.decode_cross_attention(q, kp, vp, t_valid=39999, **kw)
        want = da.decode_cross_attention_reference(q, kp, vp, t_valid=39999,
                                                   **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, got2), q_dtype
        err = (got.float() - want.float()).abs().max().item()
        assert err <= K1_TOL[q_dtype], (q_dtype, err)


def test_k1_rejects_bad_operands(cuda):
    q = torch.randn((1, 2, 16), device=cuda)
    k = torch.randn((1, 2, 16, 32), device=cuda)
    with pytest.raises(ValueError):
        da.decode_cross_attention(q, k.cpu(), k)
    with pytest.raises(ValueError):
        da.decode_cross_attention(q, k.transpose(2, 3).contiguous()
                                  .transpose(2, 3), k)
    with pytest.raises(TypeError):
        da.decode_cross_attention(q.half(), k, k)
    # int4: the K scales are (B, H, 2, T/2) and t_valid counts keys
    kp = torch.zeros((1, 2, 16, 16), dtype=torch.int8, device=cuda)
    vs = torch.ones((1, 2, 16), device=cuda)
    with pytest.raises(ValueError):
        da.decode_cross_attention(q, kp, kp, v_scale=vs,
                                  k_scale=torch.ones((1, 2, 1, 16),
                                                     device=cuda)[:, :, :2])
    with pytest.raises(ValueError):
        da.decode_cross_attention(q, kp, kp, v_scale=vs, t_valid=33,
                                  k_scale=torch.ones((1, 2, 2, 16),
                                                     device=cuda))


# --------------------------------------------------------------------------
# K2
# --------------------------------------------------------------------------


def _k2_case(cuda, b, v, d, dtype, seed):
    g = _gen(seed)
    v_pad = dl.pad_vocab(v)
    table_t = torch.zeros((d, v_pad), device=cuda)
    table_t[:, :v] = torch.randn((d, v), generator=g, device=cuda) * 0.05
    hidden = torch.randn((b, d), generator=g, device=cuda)
    add = lp.suppress_vector(v_pad, (3, 17, v // 2), vocab=v, device=cuda)
    seen = (torch.rand((b, v_pad), generator=g, device=cuda) < 0.05
            ).to(torch.int8)
    ban = (torch.rand((b, v_pad), generator=g, device=cuda) < 0.01
           ).to(torch.int8)
    return hidden.to(dtype), table_t.to(dtype), add, seen, ban


def _decidable(l, ts, tb):
    def gap(x):
        top = x.topk(2, dim=-1).values
        return top[:, 0] - top[:, 1]
    if not ts:
        return gap(l) > K2_GAP
    margin = torch.logsumexp(l[:, tb:], dim=-1) - l[:, :tb].amax(dim=-1)
    region = torch.where(margin > 0, gap(l[:, tb:]), gap(l))
    return (margin.abs() > K2_GAP) & (region > K2_GAP)


def _k2_kwargs(cuda, b, v, mode, seen, ban):
    kw = {}
    if "seen" in mode:
        kw.update(seen=seen, penalty=1.15)
    if "ban" in mode:
        kw["ban"] = ban
    if mode == "ts":
        tb = v - 300
        g = _gen(2)
        hist = torch.randint(0, tb, (b, 12), generator=g, device=cuda)
        state = torch.arange(b, device=cuda) % 3
        ts_tok = torch.randint(tb, v, (b, 2), generator=g, device=cuda)
        hist[state == 0, 6:8] = ts_tok[state == 0]
        hist[state == 1, 7] = ts_tok[state == 1, 0]
        hist[state == 2, 5] = ts_tok[state == 2, 0]
        kw.update(ts_bounds=lp.timestamp_row_bounds(
            hist, 8, begin_index=2, timestamp_begin=tb, eos_token_id=0),
            timestamp_begin=tb)
    return kw


# D = 24 at a small vocab; whisper-tiny's D = 384 and large's 1280 at the
# real one. bf16 runs the tensor-core kernel (decode_logits_sm90.cu),
# float32 the FMA one (decode_logits.cu).
@pytest.mark.parametrize("b", [1, 3, 4, 16, 128])
@pytest.mark.parametrize("d", [24, 384, 1280])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["plain", "seen", "ban", "seen_ban", "ts"])
def test_k2_matches_plain(cuda, b, d, dtype, mode):
    v = 1900 if d == 24 else 51865
    hidden, table_t, add, seen, ban = _k2_case(cuda, b, v, d, dtype, 1)
    kw = _k2_kwargs(cuda, b, v, mode, seen, ban)
    before = _build.STATS["fused_greedy_step"].launches
    got = dl.fused_greedy_step(hidden, table_t, add, **kw)
    assert _build.STATS["fused_greedy_step"].launches == before + 1
    got2 = dl.fused_greedy_step(hidden, table_t, add, **kw)
    want = dl.fused_greedy_step_reference(hidden, table_t, add, **kw)
    ok = _decidable(dl.processed_logits(hidden, table_t, add, **kw),
                    mode == "ts", v - 300)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (b,)
    assert torch.equal(got, got2)
    assert ok.any()
    assert torch.equal(got[ok], want[ok])


# the vocab-shard mode (tensor parallelism): each of t shards' partials
# from one launch beside the plain version's (the max within float32 sum
# order), merged into the unsharded kernel's tokens on decidable rows;
# timestamp_begin falls inside a shard at d = 24 (v = 1900: shards of
# 1024, 512, 256 ids) and on the last shard at the real vocab
@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("b", [1, 4, 16, 128])
@pytest.mark.parametrize("d", [24, 384])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["seen_ban", "ts"])
def test_k2_partials_merge_to_the_unsharded_tokens(cuda, t, b, d, dtype,
                                                   mode):
    v = 1900 if d == 24 else 51865
    hidden, table_t, add, seen, ban = _k2_case(cuda, b, v, d, dtype, 4)
    kw = _k2_kwargs(cuda, b, v, mode, seen, ban)
    w = dl.pad_vocab(v) // t
    stats = _build.STATS["fused_greedy_step_partials"]
    parts, plain = [], []
    for r in range(t):
        cols = slice(r * w, (r + 1) * w)
        shard = dict(kw)
        for name in ("seen", "ban"):
            if name in kw:
                shard[name] = kw[name][:, cols].contiguous()
        args = (hidden, table_t[:, cols].contiguous(),
                add[cols].contiguous())
        before = stats.launches
        parts.append(dl.fused_greedy_step(*args, vocab_offset=r * w,
                                          partials=True, **shard))
        assert stats.launches == before + 1
        plain.append(dl.fused_greedy_step_partials_reference(
            *args, vocab_offset=r * w, **shard))
    parts, plain = torch.stack(parts), torch.stack(plain)
    whole = dl.fused_greedy_step(hidden, table_t, add, **kw)
    ok = _decidable(dl.processed_logits(hidden, table_t, add, **kw),
                    mode == "ts", v - 300)
    torch.cuda.synchronize()
    assert parts.shape == (t, b, 6 if mode == "ts" else 2)
    assert float((parts[..., 0] - plain[..., 0]).abs().max()) <= 1e-4
    assert ok.any()
    assert torch.equal(dl.merge_partials(parts)[ok], whole[ok])
    assert torch.equal(dl.merge_partials(plain)[ok], whole[ok])


def test_k2_float32_from_two_threads_on_one_stream(cuda):
    """The float32 route launches two passes; two threads calling it at
    once on the one current stream may launch between each other's
    passes, so each call's partials are its own: every token is the one
    that call gives alone."""
    import threading
    b, v, d = 8, 51865, 384
    cases = [_k2_case(cuda, b, v, d, torch.float32, seed) for seed in (5, 6)]
    want = [dl.fused_greedy_step(h, t, a, seen=s, penalty=1.15, ban=n)
            for h, t, a, s, n in cases]
    assert not torch.equal(want[0], want[1])
    got, errors = [[], []], []

    def run(i):
        try:
            h, t, a, s, n = cases[i]
            for _ in range(300):
                got[i].append(dl.fused_greedy_step(h, t, a, seen=s,
                                                   penalty=1.15, ban=n))
        except Exception as e:      # reported below, in the test's thread
            errors.append(e)
    threads = [threading.Thread(target=run, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    torch.cuda.synchronize()
    wrong = [(i, n) for i in (0, 1) for n, x in enumerate(got[i])
             if not torch.equal(x, want[i])]
    assert not wrong, f"{len(wrong)} of 600 calls wrong"


def test_k2_merge_counter_resets_itself(cuda):
    # the last block of each row group merges and zeroes its counter: many
    # calls in a row on one stream, and calls on a second stream (its own
    # counters and partials), give the same tokens
    b, v, d = 40, 51865, 1280      # several row groups at this width
    hidden, table_t, add, seen, ban = _k2_case(cuda, b, v, d,
                                               torch.bfloat16, 3)
    assert dl.greedy_plan(b, d, dl.pad_vocab(v)).groups >= 2
    kw = _k2_kwargs(cuda, b, v, "ts", seen, ban)
    first = dl.fused_greedy_step(hidden, table_t, add, **kw)
    runs = [dl.fused_greedy_step(hidden, table_t, add, **kw)
            for _ in range(50)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        on_side = [dl.fused_greedy_step(hidden, table_t, add, **kw)
                   for _ in range(5)]
    torch.cuda.synchronize()
    for t in runs + on_side:
        assert torch.equal(t, first)
    want = dl.fused_greedy_step_reference(hidden, table_t, add, **kw)
    ok = _decidable(dl.processed_logits(hidden, table_t, add, **kw), True,
                    v - 300)
    assert torch.equal(first[ok], want[ok])
    dev = torch.cuda.current_device()
    assert len({k for k in dl._SCRATCH if k[0] == dev}) >= 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v_pad,ids", [(1024, [7, 300, 900]),
                                       (52224, [7, 26000, 52000])])
def test_k2_ties_go_to_lowest_index(cuda, dtype, v_pad, ids):
    # equal maxima in different blocks of either kernel's split
    hidden = torch.ones((2, 16), device=cuda, dtype=dtype)
    table_t = torch.zeros((16, v_pad), device=cuda, dtype=dtype)
    table_t[:, ids] = 1.0
    add = torch.zeros((1, v_pad), device=cuda)
    if dtype == torch.bfloat16:
        plan = dl.greedy_plan(2, 16, v_pad,
                              dl.sm_count(torch.cuda.current_device()))
        owner = [next(i for i in range(plan.blocks)
                      if t in dl.block_ids(plan, v_pad, i)) for t in ids]
        assert len(set(owner)) == len(ids)
    assert dl.fused_greedy_step(hidden, table_t, add).tolist() == [7, 7]


def test_k2_sources_take_one_dtype_each(cuda):
    # float32's kernel is the FMA one (its parity route): it refuses bf16,
    # which only the tensor-core source takes (its entry point has no
    # dtype argument)
    x = torch.zeros((2, 64), device=cuda, dtype=torch.bfloat16)
    table_t = torch.zeros((64, 1024), device=cuda, dtype=torch.bfloat16)
    add = torch.zeros(1024, device=cuda)
    part = torch.zeros(4096, device=cuda)
    out = torch.zeros(2, device=cuda, dtype=torch.int32)
    fn = _build.function(dl.SOURCE[torch.float32], "fused_greedy_step",
                         dl._ARGTYPES)
    rc = fn(_build.ptr(x), _build.ptr(table_t), _build.ptr(add), None,
            None, 1.0, None, None, None, 0, 2, 64, 1024,
            dl._DTYPES[torch.bfloat16], _build.ptr(part), _build.ptr(part),
            _build.ptr(out), 0, None, _build.stream_ptr(x))
    assert rc != 0


def test_k2_rejects_bad_operands(cuda):
    hidden, table_t, add, _, _ = _k2_case(cuda, 2, 1900, 24,
                                          torch.bfloat16, 4)
    # a contiguous view 2 bytes off a 16-byte boundary
    buf = torch.zeros(2 * 24 + 1, device=cuda, dtype=torch.bfloat16)
    off = buf[1:].view(2, 24)
    off.copy_(hidden)
    with pytest.raises(ValueError):
        dl.fused_greedy_step(off, table_t, add)
    # D must be a multiple of 8 for the bf16 kernel's 16-byte copies
    h20 = torch.zeros((2, 20), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        dl.fused_greedy_step(h20, table_t[:20].contiguous(), add)
    with pytest.raises(TypeError):
        dl.fused_greedy_step(hidden.half(), table_t.half(), add)


# --------------------------------------------------------------------------
# K3
# --------------------------------------------------------------------------


_K3_EPS = MelConfig.whisper().replace(log_mode="log_eps", power=1.0,
                                      drop_last_frame=False)


@pytest.mark.parametrize("cfg,b,n", [
    (MelConfig.whisper(), 1, 480000),
    (MelConfig.whisper(), 4, 480000),
    (MelConfig.whisper(), 16, 480000),
    (MelConfig.whisper(), 3, 4000),
    (MelConfig.whisper(), 1, 300),
    (MelConfig.whisper(), 4, 16001),      # rows at every 16-byte offset
    (_K3_EPS, 2, 16000),
    (MelConfig.urbansound(), 2, 88200),
    (MelConfig.urbansound(), 16, 88200),  # above 48 KB of shared memory
    (MelConfig.urbansound(), 3, 1000),
])
def test_k3_matches_plain(cuda, cfg, b, n):
    # the kernel reads the caller's storage as it lies: a view 3 floats
    # past a 16-byte boundary
    flat = 0.3 * torch.randn(b * n + 3, generator=_gen(3), device=cuda)
    wav = flat[3:].view(b, n)
    before = _build.STATS["log_mel"].launches
    got = mel.log_mel(wav, cfg)
    got2 = mel.log_mel(wav, cfg)
    assert _build.STATS["log_mel"].launches == before + 2
    want = mel.log_mel_torch(wav, cfg)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (b, cfg.num_frames(max(n, cfg.n_fft + 1)),
                                       cfg.n_mels)
    assert (got - want).abs().max().item() <= K3_TOL
    assert torch.equal(got, got2)
    # the float64 golden, bin by bin within the larger of the tolerance the
    # JAX package is held to and mel_cuda.golden_error_bound (how far any
    # float32 front end may lie from it); a clip no longer than n_fft is
    # zero-padded to n_fft + 1 first
    from audio_transformers_tpu_torch.ops import mel_cuda as mc
    clips = wav.cpu().numpy()
    if n <= cfg.n_fft:
        clips = np.pad(clips, ((0, 0), (0, cfg.n_fft + 1 - n)))
    ref = np.stack([mel.reference_log_mel(c, cfg) for c in clips])
    limit = 2e-5 + 1e-5 * np.abs(ref)
    if cfg.power == 2.0:
        limit = np.maximum(limit, mc.golden_error_bound(
            torch.from_numpy(clips), cfg).numpy())
    assert (np.abs(got.cpu().numpy() - ref) <= limit).all()


@pytest.mark.parametrize("cfg", [MelConfig.whisper(),
                                 MelConfig.urbansound()],
                         ids=["whisper", "urbansound"])
def test_k3_every_block_size_gives_the_same_bits(cuda, cfg):
    # blocks start at even frames at every even size, so each frame's FFT
    # partner, and with it every bit of the features, is the same whatever
    # mel_plan picks
    from audio_transformers_tpu_torch.ops import mel_cuda as mc
    wav = 0.3 * torch.randn((2, 16001), generator=_gen(4), device=cuda)
    t_full = 16001 // cfg.hop_length + 1
    sizes = [f for f in range(2, mc.MAX_FRAMES + 1, 2)
             if mc.mel_layout(f, cfg.hop_length, cfg.n_fft)[1]
             <= mc._SMEM_LIMIT]
    outs = [mc._launch(wav, cfg, t_full, fpb=f) for f in sizes]
    assert len(outs) >= 4
    for f, out in zip(sizes, outs):
        assert torch.equal(out, outs[0]), f


@pytest.mark.parametrize("signal", ["noise", "sine"])
@pytest.mark.parametrize("length", [66150, 512 * 128 + 1, 512 * 128 + 6,
                                    512 * 129 + 3, 512 * 40, 30000])
def test_k3_urbansound_padded_clips_match_plain(cuda, signal, length):
    """Clips zero-padded to 4 s, as UrbanSoundLocalSource pads them:
    each frame's rounding scales with its own energy, the kernel balancing
    a quiet frame against a loud partner (mel_cuda.frame_error_bound)."""
    cfg = MelConfig.urbansound()
    g = _gen(length)
    wav = torch.zeros((8, 88200), device=cuda)
    t = torch.arange(length, device=cuda) / cfg.sample_rate
    noise = torch.randn((8, length), generator=g, device=cuda)
    wav[:, :length] = (0.3 * noise if signal == "noise" else
                       0.5 * torch.sin(2 * math.pi * 440 * t) + 0.05 * noise)
    got = mel.log_mel(wav, cfg)
    assert torch.equal(got, mel.log_mel(wav, cfg))
    want = mel.log_mel_torch(wav, cfg)
    power = mel.log_mel_torch(wav, cfg.replace(log_mode="none"))
    from audio_transformers_tpu_torch.ops import mel_cuda as mc
    bound = mc.frame_error_bound(wav, cfg, power)
    err = (got - want).abs().double()
    assert (err <= K3_TOL + bound).all(), (err - bound).max().item()


_US_SMALL = dict(n_mels=64, num_classes=10, conv_dim=32, encoder_dim=32,
                 num_encoder_blocks=2, num_heads=4, dropout=0.0,
                 cnn_dims=(32, 48))


@pytest.mark.parametrize("seconds", [4.0, 3.0])
def test_classifier_step_on_cuda_matches_cpu(cuda, seconds, monkeypatch):
    """3 train steps and one eval at the test widths in float32, the card
    (K3) against the CPU (plain versions); 3 s clips zero-padded to 4 s as
    the local source pads them. Losses within 1e-4 relative. The first
    step against a CPU step fed the card's features (K3's own rounding is
    held by the K3 tests): each leaf's gradient within 1e-4 * max(1, max
    |g|), a leaf whose CPU gradient is rounding (under 1e-6 of the
    largest; the exact gradient is 0 for the conv biases before
    BatchNorm and the key biases) rounding on the card too; the params
    after that Adam step within 1e-6 where the CPU gradient exceeds its
    tolerance, else within 2 lr; the BN state within 1e-6 + 1e-5 |x|."""
    from audio_transformers_tpu_torch.core.config import (OptimizerConfig,
                                                          TrainConfig,
                                                          UrbanSoundConfig)
    from audio_transformers_tpu_torch.data.synthetic import \
        SyntheticClassification
    from audio_transformers_tpu_torch.models.urbansound import model as us
    from audio_transformers_tpu_torch.train import classifier as tc
    from audio_transformers_tpu_torch.train.common import batch_to_device
    from audio_transformers_tpu_torch.train.optim import build_optimizer
    cfg, mel_cfg = UrbanSoundConfig(**_US_SMALL), MelConfig.urbansound()
    # the eval loss takes in the running means, which took in the conv
    # biases' rounding-driven Adam steps (lr either way): a small lr keeps
    # that drift under the losses' tolerance
    lr = 1e-4
    tcfg = TrainConfig(batch_size=8, compute_dtype="float32",
                       optimizer=OptimizerConfig(name="adam",
                                                 learning_rate=lr))
    ds = SyntheticClassification(num_samples=8, num_classes=10, seed=3)
    batch = next(ds.batcher(8).train_epochs(epoch=0))
    keep = int(seconds * 22050)
    batch["waveform"][:, keep:] = 0.0
    params0, state0 = us.init(cfg, torch.Generator().manual_seed(0))

    def host(tree):
        return {p: t.detach().cpu() for p, t in cp.leaves_with_path(tree)}

    def run(dev, steps):
        params = cp.set_trainable(cp.map_tensors(
            params0, lambda t: t.to(dev).clone()), frozen=())
        state = cp.map_tensors(state0, lambda t: t.to(dev).clone())
        opt = build_optimizer(tcfg.optimizer, params)
        train_step, eval_step = tc.make_steps(cfg, mel_cfg, tcfg, opt)
        b = batch_to_device(batch, dev)
        before = _build.STATS["log_mel"].launches
        losses, first = [], None
        for _ in range(steps):
            state, m = train_step(params, state, b)
            losses.append(m["loss"].item())
            if first is None:
                first = ({p: t.grad.cpu()
                          for p, t in cp.leaves_with_path(params)},
                         host(params), host(state))
        ev = {k: v.item() for k, v in eval_step(params, state, b).items()}
        assert (_build.STATS["log_mel"].launches - before
                == (steps + 1 if dev.type == "cuda" else 0))
        return losses, ev, first

    gl, ge, (gg, gp, gs) = run(cuda, 3)
    cl, ce, _ = run(torch.device("cpu"), 3)
    np.testing.assert_allclose(gl, cl, rtol=1e-4)
    np.testing.assert_allclose(ge["loss_sum"], ce["loss_sum"], rtol=1e-4)
    assert ge["count"] == ce["count"] == 8

    features = mel.log_mel(batch_to_device(batch, cuda)["waveform"],
                           mel_cfg).cpu()
    monkeypatch.setattr(tc, "log_mel", lambda wav, c: features)
    _, _, (wg, wp, ws) = run(torch.device("cpu"), 1)
    floor = 1e-6 * max(w.abs().max().item() for w in wg.values())
    for path, w in wg.items():
        moved = (gp[path] - wp[path]).abs()
        assert moved.max() <= 2 * lr, path
        if w.abs().max() <= floor:
            assert gg[path].abs().max() <= floor, path
            continue
        tol = 1e-4 * max(1.0, w.abs().max().item())
        assert (gg[path] - w).abs().max() <= tol, path
        assert moved[w.abs() > tol].max() <= 1e-6, path
    for path, w in ws.items():
        assert ((gs[path] - w).abs() <= 1e-6 + 1e-5 * w.abs()).all(), path


def test_k3_rejects_what_it_cannot_take(cuda):
    wav = torch.zeros((1, 4000), device=cuda)
    for bad in (MelConfig.whisper().replace(n_fft=401),
                MelConfig.whisper().replace(power=3.0),
                MelConfig.whisper().replace(pad_mode="constant")):
        with pytest.raises(ValueError):
            mel.log_mel(wav, bad)


# --------------------------------------------------------------------------
# the model on the card
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["greedy", "timestamps_int4"])
def test_generate_on_cuda_matches_cpu(cuda, mode):
    cfg = EmotionWhisperConfig(whisper=WhisperConfig.test(),
                               num_emotion_classes=4)
    w = cfg.whisper
    params = cp.init(cfg, torch.Generator().manual_seed(0))["whisper"]
    mel_in = torch.randn((3, 2 * w.max_source_positions, w.n_mels),
                         generator=torch.Generator().manual_seed(1))
    dcfg = DecodeConfig(max_new_tokens=20, repetition_penalty=1.15,
                        no_repeat_ngram_size=3)
    if mode == "timestamps_int4":
        dcfg = dcfg.replace(return_timestamps=True, kv_quant="int4")
    outs = []
    for dev in (cuda, torch.device("cpu")):
        p = cp.to_device(params, dev)
        enc = wm.encode(p, w, mel_in.to(dev))
        outs.append(dec.generate(p, w, dcfg, enc))
    gpu, cpu = outs
    assert torch.equal(gpu["tokens"].cpu(), cpu["tokens"])
    assert torch.equal(gpu["lengths"].cpu(), cpu["lengths"])
    assert (gpu["hiddens"].cpu() - cpu["hiddens"]).abs().max() <= 1e-4


# --------------------------------------------------------------------------
# the decoder step captured in a CUDA graph
# --------------------------------------------------------------------------

# the ids an "eos" case lets the decode choose: two words and EOS; the
# 3-gram ban uses up their trigrams within a few steps and leaves EOS
_EOS_WORDS = (300, 301)


@pytest.fixture(scope="module")
def tiny_whisper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU)")
    w = WhisperConfig.tiny()
    cfg = EmotionWhisperConfig(whisper=w, num_emotion_classes=4)
    params = cp.to_device(
        cp.init(cfg, torch.Generator().manual_seed(0))["whisper"], "cuda")
    mel_in = torch.randn((4, 2 * w.max_source_positions, w.n_mels),
                         generator=torch.Generator().manual_seed(1))
    # rows of distinct levels, so that the rows' decodes differ
    mel_in = (mel_in * torch.tensor([0.1, 1.0, 3.0, 1.0])[:, None, None]
              + torch.tensor([0.0, 1.0, -1.0, 2.0])[:, None, None])
    return w, params, mel_in


def _graph_case(case):
    """(DecodeConfig, suppress_ids) of a captured-decode case."""
    dcfg = DecodeConfig(max_new_tokens=24, repetition_penalty=1.15,
                        no_repeat_ngram_size=3)
    suppress = ()
    if case == "eos":
        keep = set(_EOS_WORDS) | {WhisperConfig.tiny().eos_token_id}
        suppress = tuple(i for i in range(WhisperConfig.tiny().vocab_size)
                         if i not in keep)
    elif case == "int8":
        dcfg = dcfg.replace(kv_quant="int8", self_kv_min=0)
    elif case == "xla":
        dcfg = dcfg.replace(step_attn="xla")
    elif case == "sampled":
        dcfg = dcfg.replace(temperature=0.7)
    return dcfg, suppress


def _traced_generate(params, w, dcfg, enc, suppress, seed):
    from audio_transformers_tpu_torch.core import tracing
    tracing.disable()
    tracing.drain()
    before = {k: s.launches for k, s in _build.STATS.items()}
    tracing.enable()
    try:
        out = dec.generate(params, w, dcfg, enc, suppress_ids=suppress,
                           generator=_gen(seed))
    finally:
        tracing.disable()
    torch.cuda.synchronize()
    launched = {k: s.launches - before[k] for k, s in _build.STATS.items()}
    return out, tracing.drain(), launched


@pytest.mark.parametrize("case", ["bf16", "eos", "int8", "xla", "sampled"])
def test_captured_decode_matches_the_eager_loop(cuda, tiny_whisper, case,
                                                monkeypatch):
    w, params, mel_in = tiny_whisper
    dcfg, suppress = _graph_case(case)
    p = cp.map_tensors(params, lambda t: t.to(torch.bfloat16))
    enc = wm.encode(p, w, mel_in.to(cuda, torch.bfloat16))
    graph, rec, launched = _traced_generate(p, w, dcfg, enc, suppress, 5)
    monkeypatch.setattr(dec, "_capture_allowed", lambda enc, group: False)
    eager, rec_eager, _ = _traced_generate(p, w, dcfg, enc, suppress, 5)

    assert torch.equal(graph["tokens"], eager["tokens"])
    assert torch.equal(graph["lengths"], eager["lengths"])
    err = (graph["hiddens"].float() - eager["hiddens"].float()).abs().max()
    assert err <= 1e-5 * eager["hiddens"].float().abs().max()

    steps = rec.counter("decode.steps")
    assert rec.counter("decode.graph_captures") == 1
    assert rec.counter("decode.graph_replays") == steps - 1 > 0
    assert len(rec.of("decode.capture")) == 1
    assert rec_eager.counter("decode.steps") == steps
    assert rec_eager.counter("decode.graph_captures") == 0
    assert rec_eager.counter("decode.graph_replays") == 0
    k1 = 0 if case == "xla" else w.decoder_layers * steps
    assert launched["decode_cross_attention"] == k1
    length = graph["tokens"].shape[1]
    if case == "eos":
        # rows end early and the loop leaves early: positions never fed
        # keep zero hidden states
        assert (graph["lengths"] < length).all()
        assert graph["lengths"].min() < graph["lengths"].max()
        assert steps < length
        assert graph["hiddens"][:, steps:].abs().max() == 0
        assert graph["hiddens"][:, steps - 1].abs().max() > 0


def test_captured_decode_reads_weights_updated_in_place(cuda, tiny_whisper,
                                                        monkeypatch):
    """Nothing of a capture outlives its call: weights changed in place
    between two calls (evaluation during training) are what the second
    call's graph reads."""
    w, params, mel_in = tiny_whisper
    p = cp.map_tensors(params, lambda t: t.clone())
    enc = wm.encode(p, w, mel_in.to(cuda))
    dcfg, _ = _graph_case("bf16")
    first = dec.generate(p, w, dcfg, enc)
    with torch.no_grad():
        for bp in p["decoder"]["blocks"]:
            bp["fc2"]["w"].mul_(1.5)
    graph = dec.generate(p, w, dcfg, enc)
    monkeypatch.setattr(dec, "_capture_allowed", lambda enc, group: False)
    eager = dec.generate(p, w, dcfg, enc)
    assert not torch.equal(first["hiddens"], eager["hiddens"])
    assert torch.equal(graph["tokens"], eager["tokens"])
    err = (graph["hiddens"] - eager["hiddens"]).abs().max()
    assert err <= 1e-5 * eager["hiddens"].abs().max()


def test_captured_decodes_reuse_their_memory(cuda, tiny_whisper):
    """A capture takes the memory pool of a graph whose decode has ended,
    so repeated decodes hold no more memory than the first."""
    w, params, mel_in = tiny_whisper
    enc = wm.encode(params, w, mel_in.to(cuda))
    dcfg, _ = _graph_case("bf16")
    reserved = []
    for _ in range(4):
        dec.generate(params, w, dcfg, enc)
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved())
    assert reserved[1] == reserved[2] == reserved[3], reserved


def test_captured_decode_syncs_once_a_step(cuda, tiny_whisper):
    """Inside the loop the one host sync a step is the `finished` read
    (`decode.sync`): none in the replayed blocks or the token's work."""
    import warnings

    from audio_transformers_tpu_torch.core import tracing
    w, params, mel_in = tiny_whisper
    enc = wm.encode(params, w, mel_in.to(cuda))
    dcfg, _ = _graph_case("bf16")
    dec.generate(params, w, dcfg, enc)               # warm
    torch.cuda.synchronize()
    tracing.drain()
    at = []                  # the open spans at each sync, innermost last

    def note(message, *args, **kwargs):
        if "synchroniz" in str(message):
            at.append(tuple(s.name for s in tracing._stack()))
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        tracing.enable()
        try:
            dec.generate(params, w, dcfg, enc)
        finally:
            tracing.disable()
            torch.cuda.set_sync_debug_mode("default")
    rec = tracing.drain()
    in_loop = [names for names in at if "decode.step" in names]
    assert [names[-1] for names in in_loop] == ["decode.sync"] * len(in_loop)
    assert len(in_loop) == len(rec.of("decode.step")) > 0
    assert not [names for names in at if "decode.blocks" in names]


@pytest.mark.parametrize("streams", ["shared", "own"])
def test_captured_decodes_in_two_threads(cuda, tiny_whisper, monkeypatch,
                                         streams):
    """Two threads decoding at once (the threaded HTTP server without its
    micro-batcher), 9 decodes each in each of 3 rounds, on the one current
    stream or each on a new stream (54 in all, more than torch's pool
    holds, so that every stream of the pool comes round): every thread
    captures and replays its own step, a capture takes the pool of another
    thread's ended graph, and every tokens and hidden states are those of
    the eager loop."""
    import threading
    w, params, mel_in = tiny_whisper
    dcfg, _ = _graph_case("bf16")
    encs = [wm.encode(params, w, mel_in[i:i + 2].to(cuda)) for i in (0, 2)]
    monkeypatch.setattr(dec, "_capture_allowed", lambda enc, group: False)
    eager = [dec.generate(params, w, dcfg, enc) for enc in encs]
    monkeypatch.undo()
    torch.cuda.synchronize()
    wrong, errors = [], []

    def run(i, outs):
        try:
            for _ in range(9):
                stream = (torch.cuda.Stream() if streams == "own"
                          else torch.cuda.current_stream())
                with torch.cuda.stream(stream):
                    outs.append(dec.generate(params, w, dcfg, encs[i]))
        except Exception as e:      # reported below, in the test's thread
            errors.append(e)
    for r in range(3):
        outs = [[], []]
        threads = [threading.Thread(target=run, args=(i, outs[i]))
                   for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        torch.cuda.synchronize()
        for i, want in enumerate(eager):
            for n, got in enumerate(outs[i]):
                err = (got["hiddens"] - want["hiddens"]).abs().max()
                if (not torch.equal(got["tokens"], want["tokens"])
                        or err > 1e-5 * want["hiddens"].abs().max()):
                    wrong.append((r, i, n))
    assert not wrong, f"{len(wrong)} of 54 decodes wrong: {wrong}"


def test_captured_decodes_around_empty_cache(cuda, tiny_whisper):
    """A capture takes the pool of an ended decode's graph, which is kept
    alive for it: given the pool of a destroyed graph after
    `torch.cuda.empty_cache()`, torch's host allocator fails an internal
    assert (`use_count > 0`)."""
    w, params, mel_in = tiny_whisper
    enc = wm.encode(params, w, mel_in.to(cuda))
    dcfg, _ = _graph_case("bf16")
    outs = []
    for _ in range(3):
        outs.append(dec.generate(params, w, dcfg, enc))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    for got in outs[1:]:
        assert torch.equal(got["tokens"], outs[0]["tokens"])
        assert torch.equal(got["hiddens"], outs[0]["hiddens"])


@pytest.mark.parametrize("fault", ["raise", "sync"])
def test_a_capture_that_fails_leaves_later_decodes_whole(cuda, tiny_whisper,
                                                         monkeypatch, fault):
    """A capture that raises ("raise": an error in the step's code; "sync":
    a host sync, which invalidates the capture) fails its decode, and the
    decodes after it capture and replay as ever, one taking the pool that
    the failed capture had taken."""
    w, params, mel_in = tiny_whisper
    enc = wm.encode(params, w, mel_in.to(cuda))
    dcfg, _ = _graph_case("bf16")
    dec.generate(params, w, dcfg, enc)     # an ended graph, whose pool the
    torch.cuda.synchronize()               # failing capture takes
    body = wm._decoder_step

    def failing(*args, **kwargs):
        out = body(*args, **kwargs)
        if torch.cuda.is_current_stream_capturing():
            if fault == "sync":
                out.sum().item()
            raise RuntimeError("a planted fault in the capture")
        return out
    monkeypatch.setattr(wm, "_decoder_step", failing)
    with pytest.raises(RuntimeError):
        dec.generate(params, w, dcfg, enc)
    monkeypatch.undo()
    torch.cuda.synchronize()
    graph = [dec.generate(params, w, dcfg, enc) for _ in range(3)]
    monkeypatch.setattr(dec, "_capture_allowed", lambda enc, group: False)
    eager = dec.generate(params, w, dcfg, enc)
    for got in graph:
        assert torch.equal(got["tokens"], eager["tokens"])
        err = (got["hiddens"] - eager["hiddens"]).abs().max()
        assert err <= 1e-5 * eager["hiddens"].abs().max()


# --------------------------------------------------------------------------
# K4: flash attention
# --------------------------------------------------------------------------


def _k4_ok(got, want, dtype, floor=0.0):
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if dtype == torch.float32:
        return err <= 2e-5 * max(1.0, scale)
    scale = max(scale, floor)
    return err <= 2 * 2.0 ** (math.floor(math.log2(scale)) - 7)


def _cancel_floor(q, k, v, do):
    m = [x.float().abs().max().item() for x in (q, k, v, do)]
    return 2.0 ** -17 * q.shape[-1] * m[3] * m[2] * max(m[0], m[1])


@pytest.mark.parametrize("bh,tq,tk,d,causal", [
    (3, 100, 130, 32, False), (4, 70, 70, 64, True), (2, 65, 200, 128, False),
    (96, 31, 31, 64, True), (96, 31, 1500, 64, False),
    (12, 1500, 1500, 64, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_matches_plain(cuda, bh, tq, tk, d, causal, dtype):
    g = _gen(4)
    q = (torch.randn((bh, tq, d), generator=g, device=cuda)
         / math.sqrt(d)).to(dtype)
    k, v = (torch.randn((bh, tk, d), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    do = torch.randn((bh, tq, d), generator=g, device=cuda).to(dtype)
    before = {n: _build.STATS[n].launches for n in _build.STATS}
    out, lse = att.flash_attention_fwd(q, k, v, causal)
    p_out, p_lse = att.flash_attention_fwd_reference(q, k, v, causal)
    delta = (do.float() * p_out.float()).sum(-1)
    args = (q, k, v, do, p_lse, delta, causal)
    dq = att.flash_attention_bwd_dq(*args)
    dk, dv = att.flash_attention_bwd_dkv(*args)
    p_dq = att.flash_attention_bwd_dq_reference(*args)
    p_dk, p_dv = att.flash_attention_bwd_dkv_reference(*args)
    torch.cuda.synchronize()
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert _build.STATS[name].launches == before[name] + 1
    assert (lse - p_lse).abs().max().item() <= 1e-4
    for got, want in ((out, p_out), (dq, p_dq), (dk, p_dk), (dv, p_dv)):
        assert got.dtype == dtype and got.shape == want.shape
        assert _k4_ok(got, want, dtype)


def test_k4_autograd_on_cuda_matches_cpu(cuda):
    g = torch.Generator().manual_seed(5)
    q, k, v, do = (torch.randn((2, 3, 90, 64), generator=g)
                   for _ in range(4))
    grads = []
    for dev in (cuda, torch.device("cpu")):
        xs = [x.to(dev).requires_grad_() for x in (q, k, v)]
        out = att.flash_attention(*xs, causal=True)
        out.backward(do.to(dev))
        grads.append([out] + [x.grad for x in xs])
    for a, b in zip(*grads):
        assert (a.detach().cpu() - b.detach()).abs().max().item() <= 1e-5


def test_k4_rejects_bad_operands(cuda):
    x = torch.zeros((2, 8, 64), device=cuda)
    with pytest.raises(ValueError):                     # d > 128
        att.flash_attention_fwd(*(torch.zeros((2, 8, 160), device=cuda),)
                                * 3, False)
    with pytest.raises(TypeError):                      # float16
        att.flash_attention_fwd(x.half(), x.half(), x.half(), False)
    with pytest.raises(ValueError):                     # not contiguous
        xt = torch.zeros((2, 64, 8), device=cuda).transpose(1, 2)
        att.flash_attention_fwd(xt, x, x, False)


_SM90_T = (1, 31, 63, 64, 65, 129, 1500)
_SM90_PAIRS = ((1, 1), (1, 1500), (1500, 1), (31, 63), (64, 64), (65, 129),
               (129, 65), (1500, 1500))


def _sm90_cases():
    cases = [(tq, tk, 64) for tq in _SM90_T for tk in _SM90_T]
    cases += [(tq, tk, d) for d in (32, 128) for tq, tk in _SM90_PAIRS]
    # head dims off the 8-element grid take the kernels' element loads
    cases += [(65, 129, 20), (129, 65, 72), (31, 63, 100)]
    return cases


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk,d", _sm90_cases())
def test_k4_fwd_sm90_matches_plain(cuda, tq, tk, d, causal):
    # the bf16 forward runs the tensor-core kernel
    assert att.SOURCE[torch.bfloat16] == "flash_attention_sm90"
    g = _gen(tq * 5 + tk * 11 + d)
    bh = 3
    q = (torch.randn((bh, tq, d), generator=g, device=cuda)
         / math.sqrt(d)).bfloat16()
    k, v = (torch.randn((bh, tk, d), generator=g, device=cuda).bfloat16()
            for _ in range(2))
    before = _build.STATS["flash_attention_fwd"].launches
    out, lse = att.flash_attention_fwd(q, k, v, causal)
    # a second launch gives the same bits: every output tile has one owner
    out2, lse2 = att.flash_attention_fwd(q, k, v, causal)
    p_out, p_lse = att.flash_attention_fwd_reference(q, k, v, causal)
    torch.cuda.synchronize()
    assert _build.STATS["flash_attention_fwd"].launches == before + 2
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert out.dtype == torch.bfloat16 and out.shape == p_out.shape
    assert lse.dtype == torch.float32 and lse.shape == p_lse.shape
    assert (lse - p_lse).abs().max().item() <= 1e-4
    assert _k4_ok(out, p_out, torch.bfloat16)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk,d", _sm90_cases())
def test_k4_bwd_sm90_matches_plain(cuda, tq, tk, d, causal):
    # the bf16 backward runs the tensor-core kernels
    assert att.SOURCE[torch.bfloat16] == "flash_attention_sm90"
    g = _gen(tq * 7 + tk * 3 + d)
    bh = 3
    q = (torch.randn((bh, tq, d), generator=g, device=cuda)
         / math.sqrt(d)).bfloat16()
    k, v, do = (torch.randn((bh, n, d), generator=g, device=cuda).bfloat16()
                for n in (tk, tk, tq))
    p_out, p_lse = att.flash_attention_fwd_reference(q, k, v, causal)
    delta = (do.float() * p_out.float()).sum(-1)
    args = (q, k, v, do, p_lse, delta, causal)
    before = {n: _build.STATS[n].launches
              for n in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")}
    dq = att.flash_attention_bwd_dq(*args)
    dk, dv = att.flash_attention_bwd_dkv(*args)
    # a second launch gives the same bits: every output tile has one owner
    dq2 = att.flash_attention_bwd_dq(*args)
    dk2, dv2 = att.flash_attention_bwd_dkv(*args)
    p_dq = att.flash_attention_bwd_dq_reference(*args)
    p_dk, p_dv = att.flash_attention_bwd_dkv_reference(*args)
    torch.cuda.synchronize()
    for name, n in before.items():
        assert _build.STATS[name].launches == n + 2
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) \
        and torch.equal(dv, dv2)
    floor = _cancel_floor(q, k, v, do)
    for got, want, fl in ((dq, p_dq, floor), (dk, p_dk, floor),
                          (dv, p_dv, 0.0)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert _k4_ok(got, want, torch.bfloat16, fl)


@pytest.mark.parametrize("symbol", ["flash_attention_fwd",
                                    "flash_attention_bwd_dq",
                                    "flash_attention_bwd_dkv"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_sources_take_one_dtype_each(cuda, dtype, symbol):
    # float32's kernels are the FMA ones (its parity route), bf16's the
    # tensor-core ones; each source refuses the other dtype at launch
    other = {"flash_attention": "flash_attention_sm90",
             "flash_attention_sm90": "flash_attention"}
    x = torch.zeros((2, 8, 64), device=cuda, dtype=dtype)
    lse = torch.zeros((2, 8), device=cuda)
    bwd_in = (x, x, x, x, lse, lse)
    ins, outs, args = {
        "flash_attention_fwd": ((x, x, x), (x, lse), att._FWD_ARGS),
        "flash_attention_bwd_dq": (bwd_in, (x,), att._DQ_ARGS),
        "flash_attention_bwd_dkv": (bwd_in, (x, x), att._DKV_ARGS)}[symbol]
    fn = _build.function(other[att.SOURCE[dtype]], symbol, args)
    rc = fn(*(_build.ptr(t) for t in ins + outs), *att._dims(x, x, False))
    assert rc != 0


# --------------------------------------------------------------------------
# a train step at whisper-tiny width
# --------------------------------------------------------------------------


def test_full_width_train_step_launches_the_kernels(cuda):
    import numpy as np

    from audio_transformers_tpu_torch.core.config import (OptimizerConfig,
                                                          TrainConfig)
    from audio_transformers_tpu_torch.train import whisper_emotion as tw
    from audio_transformers_tpu_torch.train.optim import build_optimizer

    cfg = EmotionWhisperConfig(num_emotion_classes=9)
    w = cfg.whisper
    tcfg = TrainConfig(batch_size=2, compute_dtype="bfloat16",
                       optimizer=OptimizerConfig(learning_rate=1e-4))
    params = cp.set_trainable(cp.to_device(
        cp.init(cfg, torch.Generator().manual_seed(0)), cuda))
    opt = build_optimizer(tcfg.optimizer, params)
    step, _ = tw.make_steps(cfg, MelConfig.whisper(), tcfg, opt, cuda)
    rng = np.random.default_rng(0)
    labels = rng.integers(10, w.vocab_size, (2, 32)).astype(np.int32)
    labels[:, 0] = w.decoder_start_token_id
    batch = {"waveform": (0.1 * rng.standard_normal((2, 480000))
                          ).astype(np.float32),
             "labels": labels, "emotion_labels": np.array([1, 5], np.int32),
             "valid": np.ones(2, bool)}
    _build.reset_stats()
    losses = [step(params, tw.batch_to_device(batch, cuda))["loss"].item()
              for _ in range(3)]
    torch.cuda.synchronize()
    assert all(math.isfinite(x) for x in losses)
    assert losses[-1] < losses[0]
    for name in ("log_mel", "flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert _build.STATS[name].launches > 0
    assert all(s.plain_cuda_calls == 0 for s in _build.STATS.values())
    assert params["whisper"]["encoder"]["pos"].grad is None


# --------------------------------------------------------------------------
# K5: the beam reorder
# --------------------------------------------------------------------------


def _k5_bufs(cuda, rows, g):
    """The whisper-tiny beam step's buffers at L=66 (bf16 and int8 K/V, f32
    scales, the int8 seen mask, int64 tokens), plus 37-byte bool rows and
    an odd f32 row that take the kernel's byte path."""
    kv = torch.randn((rows, 6, 64, 66), generator=g, device=cuda)
    return [kv.bfloat16(), kv.mul(40).to(torch.int8),
            torch.rand((rows, 6, 66), generator=g, device=cuda),
            (torch.rand((rows, 52224), generator=g, device=cuda) < 0.01
             ).to(torch.int8),
            torch.randint(0, 51865, (rows, 66), generator=g, device=cuda),
            torch.rand((rows, 37), generator=g, device=cuda) < 0.5,
            torch.randn((rows, 3, 5), generator=g, device=cuda)]


@pytest.mark.parametrize("rows", [64, 512])
def test_k5_matches_plain(cuda, rows):
    g = _gen(6)
    bufs = _k5_bufs(cuda, rows, g)
    perm = torch.randint(0, rows // 2, (rows,), generator=g, device=cuda)
    before = _build.STATS["permute_rows"].launches
    got = pm.permute_rows(bufs, perm)
    assert _build.STATS["permute_rows"].launches == before + 1
    want = pm.permute_rows_reference(bufs, perm)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_k5_into_outputs_and_misaligned_views(cuda):
    # a 16-byte-misaligned source and destination (offset by 3 bytes) take
    # the byte head/body/tail split; odd offsets that differ take bytes
    g = _gen(7)
    raw = torch.randint(-128, 127, (64 * 1000 + 3,), generator=g,
                        device=cuda, dtype=torch.int16).to(torch.int8)
    src = raw[3:3 + 64 * 1000].view(64, 1000)
    dst_raw = torch.zeros(64 * 1000 + 16, dtype=torch.int8, device=cuda)
    for off in (3, 5):
        dst = dst_raw[off:off + 64 * 1000].view(64, 1000)
        perm = torch.randint(0, 64, (64,), generator=g, device=cuda)
        pm.permute_rows([src], perm, out=[dst])
        torch.cuda.synchronize()
        assert torch.equal(dst, src[perm])


def test_k5_splits_long_lists(cuda):
    g = _gen(8)
    bufs = [torch.randn((16, 4), generator=g, device=cuda)
            for _ in range(pm.MAX_ENTRIES + 3)]
    perm = torch.randint(0, 16, (16,), generator=g, device=cuda)
    before = _build.STATS["permute_rows"].launches
    got = pm.permute_rows(bufs, perm)
    assert _build.STATS["permute_rows"].launches == before + 2
    for a, b in zip(got, bufs):
        assert torch.equal(a, b[perm])


def test_k5_rejects_bad_operands(cuda):
    x = torch.zeros((8, 4), device=cuda)
    perm = torch.arange(8, device=cuda)
    with pytest.raises(ValueError, match="overlaps"):
        pm.permute_rows([x], perm, out=[x])
    with pytest.raises(ValueError):
        pm.permute_rows([x.cpu()], perm)


@pytest.mark.parametrize("kv_quant", ["none", "int8", "int4"])
def test_beam_on_cuda_matches_cpu(cuda, kv_quant):
    from audio_transformers_tpu_torch.models.whisper import beam
    cfg = EmotionWhisperConfig(whisper=WhisperConfig.test(),
                               num_emotion_classes=4)
    w = cfg.whisper
    params = cp.init(cfg, torch.Generator().manual_seed(0))["whisper"]
    mel_in = torch.randn((3, 2 * w.max_source_positions, w.n_mels),
                         generator=torch.Generator().manual_seed(1))
    # int4 also with the timestamp rule, as segment evaluation decodes
    dcfg = DecodeConfig(max_new_tokens=20, num_beams=3, kv_quant=kv_quant,
                        repetition_penalty=1.15, no_repeat_ngram_size=3,
                        return_timestamps=kv_quant == "int4")
    outs = []
    for dev in (cuda, torch.device("cpu")):
        p = cp.to_device(params, dev)
        enc = wm.encode(p, w, mel_in.to(dev))
        before = _build.STATS["permute_rows"].launches
        outs.append(beam.generate_beam(p, w, dcfg, enc))
        launched = _build.STATS["permute_rows"].launches - before
        assert (launched > 0) == (dev.type == "cuda")
    gpu, cpu = outs
    for k in ("tokens", "lengths", "beam_tokens", "beam_lengths"):
        assert torch.equal(gpu[k].cpu(), cpu[k]), k
    assert (gpu["beam_scores"].cpu() - cpu["beam_scores"]).abs().max() <= 1e-4
    assert (gpu["hiddens"].cpu() - cpu["hiddens"]).abs().max() <= 1e-4
