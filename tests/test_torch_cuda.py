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
  K3 log_mel: 2e-4 abs on the final features (f32 sum order, log10)
  K4a/b/c flash attention: float32 max|err| <= 2e-5 * max(1, max|plain|)
     (sum order only); bfloat16 within two bf16 ulps at the tensor's
     largest magnitude (bf16 output rounding, p rounded against the
     kernel's running maximum)
  K5 permute_rows: bit for bit (a pure copy)
"""

import math

import pytest
import torch

from audio_transformers_tpu.core.config import (DecodeConfig,
                                                EmotionWhisperConfig,
                                                MelConfig, WhisperConfig)
from audio_transformers_tpu_torch.core import params as cp
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


@pytest.mark.parametrize("geom", [(3, 1900, 24), (16, 51865, 384)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["plain", "seen", "ban", "seen_ban", "ts"])
def test_k2_matches_plain(cuda, geom, dtype, mode):
    b, v, d = geom
    hidden, table_t, add, seen, ban = _k2_case(cuda, b, v, d, dtype, 1)
    kw = {}
    if "seen" in mode:
        kw.update(seen=seen, penalty=1.15)
    if "ban" in mode:
        kw["ban"] = ban
    tb = v - 300
    if mode == "ts":
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
    before = _build.STATS["fused_greedy_step"].launches
    got = dl.fused_greedy_step(hidden, table_t, add, **kw)
    assert _build.STATS["fused_greedy_step"].launches == before + 1
    want = dl.fused_greedy_step_reference(hidden, table_t, add, **kw)
    ok = _decidable(dl.processed_logits(hidden, table_t, add, **kw),
                    mode == "ts", tb)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (b,)
    assert ok.any()
    assert torch.equal(got[ok], want[ok])


def test_k2_ties_go_to_lowest_index(cuda):
    hidden = torch.ones((2, 4), device=cuda)
    table_t = torch.zeros((4, 1024), device=cuda)
    table_t[:, [7, 300, 900]] = 1.0
    add = torch.zeros((1, 1024), device=cuda)
    assert dl.fused_greedy_step(hidden, table_t, add).tolist() == [7, 7]


# --------------------------------------------------------------------------
# K3
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cfg,b,n", [
    (MelConfig.whisper(), 2, 480000),
    (MelConfig.whisper(), 3, 4000),
    (MelConfig.whisper(), 1, 300),
    (MelConfig.whisper().replace(log_mode="log_eps", drop_last_frame=False,
                                 power=1.0), 2, 16000),
])
def test_k3_matches_plain(cuda, cfg, b, n):
    wav = 0.3 * torch.randn((b, n), generator=_gen(3), device=cuda)
    before = _build.STATS["log_mel"].launches
    got = mel.log_mel(wav, cfg)
    assert _build.STATS["log_mel"].launches == before + 1
    want = mel.log_mel_torch(wav, cfg)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (b, cfg.num_frames(max(n, 401)),
                                       cfg.n_mels)
    assert (got - want).abs().max().item() <= K3_TOL


# --------------------------------------------------------------------------
# the model on the card
# --------------------------------------------------------------------------


def test_generate_on_cuda_matches_cpu(cuda):
    cfg = EmotionWhisperConfig(whisper=WhisperConfig.test(),
                               num_emotion_classes=4)
    w = cfg.whisper
    params = cp.init(cfg, torch.Generator().manual_seed(0))["whisper"]
    mel_in = torch.randn((3, 2 * w.max_source_positions, w.n_mels),
                         generator=torch.Generator().manual_seed(1))
    dcfg = DecodeConfig(max_new_tokens=20, repetition_penalty=1.15,
                        no_repeat_ngram_size=3)
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
# K4: flash attention
# --------------------------------------------------------------------------


def _k4_ok(got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if dtype == torch.float32:
        return err <= 2e-5 * max(1.0, scale)
    return err <= 2 * 2.0 ** (math.floor(math.log2(scale)) - 7)


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


# --------------------------------------------------------------------------
# a train step at whisper-tiny width
# --------------------------------------------------------------------------


def test_full_width_train_step_launches_the_kernels(cuda):
    import numpy as np

    from audio_transformers_tpu.core.config import (OptimizerConfig,
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


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_beam_on_cuda_matches_cpu(cuda, kv_quant):
    from audio_transformers_tpu_torch.models.whisper import beam
    cfg = EmotionWhisperConfig(whisper=WhisperConfig.test(),
                               num_emotion_classes=4)
    w = cfg.whisper
    params = cp.init(cfg, torch.Generator().manual_seed(0))["whisper"]
    mel_in = torch.randn((3, 2 * w.max_source_positions, w.n_mels),
                         generator=torch.Generator().manual_seed(1))
    dcfg = DecodeConfig(max_new_tokens=20, num_beams=3, kv_quant=kv_quant,
                        repetition_penalty=1.15, no_repeat_ngram_size=3)
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
