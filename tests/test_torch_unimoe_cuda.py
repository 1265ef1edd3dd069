"""Uni-MoE-2.0-Omni's kernels and path on the card: K6 (the grouped
SwiGLU expert GEMM, `ops/expert_gemm`) against its plain version at the
published widths and ragged expert loads, and a decode step that never
waits for the host. Every test needs a CUDA device and nvcc and skips
without them; the file imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_unimoe_cuda.py

K6's tolerance: both sides sum in float32 and round the intermediate to
bf16, the kernel in another order, so an intermediate can land one bf16
ulp apart; the outputs agree within 2e-2 of the largest magnitude (a few
bf16 ulps of the output) and are bit-equal from launch to launch.
"""

import numpy as np
import pytest
import torch

from audio_transformers_tpu_torch.core.config import (OmniConfig,
                                                      UniMoEConfig,
                                                      WhisperConfig)
from audio_transformers_tpu_torch.infer.omni import OmniPipeline, seeded
from audio_transformers_tpu_torch.models.unimoe import model as um
from audio_transformers_tpu_torch.ops.decode_logits import fused_greedy_step
from audio_transformers_tpu_torch.ops import _build
from audio_transformers_tpu_torch.ops import expert_gemm as eg

pytestmark = pytest.mark.cuda
K6_TOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _weights(g, e, d, f, device):
    def w(shape, fan_in):
        return ((torch.rand(shape, generator=g, device=device) * 2 - 1)
                / fan_in ** 0.5).to(torch.bfloat16)
    return w((e, f, d), d), w((e, f, d), d), w((e, d, f), f)


@pytest.mark.parametrize("counts", [(13, 16, 18, 17), (0, 700, 129, 1),
                                    (3000, 0, 5, 1250), (1, 0, 0, 0)])
def test_k6_matches_plain_at_published_widths(cuda, counts):
    e, d, f, tail = 4, 3584, 18944, 7
    g = torch.Generator(device=cuda).manual_seed(sum(counts))
    wg, wu, wd = _weights(g, e, d, f, cuda)
    m = sum(counts) + tail
    x = torch.randn((m, d), generator=g, device=cuda).to(torch.bfloat16)
    offsets = torch.tensor(np.cumsum((0,) + counts), dtype=torch.int32,
                           device=cuda)
    _build.reset_stats()
    y = eg.expert_swiglu(x, offsets, wg, wu, wd)
    y2 = eg.expert_swiglu(x, offsets, wg, wu, wd)
    torch.cuda.synchronize()
    assert _build.STATS["expert_gate_up"].launches == 2
    assert _build.STATS["expert_down"].launches == 2
    assert torch.equal(y, y2)
    want = eg.expert_swiglu_reference(x, offsets, wg, wu, wd)
    scale = float(want.float().abs().max())
    assert float((y.float() - want.float()).abs().max()) <= K6_TOL * scale
    assert torch.equal(y[sum(counts):], torch.zeros_like(y[sum(counts):]))


def _small():
    llm = UniMoEConfig(vocab_size=1024, hidden_size=256, num_layers=2,
                       num_heads=4, num_kv_heads=2, mrope_section=(8, 12, 12),
                       expert_size=256, shared_size=128)
    return OmniConfig(whisper=WhisperConfig.test(), llm=llm, audio_tokens=8)


def test_a_decode_step_never_syncs(cuda):
    cfg = _small()
    pipe = OmniPipeline(seeded(cfg, 1, router_scale=8.0), cfg, device=cuda)
    rng = np.random.default_rng(0)
    audio = [0.1 * rng.standard_normal(n).astype(np.float32)
             for n in (30000, 50000, 9000)]
    prompts = [list(range(1, 13)), list(range(40, 60)), list(range(9, 19))]
    x, pack = pipe.embed(prompts, pipe.window_counts(audio),
                         pipe.audio_embeddings(audio))
    llm = pipe.params["llm"]
    cache = um.init_cache(cfg.llm, 3, pack.width + 4, torch.bfloat16, cuda)
    hidden = um.prefill(llm, cfg.llm, x, pack, cache)
    tok = fused_greedy_step(hidden, pipe.table, pipe.add)
    pos = um.to_device(pack.lengths, cuda)
    router = um.Router(cuda)
    um.decode_step(llm, cfg.llm, tok, pos, cache, router)   # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for s in range(1, 3):
            hidden = um.decode_step(llm, cfg.llm, tok, pos + s, cache, router)
            tok = fused_greedy_step(hidden, pipe.table, pipe.add)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert router.counts()["moe.tokens"] == 3 * 3 * cfg.llm.num_layers


def test_the_card_agrees_with_the_cpu(cuda):
    """The same seeded model (bf16 on the card, float32 on the CPU):
    prefill logits within bf16's reach of each other."""
    cfg = _small()
    params = seeded(cfg, 2, router_scale=8.0)
    rng = np.random.default_rng(1)
    audio = [0.1 * rng.standard_normal(40000).astype(np.float32)]
    prompts = [list(range(3, 20))]
    outs = []
    for device in ("cpu", cuda):
        pipe = OmniPipeline(params, cfg, device=device)
        x, pack = pipe.embed(prompts, pipe.window_counts(audio),
                             pipe.audio_embeddings(audio))
        cache = um.init_cache(cfg.llm, 1, pack.width, pipe.compute_dtype,
                              device)
        hidden = um.prefill(pipe.params["llm"], cfg.llm, x, pack, cache)
        outs.append(um.logits(hidden.float(), pipe.table.float(),
                              cfg.llm.vocab_size).cpu())
    rel = float((outs[1] - outs[0]).norm() / outs[0].norm())
    assert rel < 0.05, rel


def test_captured_steps_equal_the_eager_loop(cuda):
    """The decode steps replayed from `StepGraphs` against the same
    pipeline's eager loop: ids, every routing decision and the hidden
    states at each pick; later calls, a shorter batch's too, replay the
    same graphs; K6's launches count every replay."""
    cfg = _small()
    params = seeded(cfg, 4, router_scale=8.0)
    rng = np.random.default_rng(3)
    audio = [0.1 * rng.standard_normal(n).astype(np.float32)
             for n in (25000, 61000, 12000, 41000)]
    prompts = [list(range(5, 5 + n)) for n in (12, 19, 9, 14)]
    steps, layers = 12, cfg.llm.num_layers
    pipe = OmniPipeline(params, cfg, device=cuda)
    _build.reset_stats()
    seen = um.Observer([0, 2])
    got = pipe.generate(audio, prompts, steps, observer=seen)
    assert _build.STATS["expert_gate_up"].launches >= layers * steps
    first = pipe._steps
    again = pipe.generate(audio, prompts, steps)
    assert pipe._steps is first
    np.testing.assert_array_equal(again, got)
    # a batch with shorter rows fits the captured cache: no new capture
    pipe.generate(audio, [p[:9] for p in prompts], steps)
    assert pipe._steps is first
    eager = OmniPipeline(params, cfg, device=cuda)
    eager._step_graphs = lambda rows, length: None
    want_seen = um.Observer([0, 2])
    want = eager.generate(audio, prompts, steps, observer=want_seen)
    np.testing.assert_array_equal(got, want)
    assert len(seen.routes) == len(want_seen.routes) == layers * steps
    for a, b in zip(seen.routes, want_seen.routes):
        assert torch.equal(a, b)
    for a, b in zip(seen.hidden, want_seen.hidden):
        scale = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= 1e-2 * scale
