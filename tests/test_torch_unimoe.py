"""Uni-MoE-2.0-Omni's speech understanding on the port (`models/unimoe`,
`infer/omni.py`, K6's plain route) against the plain float32 reference
(`tests/reference_unimoe.py`), on seeded weights at a toy size: hidden 64,
4/2 heads of 16, M-RoPE sections (2, 3, 3), 2 layers, 4 routed experts
and a null one, 2 shared experts, vocabulary 300, a 2-layer encoder.

Tolerances: both sides compute in float32 on the CPU and differ only in
the order of their sums (packed vs row-wise products, the K/V cache, the
head's padded transpose), so 1e-4 relative to the largest magnitude
holds everything; routing is compared exactly where no token's router
probabilities lie within 1e-4 of a decision.
"""

import math

import numpy as np
import pytest
import torch

from audio_transformers_tpu_torch.core import tracing
from audio_transformers_tpu_torch.core.config import OmniConfig
from audio_transformers_tpu_torch.infer.omni import (OmniPipeline,
                                                     fill_windows, seeded)
from audio_transformers_tpu_torch.models.unimoe import model as um
from audio_transformers_tpu_torch.ops.decode_logits import fused_greedy_step
from audio_transformers_tpu_torch.ops import expert_gemm as eg
from audio_transformers_tpu_torch.ops.mel import log_mel
from tests import reference_unimoe as ref

TOL = 1e-4
# a router scale at which 1-slot, 2-slot and null picks all occur
ROUTER_SCALE = 8.0


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in flat(sub, f"{prefix}{key}.").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in flat(sub, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


def dims(cfg: OmniConfig) -> ref.Dims:
    c, w = cfg.llm, cfg.whisper
    return ref.Dims(hidden=c.hidden_size, layers=c.num_layers,
                    heads=c.num_heads, kv_heads=c.num_kv_heads,
                    rope_theta=c.rope_theta, mrope_section=c.mrope_section,
                    eps=c.rms_norm_eps, experts=c.num_experts,
                    null_experts=c.null_experts, top_p=c.top_p,
                    top_k=c.top_k, vocab=c.vocab_size, enc_d=w.d_model,
                    enc_layers=w.encoder_layers, enc_heads=w.num_heads,
                    audio_tokens=cfg.audio_tokens)


@pytest.fixture(scope="module")
def toy():
    cfg = OmniConfig.test()
    params = seeded(cfg, 3, ROUTER_SCALE)
    pipe = OmniPipeline(params, cfg, device="cpu")
    model = ref.Omni(dims(cfg), ref.from_dict(flat(params)))
    rng = np.random.default_rng(7)
    audio = [0.1 * rng.standard_normal(int(pipe.window * f)).astype(
        np.float32) for f in (0.6, 2.3, 1.4)]
    prompts = [rng.integers(0, 300, n).tolist() for n in (12, 17, 9)]
    return cfg, params, pipe, model, audio, prompts


def _close(a, b, tol=TOL):
    a, b = a.float(), b.float()
    scale = max(float(b.abs().max()), 1.0)
    assert float((a - b).abs().max()) <= tol * scale


def _port_sets(slots, cfg):
    return [frozenset(s for s in row if s < cfg.llm.slots)
            for row in slots.tolist()]


def test_moe_layer_matches_reference(toy):
    cfg, params, _, model, _, _ = toy
    torch.manual_seed(0)
    u = torch.randn(400, cfg.llm.hidden_size)
    p = params["llm"]["layers"][0]["moe"]
    slots, _ = um.route(p["router"]["w"], u, cfg.llm)
    sizes = (slots < cfg.llm.slots).sum(1)
    null = cfg.llm.num_experts
    assert (sizes == 1).any() and (sizes == 2).any()
    assert (slots == null).any()
    out, slots_out = um.moe(p, u, cfg.llm)
    assert torch.equal(slots_out, slots)
    want, kept = model.moe("llm.layers.0.moe", u)
    assert _port_sets(slots, cfg) == ref.slot_sets(kept)
    _close(out, want)


def test_moe_without_shared_experts_differs(toy):
    """The shared experts are a large share of the output: leaving them out
    is no rounding."""
    cfg, params, _, model, _, _ = toy
    u = torch.randn(64, cfg.llm.hidden_size)
    full, _ = model.moe("llm.layers.1.moe", u)
    routed, _ = model.moe("llm.layers.1.moe", u, shared=False)
    assert float((full - routed).norm() / full.norm()) > 0.1


def test_mrope_unequal_rows(toy):
    cfg, _, _, model, _, _ = toy
    n, hd = 23, cfg.llm.head_dim
    g = torch.Generator().manual_seed(1)
    pos = torch.stack([torch.randint(0, 50, (n,), generator=g),
                       torch.randint(0, 9, (n,), generator=g),
                       torch.randint(0, 700, (n,), generator=g)])
    x = torch.randn((n, 3, hd), generator=g)
    cos, sin = um.mrope(pos, cfg.llm)
    rcos, rsin = model.rope(pos)
    _close(cos, rcos)
    _close(um.rotate(x, cos, sin), model.rotate(x, rcos, rsin))
    # the three rows matter: the same positions on one row differ
    same, _ = um.mrope(torch.stack([pos[0]] * 3), cfg.llm)
    assert float((same - cos).abs().max()) > 0.1


def _windows(pipe, audio):
    counts = pipe.window_counts(audio)
    out = np.empty((sum(counts), pipe.window), np.float32)
    fill_windows(audio, counts, 0, out)
    return out, counts


def test_audio_tokens_match_reference(toy):
    _, params, pipe, model, audio, _ = toy
    windows, counts = _windows(pipe, audio)
    assert sum(counts) == 1 + 3 + 2
    mel = log_mel(torch.from_numpy(windows), pipe.mel_cfg)
    want = model.audio_tokens(model.encode(mel))
    port = pipe.audio_embeddings(audio)
    _close(port, want)
    # buckets of two windows cut the rows elsewhere: the same tokens
    small = OmniPipeline(params, pipe.cfg, device="cpu", encoder_bucket=2)
    _close(small.audio_embeddings(audio), want)
    # each window is its recording's slice, the last zero-padded
    np.testing.assert_array_equal(windows[1].reshape(-1)[:len(audio[1])]
                                  [:pipe.window], audio[1][:pipe.window])
    assert not windows[0][len(audio[0]):].any()


def _rows(pipe, model, audio, prompts, port_audio):
    """Each row's reference embeddings."""
    a = pipe.cfg.audio_tokens
    counts = pipe.window_counts(audio)
    out, w = [], 0
    for prompt, n in zip(prompts, counts):
        out.append(model.embed(prompt, port_audio[w:w + n].reshape(
            n * a, -1), pipe.audio_after))
        w += n
    return out


def test_prefill_and_cached_decode_match_full_forward(toy):
    """Prefill, then 8 cached steps, against the reference's full forward
    over the same tokens: logits at the prefill's last position and at
    every step, and every layer's routing of every token."""
    cfg, params, pipe, model, audio, prompts = toy
    llm, steps = pipe.params["llm"], 8
    port_audio = pipe.audio_embeddings(audio)
    x, pack = pipe.embed(prompts, pipe.window_counts(audio), port_audio)
    cache = um.init_cache(cfg.llm, len(prompts), pack.width + steps,
                          torch.float32, "cpu")
    routes = []
    orig = um.route

    def spy(*a, **k):
        out = orig(*a, **k)
        routes.append(out[0])
        return out
    um.route = spy
    try:
        hidden = um.prefill(llm, cfg.llm, x, pack, cache)
        logits, toks = [um.logits(hidden, pipe.table, cfg.llm.vocab_size)], []
        pos = torch.tensor(pack.lengths)
        for s in range(steps):
            tok = fused_greedy_step(hidden, pipe.table, pipe.add)
            assert torch.equal(tok.long(), logits[-1].argmax(-1))
            toks.append(tok)
            hidden = um.decode_step(llm, cfg.llm, tok, pos + s, cache)
            logits.append(um.logits(hidden, pipe.table, cfg.llm.vocab_size))
    finally:
        um.route = orig
    layers = cfg.llm.num_layers
    starts = np.cumsum([0] + pack.lengths)
    for b, row in enumerate(_rows(pipe, model, audio, prompts, port_audio)):
        fed = torch.stack([t[b] for t in toks]).long()
        full = torch.cat([row, params["llm"]["embed"]["table"][fed]])
        want, kept = model.forward(full)
        n = pack.lengths[b]
        got = torch.stack([lg[b] for lg in logits])
        _close(got, want[n - 1:n + steps])
        for i in range(layers):
            port = _port_sets(routes[i][starts[b]:starts[b + 1]], cfg)
            port += [_port_sets(routes[(s + 1) * layers + i][b:b + 1], cfg)[0]
                     for s in range(steps)]
            assert port == ref.slot_sets(kept[i]), (b, i)


def test_ragged_batch_equals_each_row_alone(toy):
    _, _, pipe, _, audio, prompts = toy
    together = pipe.generate(audio, prompts, 6)
    for b in range(len(prompts)):
        alone = pipe.generate(audio[b:b + 1], prompts[b:b + 1], 6)
        np.testing.assert_array_equal(alone[0], together[b])


@pytest.mark.parametrize("counts", [(5, 0, 7, 3), (0, 0, 0, 9), (4, 4, 0, 0)])
def test_k6_plain_route_matches_a_per_expert_loop(counts):
    g = torch.Generator().manual_seed(sum(counts))
    e, d, f, tail = 4, 24, 40, 5
    m = sum(counts) + tail                     # rows past offsets[E]
    x = torch.randn((m, d), generator=g)
    wg, wu = torch.randn((e, f, d), generator=g), torch.randn((e, f, d),
                                                               generator=g)
    wd = torch.randn((e, d, f), generator=g)
    offsets = torch.tensor(np.cumsum((0,) + counts), dtype=torch.int32)
    got = eg.expert_swiglu(x, offsets, wg, wu, wd)
    want = torch.zeros_like(x)
    for k in range(e):
        lo, hi = int(offsets[k]), int(offsets[k + 1])
        for r in range(lo, hi):
            h = torch.nn.functional.silu(wg[k] @ x[r]) * (wu[k] @ x[r])
            want[r] = wd[k] @ h
    _close(got, want)
    assert torch.equal(got[sum(counts):], torch.zeros(tail, d))


def test_dispatch_sorts_slots_by_expert():
    slots = torch.tensor([[2, 5], [4, 5], [0, 2], [3, 1], [2, 4]])
    order, offsets = um.dispatch(slots, 4)
    assert offsets.tolist() == [0, 1, 2, 5, 6]
    flat = slots.reshape(-1)[order]
    assert flat.tolist() == [0, 1, 2, 2, 2, 3, 4, 4, 5, 5]


def test_counters_equal_the_picks(toy):
    cfg, _, pipe, _, audio, prompts = toy
    picks = []
    orig = um.route

    def spy(*a, **k):
        out = orig(*a, **k)
        picks.append(out[0])
        return out
    um.route = spy
    tracing.disable()
    tracing.drain()
    tracing.enable()
    try:
        pipe.generate(audio, prompts, 5)
    finally:
        um.route = orig
        tracing.disable()
    rec = tracing.drain()
    slots = torch.cat(picks)
    e = cfg.llm.num_experts
    for i in range(e):
        assert rec.counter(f"moe.slots.expert{i}") == int((slots == i).sum())
    assert rec.counter("moe.slots.null") == int((slots == e).sum())
    one = int((slots[:, 1] == cfg.llm.slots).sum())
    assert rec.counter("moe.tokens.one_slot") == one > 0
    assert rec.counter("moe.tokens") == slots.shape[0]
    assert rec.counter("moe.experts.active") == sum(
        int((p == i).any()) for p in picks for i in range(e))
    assert len(rec.of("moe")) == len(picks) == cfg.llm.num_layers * 5
    assert len(rec.of("omni.decode.step")) == 4
    assert len(rec.of("omni.prefill")) == 1


def test_generate_surface(toy):
    _, _, pipe, _, audio, prompts = toy
    with pytest.raises(ValueError):
        pipe.generate(audio, prompts[:2], 3)
    r = pipe.analyze(audio[0], 16000, prompts[0], max_new_tokens=3)
    assert len(r["tokens"]) == 3
    assert math.isclose(r["audio_s"], len(audio[0]) / 16000)


def test_cli_infer_picks_the_omni_pipeline(capsys, monkeypatch):
    from audio_transformers_tpu_torch.cli import infer as cli_infer
    from audio_transformers_tpu_torch.core import config
    # the CLI builds the published size; the toy size keeps this cheap
    toy = OmniConfig.test()
    monkeypatch.setattr(config, "OmniConfig", lambda: toy)
    r = cli_infer.main(["--model_type", "grin_qwen2_vl", "--device", "cpu",
                        "--max_new_tokens", "3", "--prompt_ids", "5,6,7,8,9"])
    assert len(r["tokens"]) == 3 and r["audio_s"] == 12.0
    assert "ids" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli_infer.main(["--model_type", "grin_qwen2_vl", "--device", "cpu",
                        "--model_path", "/nonexistent"])
