"""Operation and byte counts against values worked by hand at the
whisper-tiny and whisper-large-v3 shapes."""

import os

import pytest

from benchmark.harness import counts, registry, spec, weights

CONFIGS = os.path.join(registry.HERE, "configs")


def dims(name):
    return spec.load(os.path.join(CONFIGS, name + ".json"))


def test_parameter_counts():
    # the published models (37,760,640 and 1,543,490,560) plus the head
    assert weights.n_params(dims("emotion-whisper-tiny")) == (
        37_760_640 + 384 * 10 + 10)
    assert weights.n_params(dims("emotion-whisper-large-v3")) == (
        1_543_490_560 + 1280 * 10 + 10)


def test_encoder_forward_flops_by_hand():
    d = dims("emotion-whisper-large-v3")
    conv = 2 * 3000 * 128 * 1280 * 3 + 2 * 1500 * 1280 * 1280 * 3
    block = (8 * 1500 * 1280 ** 2 + 4 * 1500 ** 2 * 1280
             + 4 * 1500 * 1280 * 5120)
    assert counts.encoder_flops(d) == conv + 32 * block
    assert counts.encoder_flops(d) == pytest.approx(2.2738e12, rel=1e-4)


def test_train_flops_per_clip():
    tiny = counts.train_flops_per_clip(dims("emotion-whisper-tiny"), 63)
    large = counts.train_flops_per_clip(dims("emotion-whisper-large-v3"), 63)
    assert tiny == pytest.approx(1.3386e11, rel=1e-3)
    assert large == pytest.approx(8.1150e12, rel=1e-3)


def test_attention_counts():
    # encoder self-attention, one call: 96 rows (batch 16 x 6 heads)
    f = counts.attention_flops(96, 1500, 1500, 64, False, False)
    assert f == 4 * 96 * 1500 * 1500 * 64          # 55.3 GFLOP, K4a's
    assert counts.attention_flops(96, 1500, 1500, 64, False, True) == 3 * f
    causal = counts.attention_flops(1, 4, 4, 1, True, False)
    assert causal == 2 * 2 * 10                    # 10 kept pairs


def test_kernel_bytes():
    d = dims("emotion-whisper-large-v3")
    # K1: bf16 K and V of 64 rows, 1280 wide, 1500 keys, plus q and out
    assert counts.cross_attention_bytes(d, 64) == (
        2 * 64 * 1280 * 1500 * 2 + 2 * 64 * 1280 * 2)
    # K2: the table padded to 52224 ids, the vector and two int8 masks
    assert counts.pad_vocab(51866) == 52224
    assert counts.greedy_step_bytes(d, 64) == (
        1280 * 52224 * 2 + 52224 * 4 + 2 * 64 * 52224 + 64 * 1280 * 2
        + 64 * 4)
    # K3: 64 windows of 480000 samples in, 3000 x 128 features out
    assert counts.mel_bytes(d, 64) == 64 * (480000 + 3000 * 128) * 4
    t = dims("emotion-whisper-tiny")
    assert counts.mel_bytes(t, 16) == 16 * (480000 + 3000 * 80) * 4


def test_bound_picks_the_larger():
    assert counts.bound(3.35e12, 1.0) == (1.0, "bytes")
    assert counts.bound(1.0, 989e12) == (1.0, "operations")


def test_analyze_flops_count_a_logit_per_picked_token():
    d = dims("emotion-whisper-large-v3")
    steps = 98
    no_logits = sum(counts.decode_step_flops(d, i, False)
                    for i in range(steps))
    total = counts.analyze_flops_per_window(d, steps, 2)
    extra = total - counts.encoder_flops(d) - counts.cross_kv_flops(d)
    assert extra - no_logits == 96 * 2 * 1280 * 51866
