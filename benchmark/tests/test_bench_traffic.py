"""The traffic generator: the same seed gives the same inputs, another
seed other values over the same sizes."""

import torch

from benchmark.harness import traffic, weights
from benchmark.harness.spec import from_dict
from benchmark.tests import helpers

DIMS = from_dict(helpers.TEST_CONFIG)
MIX = dict(helpers.TRAIN_MIX, batch=6)
BIG = 2 ** 31 + 12345


def test_batches_repeat_per_seed():
    a = traffic.train_batch(MIX, DIMS, BIG, 3, "cpu")
    b = traffic.train_batch(MIX, DIMS, BIG, 3, "cpu")
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_seeds_and_batches_differ_in_values_not_sizes():
    a = traffic.train_batch(MIX, DIMS, BIG, 0, "cpu")
    b = traffic.train_batch(MIX, DIMS, BIG + 1, 0, "cpu")
    c = traffic.train_batch(MIX, DIMS, BIG, 1, "cpu")
    assert not torch.equal(a["waveform"], b["waveform"])
    assert not torch.equal(a["waveform"], c["waveform"])
    for x, y in ((a, b), (a, c)):
        n = lambda t: sorted((t["waveform"] != 0).sum(1).tolist())
        lab = lambda t: sorted((t["labels"] != DIMS.pad_id).sum(1).tolist())
        assert abs(sum(n(x)) - sum(n(y))) <= len(n(x)) * 2
        assert lab(x) == lab(y)


def test_audio_lengths_cover_the_range_evenly():
    s = traffic.audio_lengths({"audio_s": [5.0, 30.0]}, BIG, 7, 64)
    assert sorted(s.tolist())[0] > 5.0 and sorted(s.tolist())[-1] < 30.0
    assert abs(float(s.sum()) - 64 * 17.5) < 1e-9


def test_labels_start_with_sot_and_pad_after_the_transcript():
    lab = traffic.labels(MIX, DIMS, BIG, 0, 6, "cpu")["labels"]
    assert (lab[:, 0] == DIMS.sot_id).all()
    for row in lab.tolist():
        n = sum(1 for t in row if t != DIMS.pad_id)
        assert all(t != DIMS.pad_id for t in row[:n])
        assert all(t == DIMS.pad_id for t in row[n:])
        assert MIX["transcript_ids"][0] <= n <= MIX["transcript_ids"][1]


def test_weights_repeat_per_seed_and_follow_the_leaf_list():
    a = weights.make(DIMS, BIG, "cpu")
    b = weights.make(DIMS, BIG, "cpu")
    assert list(a) == [n for n, *_ in weights.leaf_specs(DIMS)]
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = weights.make(DIMS, BIG + 1, "cpu")
    assert not torch.equal(a["whisper.decoder.embed.table"],
                           c["whisper.decoder.embed.table"])
    bound = 1 / DIMS.d_model ** 0.5
    w = a["whisper.encoder.blocks.0.fc1.w"]
    assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
    assert torch.equal(a["whisper.decoder.ln.scale"],
                       torch.ones(DIMS.d_model))
