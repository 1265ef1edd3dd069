"""`decode_graph_share` against synthetic records: the replayed share of
the window's decoder steps, and None where the program counts no replay
or nothing was recorded."""

import os
from types import SimpleNamespace

import pytest

from audio_transformers_tpu_torch.core import tracing
from benchmark.harness import program_spans, registry

T0 = 1_000          # the window's start (ns)


def _metric():
    return registry.load_metric(os.path.join(registry.HERE, "metrics",
                                             "decode_graph_share.py"))


def _records(replays=True):
    """A call before the window (id 1) and one in it (id 10)."""
    spans = [tracing.Span("pipeline.analyze_windows", 1, None, 1, 0, 500, 900),
             tracing.Span("pipeline.analyze_windows", 10, None, 10, 0, 2000,
                          3000)]
    counts = {("decode.steps", 1): 4, ("decode.steps", 10): 98}
    if replays:
        counts.update({("decode.graph_replays", 1): 1,
                       ("decode.graph_replays", 10): 97,
                       ("decode.graph_captures", 10): 1})
    return tracing.Records(spans, counts, {})


def _ctx():
    return SimpleNamespace(cell=SimpleNamespace(t0_ns=T0), trace=None)


def test_reads_the_window_calls_replays_over_steps(monkeypatch):
    monkeypatch.setattr(program_spans, "records", _records)
    assert _metric().read(_ctx()) == pytest.approx(100.0 * 97 / 98)


@pytest.mark.parametrize("records", [lambda: None,
                                     lambda: _records(replays=False)])
def test_none_without_the_counter(monkeypatch, records):
    monkeypatch.setattr(program_spans, "records", records)
    assert _metric().read(_ctx()) is None


def test_declared_as_in_benchmark_json():
    entry = {m["name"]: m for m in registry.load_benchmark()["per_layer"]}[
        "decode_graph_share"]
    mod = _metric()
    assert (mod.NAME, mod.UNIT, mod.LAYER, mod.MOVES) == (
        entry["name"], entry["unit"], entry["layer"], entry["moves"])
    assert entry["workloads"] == ["large-v3-offline-b64"]
