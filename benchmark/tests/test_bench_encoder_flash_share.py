"""`encoder_flash_share` against synthetic records: the share of the
window's `encode` calls counted on the flash route, and None where the
program counts neither route or nothing was recorded."""

import os
from types import SimpleNamespace

import pytest

from audio_transformers_tpu_torch.core import tracing
from benchmark.harness import program_spans, registry

T0 = 1_000          # the window's start (ns)


def _metric():
    return registry.load_metric(os.path.join(registry.HERE, "metrics",
                                             "encoder_flash_share.py"))


def _records(flash=0, xla=0):
    """A call before the window (id 1, one xla encode that must not count)
    and one in it (id 10) with `flash` and `xla` encodes."""
    spans = [tracing.Span("pipeline.analyze_windows", 1, None, 1, 0, 500, 900),
             tracing.Span("pipeline.analyze_windows", 10, None, 10, 0, 2000,
                          3000)]
    counts = {("decode.steps", 10): 96, ("encode.attn.xla", 1): 1}
    if flash:
        counts[("encode.attn.flash", 10)] = flash
    if xla:
        counts[("encode.attn.xla", 10)] = xla
    return tracing.Records(spans, counts, {})


def _ctx():
    return SimpleNamespace(cell=SimpleNamespace(t0_ns=T0), trace=None)


@pytest.mark.parametrize("flash,xla,want", [(1, 0, 100.0), (3, 0, 100.0),
                                            (1, 1, 50.0), (0, 2, 0.0)])
def test_reads_the_window_calls_flash_share(monkeypatch, flash, xla, want):
    monkeypatch.setattr(program_spans, "records",
                        lambda: _records(flash, xla))
    assert _metric().read(_ctx()) == pytest.approx(want)


@pytest.mark.parametrize("records", [lambda: None, lambda: _records()])
def test_none_without_the_counters(monkeypatch, records):
    monkeypatch.setattr(program_spans, "records", records)
    assert _metric().read(_ctx()) is None


def test_declared_as_in_benchmark_json():
    entry = {m["name"]: m for m in registry.load_benchmark()["per_layer"]}[
        "encoder_flash_share"]
    mod = _metric()
    assert (mod.NAME, mod.UNIT, mod.LAYER, mod.MOVES) == (
        entry["name"], entry["unit"], entry["layer"], entry["moves"])
    assert entry["source"] == "program_counter"
    assert entry["workloads"] == ["large-v3-offline-b64"]
