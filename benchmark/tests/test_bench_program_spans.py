"""The five per-layer metrics that read the program's recorder
(`harness/program_spans.py`): each against synthetic records and a
synthetic device trace, for a known value and for None where there is
nothing to read; and `cell.run` on the CPU at the test size, which turns
the recorder on for a traced run alone."""

import os
from types import SimpleNamespace

import pytest

from audio_transformers_tpu_torch.core import tracing
from benchmark.harness import cell, program_spans, registry
from benchmark.harness.tracing import DeviceTrace
from benchmark.tests import helpers

T0 = 1_000          # the window's start (ns)


def _metric(name):
    return registry.load_metric(os.path.join(registry.HERE, "metrics",
                                             name + ".py"))


def _span(name, sid, parent, call, t0, t1):
    return tracing.Span(name, sid, parent, call, 0, t0, t1)


def _decode_records():
    """A call before the window (id 1) and one in it (id 10): two loop
    steps of 100 and 150 ns with device reads of 20 and 50 ns, 3 decoder
    steps counted."""
    spans = [_span("pipeline.analyze_windows", 1, None, 1, 500, 900),
             _span("decode.step", 2, 1, 1, 600, 800),
             _span("decode.sync", 3, 2, 1, 700, 800),
             _span("pipeline.analyze_windows", 10, None, 10, 2000, 3000),
             _span("decode.step", 11, 10, 10, 2100, 2200),
             _span("decode.sync", 12, 11, 10, 2180, 2200),
             _span("decode.step", 13, 10, 10, 2300, 2450),
             _span("decode.sync", 14, 13, 10, 2400, 2450)]
    return tracing.Records(spans, {("decode.steps", 1): 2,
                                   ("decode.steps", 10): 3}, {})


def _ctx(trace=None):
    return SimpleNamespace(cell=SimpleNamespace(t0_ns=T0), trace=trace)


def _trace(records, t0=0, t1=10_000):
    t = DeviceTrace()
    t.records, t.t0, t.t1 = records, t0, t1
    t.window_s = (t1 - t0) / 1e9
    return t


@pytest.mark.parametrize("name,ns", [("decode_issue_ms", (80 + 100) / 3),
                                     ("decode_sync_ms", (20 + 50) / 3)])
def test_decode_ms_reads_the_window_steps(monkeypatch, name, ns):
    monkeypatch.setattr(program_spans, "records", _decode_records)
    assert _metric(name).read(_ctx()) == pytest.approx(ns / 1e6)


@pytest.mark.parametrize("name", ["decode_issue_ms", "decode_sync_ms",
                                  "backward_issue_ms.large"])
def test_host_metrics_read_none_without_spans(monkeypatch, name):
    monkeypatch.setattr(program_spans, "records", lambda: None)
    assert _metric(name).read(_ctx()) is None
    empty = tracing.Records([], {}, {})
    monkeypatch.setattr(program_spans, "records", lambda: empty)
    assert _metric(name).read(_ctx()) is None
    before = tracing.Records(_decode_records().spans[:3],
                             {("decode.steps", 1): 2}, {})
    monkeypatch.setattr(program_spans, "records", lambda: before)
    assert _metric(name).read(_ctx()) is None


def test_backward_issue_ms_is_the_mean_backward(monkeypatch):
    spans = [_span("train.step", 1, None, 1, 500, 900),
             _span("train.backward", 2, 1, 1, 600, 800),
             _span("train.step", 5, None, 5, 1000, 1900),
             _span("train.backward", 6, 5, 5, 1200, 1500),
             _span("train.step", 8, None, 8, 2000, 2900),
             _span("train.backward", 9, 8, 8, 2100, 2600)]
    rec = tracing.Records(spans, {}, {})
    monkeypatch.setattr(program_spans, "records", lambda: rec)
    got = _metric("backward_issue_ms.large").read(_ctx())
    assert got == pytest.approx((300 + 500) / 2 / 1e6)


@pytest.mark.parametrize("name,span", [
    ("decode_idle_share", "decode.step"),
    ("backward_idle_share.large", "train.backward")])
def test_idle_share_is_the_uncovered_part_of_the_spans(monkeypatch, name,
                                                       span):
    # the device ran [100, 200) and [300, 400); the spans [100, 300) and
    # [350, 500) are covered 100 and 50 of their 350 ns; a span begun
    # before the trace does not count
    spans = [_span(span, 1, None, 1, 100, 300),
             _span(span, 2, None, 2, 350, 500),
             _span(span, 3, None, 3, 10, 90)]
    rec = tracing.Records(spans, {}, {})
    monkeypatch.setattr(program_spans, "records", lambda: rec)
    trace = _trace([("k", 100.0, 150.0), ("k", 140.0, 200.0),
                    ("k", 300.0, 400.0)], t0=50)
    got = _metric(name).read(_ctx(trace))
    assert got == pytest.approx(100.0 * 200 / 350)
    assert _metric(name).read(_ctx()) is None
    assert _metric(name).read(_ctx(_trace([]))) is None
    monkeypatch.setattr(program_spans, "records", lambda: None)
    assert _metric(name).read(_ctx(trace)) is None


def test_a_traced_run_alone_turns_the_recorder_on(tmp_path):
    # no device trace: the CPU has no profiler records of a card
    root = helpers.make(str(tmp_path), analyze_mix=dict(
        helpers.ANALYZE_MIX, trace_steps=0))
    tracing.disable()
    tracing.drain()
    r = cell.run("test-analyze", 5, 0.3, False, device="cpu", root=root,
                 bench_dir=root)
    assert "decode_issue_ms" not in r["metrics"]
    assert not tracing.enabled() and not tracing.drain().spans
    r = cell.run("test-analyze", 5, 0.3, True, device="cpu", root=root,
                 bench_dir=root)
    assert not tracing.enabled() and not tracing.drain().spans
    for name in ("decode_issue_ms", "decode_sync_ms"):
        assert r["metrics"][name]["value"] > 0
    assert "decode_idle_share" not in r["metrics"]
    rec = program_spans.records()
    assert rec.of("decode.step") and rec.counter("decode.steps")
