"""The harness is driven by data: a new configuration, traffic mix and
per-layer metric are found by their names, with no file edited."""

import json
import os

import pytest

from benchmark.harness import cell, registry
from benchmark.tests import helpers

NEW_METRIC = '''
NAME = "steps_seen"
UNIT = "steps"
LAYER = "train step (train/whisper_emotion.make_steps)"
MOVES = "train_clips_per_s"


def read(ctx):
    return float(ctx.cell.steps)
'''


def test_new_files_are_found(tmp_path):
    root = helpers.make(str(tmp_path))
    cfg = dict(helpers.TEST_CONFIG, d_model=96, encoder_attention_heads=3,
               decoder_attention_heads=3)
    (tmp_path / "configs" / "wider.json").write_text(json.dumps(cfg))
    (tmp_path / "workloads" / "t-train-b2.json").write_text(
        json.dumps(dict(helpers.TRAIN_MIX, batch=2)))
    (tmp_path / "metrics" / "steps_seen.py").write_text(NEW_METRIC)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "wider", "source": "test size",
                             "file": "configs/wider.json", "reduced": [],
                             "why": "CPU tests"})
    bench["workloads"].append({"name": "wider-train-b2", "config": "wider",
                               "traffic": "t-train-b2", "chips": 1,
                               "why": "CPU tests"})
    bench["per_layer"].append({
        "name": "steps_seen", "unit": "steps", "better": "higher",
        "source": "host_clock",
        "layer": "train step (train/whisper_emotion.make_steps)",
        "moves": "train_clips_per_s", "workloads": ["wider-train-b2"]})
    for m in bench["end_to_end"]:
        if m["name"] == "train_clips_per_s":
            m["workloads"].append("wider-train-b2")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    found = registry.find("wider-train-b2", root, root)
    assert found.config_file.endswith("wider.json")
    assert list(found.metrics) == ["steps_seen"]
    assert [m["name"] for m in found.end_to_end] == ["setup_s",
                                                     "train_clips_per_s"]
    r = cell.run("wider-train-b2", 5, 0.5, False, device="cpu", root=root,
                 bench_dir=root)
    assert set(r["metrics"]) == {"setup_s", "train_clips_per_s"}
    assert r["attempted"] >= 1


def test_a_metric_must_declare_what_the_benchmark_says(tmp_path):
    root = helpers.make(str(tmp_path))
    bad = NEW_METRIC.replace('UNIT = "steps"', 'UNIT = "ms"')
    (tmp_path / "metrics" / "steps_seen.py").write_text(bad)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "steps_seen", "unit": "steps", "better": "higher",
        "source": "host_clock",
        "layer": "train step (train/whisper_emotion.make_steps)",
        "moves": "train_clips_per_s", "workloads": ["test-train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(SystemExit):
        registry.find("test-train", root, root)


def test_every_cell_of_the_benchmark_resolves():
    bench = registry.load_benchmark()
    for w in bench["workloads"]:
        c = registry.find(w["name"])
        assert os.path.exists(c.config_file)
        assert os.path.exists(c.traffic_file)
        assert os.path.exists(c.limits_file), w["name"]
        assert c.metrics
