"""BENCHMARK.json against the benchmark's contract: names, units and
text fields of the allowed characters, the keys each entry may have,
paths inside the benchmark's folder."""

import json
import os
import re

from benchmark.harness import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = registry.load_benchmark()
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source",
                       "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"}}


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(map(text_ok, BENCH["command"]))
    assert os.path.getsize(os.path.join(registry.ROOT,
                                        "BENCHMARK.json")) <= 64 * 1024


def test_entries():
    for key, allowed in KEYS.items():
        names = [e["name"] for e in BENCH[key]]
        assert len(names) == len(set(names)), key
        for e in BENCH[key]:
            assert set(e) <= allowed, (key, e)
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for field in ("why", "layer", "source"):
                if field in e:
                    assert text_ok(e[field]), (e["name"], field)
    names = {e["name"] for e in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", names)) <= names
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] != "device_trace" or m["unit"] in ("%",
                                                              "launches")
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_files_lie_under_paths_and_each_config_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert os.path.exists(os.path.join(registry.ROOT, c["file"]))
        for k in c["reduced"]:
            assert NAME.match(k)
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_what_the_contract_asks():
    for w in BENCH["workloads"]:
        c = registry.find(w["name"])
        e2e = [m["name"] for m in c.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert c.per_layer


WIDTHS = ("d_model", "encoder_layers", "decoder_layers",
          "encoder_attention_heads", "encoder_ffn_dim", "num_mel_bins",
          "vocab_size")


def test_config_files_hold_the_published_widths():
    """Each configuration file holds, unchanged, every width its family
    module lists as published for its source, and its family parses it."""
    for c in BENCH["configs"]:
        with open(os.path.join(registry.ROOT, c["file"])) as f:
            raw = json.load(f)
        family = registry.family(raw["model_type"])
        published = family.PUBLISHED[c["source"]]
        for key, value in published.items():
            assert raw[key] == value, (c["name"], key)
            assert key not in c["reduced"], (c["name"], key)
        assert family.dims(raw) is not None


def test_the_whisper_family_lists_the_published_widths():
    pub = {"emotion-whisper-tiny": (384, 4, 4, 6, 1536, 80, 51865),
           "emotion-whisper-large-v3": (1280, 32, 32, 20, 5120, 128, 51866)}
    whisper = registry.family("whisper")
    for c in BENCH["configs"]:
        with open(os.path.join(registry.ROOT, c["file"])) as f:
            raw = json.load(f)
        if raw["model_type"] != "whisper":
            continue
        published = whisper.PUBLISHED[c["source"]]
        assert tuple(published[k] for k in WIDTHS) == pub[c["name"]]
        assert tuple(raw[k] for k in WIDTHS) == pub[c["name"]]
        assert published["max_source_positions"] == 1500
        assert raw["max_source_positions"] == 1500
