"""The omni kind and the grin_qwen2_vl family at a toy size on the CPU
(plain versions of the kernels, float32): a run is `correct` against the
plain reference, the float8 control and each planted fault
(`omni_cell.FAULTS`) are not, and a traced run reads the six per-layer
metrics. The same at a small size on the card (`-m cuda`, bfloat16,
the kernels)."""

import json
import os
import shutil

import pytest
import torch

from benchmark.harness import cell, omni_cell, registry

CELL = "t-omni"
METRICS = ("moe_ms.omni", "decode_step_ms.omni", "encoder_ms.omni",
           "expert_gemm_roofline.omni", "idle_share.omni", "mfu.omni")


def _config(hidden=64, heads=4, kv=2, sections=(2, 3, 3), experts=96,
            shared=32, vocab=300, enc=64):
    with open(os.path.join(registry.HERE, "configs",
                           "uni-moe-2.0-omni.json")) as f:
        raw = json.load(f)
    raw.update(hidden_size=hidden, num_hidden_layers=2,
               num_attention_heads=heads, num_key_value_heads=kv,
               dynamic_intermediate_size=experts,
               shared_intermediate_size=shared, vocab_size=vocab,
               whisper_hidden_size=enc, whisper_query_tokens_size=8)
    raw["rope_scaling"] = dict(raw["rope_scaling"],
                               mrope_section=list(sections))
    raw["whisper_encoder"] = dict(
        raw["whisper_encoder"], d_model=enc, encoder_layers=2,
        encoder_attention_heads=2, encoder_ffn_dim=2 * enc, num_mel_bins=80,
        max_source_positions=64)
    raw["assumed"] = dict(raw["assumed"], text_token_ids=[0, vocab - 20],
                          router_init_scale=8.0)
    return raw


MIX = {"kind": "omni", "batch": 3, "pool": 2, "audio_s": [0.4, 3.6],
       "prompt_ids": [10, 14], "audio_after": 8, "max_new_tokens": 6,
       "compute_dtype": "float32", "encoder_bucket": 2, "check_rows": 2,
       "trace_steps": 1}
LIMITS = {"mel_err": 1e-3, "audio_err": 1e-4, "logit_err": 1e-4,
          "route_gap": 0.0, "token_gap": 1e-4}


def _registry(tmp, raw=None, mix=MIX, limits=LIMITS):
    for sub in ("configs", "workloads", "limits", "metrics"):
        os.makedirs(os.path.join(tmp, sub), exist_ok=True)
    with open(os.path.join(tmp, "configs", "toy.json"), "w") as f:
        json.dump(raw or _config(), f)
    with open(os.path.join(tmp, "workloads", "t-omni-mix.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(tmp, "limits", CELL + ".json"), "w") as f:
        json.dump({k: {"limit": v} for k, v in limits.items()}, f)
    for m in METRICS:
        shutil.copy(os.path.join(registry.HERE, "metrics", m + ".py"),
                    os.path.join(tmp, "metrics"))
    real = registry.load_benchmark()
    bench = dict(real, configs=[{"name": "toy", "source": "test size",
                                 "file": "configs/toy.json", "reduced": [],
                                 "why": "tests"}],
                 workloads=[{"name": CELL, "config": "toy",
                             "traffic": "t-omni-mix", "chips": 1,
                             "why": "tests"}])
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [CELL] if "omni-audio-qa-b32" in \
                m["workloads"] else []
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return tmp


def _run(root, trace=False, device="cpu", **kw):
    return cell.run(CELL, 2 ** 31 + 11, 0.2, trace, device=device,
                    root=root, bench_dir=root, **kw)


def test_an_omni_run_is_correct_and_the_control_is_not(tmp_path):
    root = _registry(str(tmp_path))
    r = _run(root, control=True)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"setup_s", "audio_s_per_s"}
    assert r["attempted"] >= 3
    c = r["control"]
    assert any(c[k] > LIMITS[k] for k in LIMITS), c


@pytest.mark.parametrize("fault", sorted(omni_cell.FAULTS))
def test_each_fault_fails_the_check(tmp_path, fault):
    root = _registry(str(tmp_path))
    r = _run(root, plant=omni_cell.FAULTS[fault])
    assert not r["correct"], (fault, r["checks"])


def test_a_traced_run_reads_every_metric(tmp_path):
    root = _registry(str(tmp_path), mix=dict(MIX, trace_steps=0))
    r = _run(root, trace=True)
    assert r["correct"], r["checks"]
    # without a card there is no device trace and no span has CUDA
    # events: only the counters' metric reads
    assert set(r["metrics"]) == {"mfu.omni"}, r["metrics"]
    assert r["metrics"]["mfu.omni"]["value"] > 0


@pytest.mark.cuda
def test_the_omni_cell_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU)")
    raw = _config(hidden=256, heads=4, kv=2, sections=(8, 12, 12),
                  experts=256, shared=128, vocab=1024, enc=128)
    mix = dict(MIX, compute_dtype="bfloat16", batch=5)
    limits = {"mel_err": 0.01, "audio_err": 0.05, "logit_err": 0.05,
              "route_gap": 0.05, "token_gap": 0.05}
    root = _registry(str(tmp_path), raw, mix, limits)
    r = _run(root, trace=True, device="cuda:0")
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == set(METRICS), r["metrics"]
    assert r["metrics"]["expert_gemm_roofline.omni"]["value"] <= 100
    r = _run(root, device="cuda:0", control=True)
    assert r["correct"], r["checks"]
    assert any(r["control"][k] > limits[k] for k in limits), r["control"]
