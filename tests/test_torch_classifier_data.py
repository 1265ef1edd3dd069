"""The port's classifier data path against the JAX package's, on the CPU:
the native loader's resampler and prefetch pool (the same C++ library
through each package's bindings), the decoded-waveform cache (the cases
of tests/test_cache.py, run on the port's copy, and the two copies'
files and hits against each other), the UrbanSound local and HF sources,
and the batchers. Every comparison is exact: both sides run the same
numpy and C++ code on the same bytes."""

import csv
import os
import sys
import types

import numpy as np
import pytest

from audio_transformers_tpu.cli import common as jcommon
from audio_transformers_tpu.data import cache as jcache
from audio_transformers_tpu.data import native_loader as jnl
from audio_transformers_tpu.data import urbansound as jus
from audio_transformers_tpu_torch.cli import common as pcommon
from audio_transformers_tpu_torch.data import cache as pcache
from audio_transformers_tpu_torch.data import native_loader as pnl
from audio_transformers_tpu_torch.data import urbansound as pus
from audio_transformers_tpu_torch.utils.audio import synth_clip, write_wav

TARGET = 64


def _equal_samples(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _wav_dir(root, rates=(22050, 44100, 16000, 22050, 8000, 44100),
             durations=(1.0, 0.7, 1.3, 0.4, 1.0, 2.0)):
    """wav files of several rates and lengths (some shorter than the 1 s
    target: zero-padded) and a metadata.csv in the UrbanSound layout."""
    root.mkdir(exist_ok=True)
    with open(root / "metadata.csv", "w", newline="") as f:
        w = csv.DictWriter(f, ["slice_file_name", "classID"])
        w.writeheader()
        for i, (sr, dur) in enumerate(zip(rates, durations)):
            name = f"c{i}.wav"
            write_wav(str(root / name),
                      synth_clip(dur, sr, freq=200.0 + 90 * i, seed=i), sr)
            w.writerow({"slice_file_name": name, "classID": i % 4})
    return root


# --------------------------------------------------------------------------
# native loader: resample, PrefetchPool, iter_clips
# --------------------------------------------------------------------------


@pytest.mark.parametrize("in_rate,out_rate", [(44100, 22050), (48000, 16000),
                                              (8000, 22050), (16000, 16000)])
def test_resample_matches_jax_bindings(in_rate, out_rate):
    x = np.random.default_rng(in_rate).standard_normal(in_rate // 3) \
        .astype(np.float32)
    got, want = pnl.resample(x, in_rate, out_rate), \
        jnl.resample(x, in_rate, out_rate)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_iter_clips_matches_jax_bindings(tmp_path):
    root = _wav_dir(tmp_path / "w")
    paths = [str(root / f"c{i}.wav") for i in range(6)]
    paths.insert(2, str(tmp_path / "missing.wav"))   # an error mid-stream
    kw = dict(target_rate=22050, target_len=22050, num_threads=3)
    got = list(pnl.iter_clips(paths, **kw))
    want = list(jnl.iter_clips(paths, **kw))
    assert [t for t, _, _ in got] == list(range(7))
    assert [ok for _, _, ok in got] == [ok for _, _, ok in want] \
        == [True, True, False, True, True, True, True]
    for (_, a, ok), (_, b, _) in zip(got, want):
        if ok:
            np.testing.assert_array_equal(a, b)


def test_prefetch_pool_matches_jax_bindings(tmp_path):
    root = _wav_dir(tmp_path / "w")
    outs = []
    for mod in (pnl, jnl):
        with mod.PrefetchPool(num_threads=2, target_rate=16000,
                              target_len=8000, normalize=False,
                              capacity=2) as pool:
            got = []
            for i in range(6):
                while not pool.submit(str(root / f"c{i}.wav"), 10 + i):
                    got.append(pool.pop())
            while pool.pending():
                got.append(pool.pop())
            with pytest.raises(IndexError):
                pool.pop()
        with pytest.raises(ValueError, match="closed"):
            pool.submit("x.wav")
        outs.append(got)
    assert [t for _, t, _ in outs[0]] == list(range(10, 16))
    for (a, ta, oka), (b, tb, okb) in zip(*outs):
        assert (ta, oka) == (tb, okb)
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# the decoded-waveform cache (tests/test_cache.py's cases on the port)
# --------------------------------------------------------------------------


def _wav(seed, scale=0.8):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(TARGET).astype(np.float32)
    return (w / np.max(np.abs(w)) * scale).astype(np.float32)


def test_cache_roundtrip_float32_exact(tmp_path):
    c = pcache.WaveformCache(str(tmp_path), target_len=TARGET, spec="t",
                             dtype="float32")
    w = _wav(0)
    assert c.put("k1", w, {"label": 3})
    out = c.get("k1")
    np.testing.assert_array_equal(out["waveform"], w)
    assert out["label"] == 3 and isinstance(out["label"], int)


def test_cache_roundtrip_int16_tolerance(tmp_path):
    c = pcache.WaveformCache(str(tmp_path), target_len=TARGET, spec="t",
                             dtype="int16")
    w = _wav(1)
    c.put("k1", w)
    out = c.get("k1")["waveform"]
    assert np.max(np.abs(out - w)) <= np.max(np.abs(w)) / 32767.0
    c.put("k2", np.zeros(TARGET, np.float32))
    np.testing.assert_array_equal(c.get("k2")["waveform"],
                                  np.zeros(TARGET, np.float32))


def test_cache_miss_and_shape_guard(tmp_path):
    c = pcache.WaveformCache(str(tmp_path), target_len=TARGET, spec="t")
    assert c.get("nope") is None and c.get(None) is None
    assert not c.put(None, _wav(0))
    assert not c.put("short", np.zeros(TARGET - 1, np.float32))
    assert c.put("k", _wav(0))
    assert not c.put("k", _wav(1))


def test_cache_capacity_bound(tmp_path):
    c = pcache.WaveformCache(str(tmp_path), target_len=TARGET, spec="t",
                             max_bytes=3 * TARGET * 2)
    assert c.capacity == 3
    for i in range(3):
        assert c.put(f"k{i}", _wav(i))
    assert c.full and not c.put("k3", _wav(3))
    assert c.get("k0") is not None


def test_cache_persistence_and_spec_mismatch(tmp_path):
    c = pcache.WaveformCache(str(tmp_path), target_len=TARGET, spec="t",
                             dtype="float32")
    w = _wav(2)
    c.put("k", w, {"label": 7})
    c.close()
    c2 = pcache.WaveformCache(str(tmp_path), target_len=TARGET, spec="t",
                              dtype="float32")
    out = c2.get("k")
    np.testing.assert_array_equal(out["waveform"], w)
    assert out["label"] == 7 and len(c2) == 1 and c2._next_slot == 1
    c2.close()
    for kw in ({"spec": "u", "dtype": "float32"},
               {"spec": "t", "dtype": "int16"}):
        with pytest.raises(ValueError, match="built with"):
            pcache.WaveformCache(str(tmp_path), target_len=TARGET, **kw)


@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_cache_files_match_jax(tmp_path, dtype):
    """The two copies write the same files and read each other's."""
    dirs = {}
    for name, mod in (("port", pcache), ("jax", jcache)):
        c = mod.WaveformCache(str(tmp_path / name), target_len=TARGET,
                              spec="s", dtype=dtype, max_bytes=8 * 4 * TARGET)
        for i in range(5):
            c.put(f"k{i}", _wav(i, scale=0.1 * (i + 1)), {"label": i})
        c.close()
        dirs[name] = tmp_path / name
    for f in ("meta.json", "index.jsonl", "data.bin"):
        assert (dirs["port"] / f).read_bytes() == (dirs["jax"] / f)\
            .read_bytes(), f
    small = 8 * 4 * TARGET
    got = pcache.WaveformCache(str(dirs["jax"]), target_len=TARGET,
                               spec="s", dtype=dtype, max_bytes=small)
    want = jcache.WaveformCache(str(dirs["port"]), target_len=TARGET,
                                spec="s", dtype=dtype, max_bytes=small)
    for i in range(5):
        _equal_samples(got.get(f"k{i}"), want.get(f"k{i}"))


def test_file_fingerprint_matches_jax(tmp_path):
    f = tmp_path / "clip.wav"
    f.write_bytes(b"aaaa")
    k1 = pcache.file_fingerprint(str(f))
    assert k1 == jcache.file_fingerprint(str(f)) and k1 is not None
    f.write_bytes(b"bbbbbb")
    assert pcache.file_fingerprint(str(f)) != k1
    os.utime(str(f), ns=(1, 1))
    assert pcache.file_fingerprint(str(f)) == jcache.file_fingerprint(str(f))
    assert pcache.file_fingerprint(str(tmp_path / "missing.wav")) is None


class _CountingSource:
    """Map-style source that counts real decodes."""

    def __init__(self, n, with_prefetch=False):
        self.n = n
        self.calls = 0
        self.prefetch_indices = []
        if not with_prefetch:
            self.prefetch_iter = None

    @property
    def num_samples(self):
        return self.n

    def _sample(self, i):
        return {"waveform": _wav(100 + i), "label": np.int32(i % 3)}

    def __call__(self, i):
        self.calls += 1
        return self._sample(int(i))

    def prefetch_iter(self, indices, *, num_threads=4):
        self.prefetch_indices.append(list(indices))
        self.calls += len(indices)
        return (self._sample(int(i)) for i in indices)


def test_cached_source_hits_and_streams_only_misses(tmp_path):
    base = _CountingSource(6, with_prefetch=True)
    src = pcache.CachedSource(base, pcache.WaveformCache(
        str(tmp_path), target_len=TARGET, spec="t", dtype="float32"))
    assert src.num_samples == len(src) == 6
    for i in range(3):
        src(i)
    assert base.calls == 3
    order = [4, 0, 5, 1, 3, 2]
    got = list(src.prefetch_iter(order, num_threads=2))
    assert [int(s["label"]) for s in got] == [i % 3 for i in order]
    for s, i in zip(got, order):
        np.testing.assert_array_equal(s["waveform"], _wav(100 + i))
    assert base.prefetch_indices == [[4, 5, 3]] and base.calls == 6
    again = [src(i) for i in range(6)]
    assert base.calls == 6 and len(list(src.prefetch_iter(order))) == 6
    for s, i in zip(again, range(6)):
        np.testing.assert_array_equal(s["waveform"], _wav(100 + i))
    # a base without prefetch: the caller falls back to the map path
    assert pcache.CachedSource(_CountingSource(2), src.cache) \
        .prefetch_iter([0, 1]) is None


def test_cached_source_path_invalidation(tmp_path):
    files = []
    for i in range(3):
        p = tmp_path / f"{i}.raw"
        p.write_bytes(bytes([i]) * 8)
        files.append(str(p))
    base = _CountingSource(3)
    src = pcache.CachedSource(base, pcache.WaveformCache(
        str(tmp_path / "c"), target_len=TARGET, spec="t", dtype="float32"),
        path_of=lambda i: files[int(i)])
    for i in (0, 1, 2, 1):
        src(i)
    assert base.calls == 3
    os.utime(files[1], ns=(123, 456))
    src(1)
    assert base.calls == 4
    src(0), src(2)
    assert base.calls == 4


# --------------------------------------------------------------------------
# UrbanSound sources
# --------------------------------------------------------------------------


@pytest.mark.parametrize("use_native", [True, False])
def test_local_source_matches_jax(tmp_path, use_native):
    root = str(_wav_dir(tmp_path / "w"))
    got = pus.UrbanSoundLocalSource(root, duration=1.0, use_native=use_native)
    want = jus.UrbanSoundLocalSource(root, duration=1.0,
                                     use_native=use_native)
    assert got.num_samples == len(got) == 6
    for i in range(6):
        _equal_samples(got(i), want(i))
        assert got.path_of(i) == want.path_of(i)
    limited = pus.UrbanSoundLocalSource(root, limit_samples=4)
    assert limited.num_samples == 4
    it = got.prefetch_iter([5, 0, 3], num_threads=2)
    if use_native:
        for s, i in zip(it, [5, 0, 3]):
            _equal_samples(s, want.prefetch_iter([i]).__next__())
    else:
        assert it is None


def test_local_source_native_matches_python(tmp_path):
    root = str(_wav_dir(tmp_path / "w"))
    nat = pus.UrbanSoundLocalSource(root, duration=1.0, use_native=True)
    py = pus.UrbanSoundLocalSource(root, duration=1.0, use_native=False)
    pooled = list(nat.prefetch_iter(range(6), num_threads=3))
    for i in range(6):
        a, b = nat(i), py(i)
        assert a["label"] == b["label"] == pooled[i]["label"]
        assert a["waveform"].shape == b["waveform"].shape == (22050,)
        # the C++ and numpy polyphase filters agree within float32 noise
        np.testing.assert_allclose(a["waveform"], b["waveform"], atol=2e-3)
        np.testing.assert_allclose(pooled[i]["waveform"], a["waveform"],
                                   atol=2e-3)


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_local_source_cached_matches_uncached(tmp_path, dtype):
    root = str(_wav_dir(tmp_path / "w"))
    src = pus.UrbanSoundLocalSource(root, duration=1.0)
    cached = src.cached(str(tmp_path / "cache"), dtype=dtype)
    fresh = [src(i) for i in range(6)]
    for epoch in range(2):
        for i in range(6):
            got = cached(i)
            assert int(got["label"]) == int(fresh[i]["label"])
            peak = np.abs(fresh[i]["waveform"]).max()
            tol = 0.0 if dtype == "float32" else peak / 32767.0
            assert np.abs(got["waveform"] - fresh[i]["waveform"]).max() \
                <= tol
    streamed = list(cached.prefetch_iter(range(6), num_threads=2))
    for s, f in zip(streamed, [cached(i) for i in range(6)]):
        np.testing.assert_array_equal(s["waveform"], f["waveform"])
    want = jus.UrbanSoundLocalSource(root, duration=1.0).cached(
        str(tmp_path / "jcache"), dtype=dtype)
    for i in range(6):   # a miss, then hits on both sides
        want(i)
        np.testing.assert_array_equal(cached(i)["waveform"],
                                      want(i)["waveform"])


class _FakeHFDataset:
    def __init__(self, rows):
        self.rows = rows

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i]


def test_hf_source_preprocessing_matches_jax(monkeypatch):
    rng = np.random.default_rng(0)
    rows = [{"audio": {"array": rng.standard_normal(
        (2, 8000) if i % 2 else 6000).astype(np.float64),
        "sampling_rate": (8000, 44100, 22050)[i % 3]},
        "classID": i % 10} for i in range(6)]
    seen = []

    def load_dataset(*a, **k):
        seen.append((a, k))
        return _FakeHFDataset(rows)

    monkeypatch.setitem(sys.modules, "datasets",
                        types.SimpleNamespace(load_dataset=load_dataset))
    got = pus.UrbanSoundHFSource(limit_samples=4)
    want = jus.UrbanSoundHFSource(limit_samples=4)
    assert seen[0] == seen[1] == (("danavery/urbansound8K",),
                                  {"split": "train", "cache_dir": None})
    assert got.num_samples == len(got) == 4
    for i in range(4):
        s = got(i)
        _equal_samples(s, want(i))
        assert s["waveform"].shape == (88200,)
        assert np.abs(s["waveform"]).max() <= 1.0 + 1e-6
        assert s["label"] == i
    assert pus.UrbanSoundHFSource().num_samples == 6


def test_hf_source_without_datasets_says_what_to_use(monkeypatch):
    monkeypatch.setitem(sys.modules, "datasets", None)
    with pytest.raises(ImportError, match="--dataset local"):
        pus.UrbanSoundHFSource()


# --------------------------------------------------------------------------
# batchers
# --------------------------------------------------------------------------


def _batches(b):
    return ([list(b.train_epochs(epoch=e)) for e in (0, 1)]
            + [list(b.eval_batches())])


def _equal_batchers(got, want):
    assert got.steps_per_epoch == want.steps_per_epoch
    for gs, ws in zip(_batches(got), _batches(want)):
        assert len(gs) == len(ws)
        for a, b in zip(gs, ws):
            _equal_samples(a, b)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_get_batchers_match_jax(tmp_path, num_workers):
    root = str(_wav_dir(tmp_path / "w"))
    for use_native in (True, False):
        got = pus.get_batchers(
            pus.UrbanSoundLocalSource(root, duration=1.0,
                                      use_native=use_native),
            batch_size=2, val_split=0.34, seed=5, num_workers=num_workers)
        want = jus.get_batchers(
            jus.UrbanSoundLocalSource(root, duration=1.0,
                                      use_native=use_native),
            batch_size=2, val_split=0.34, seed=5, num_workers=num_workers)
        for g, w in zip(got, want):
            _equal_batchers(g, w)


def _args(**kw):
    base = dict(dataset="synthetic", limit_samples=11, batch_size=4,
                val_split=0.25, seed=3, num_workers=0, data_dir=None,
                waveform_cache=None)
    return types.SimpleNamespace(**{**base, **kw})


@pytest.mark.parametrize("dataset", ["synthetic", "local", "local_cached"])
def test_build_classifier_batchers_match_jax(tmp_path, dataset):
    kw = {}
    if dataset != "synthetic":
        kw = dict(dataset="local", limit_samples=5,
                  data_dir=str(_wav_dir(tmp_path / "w")))
    if dataset == "local_cached":
        # separate directories: each package writes its own cache
        got = pcommon.build_classifier_batchers(
            _args(**kw, waveform_cache=str(tmp_path / "pc")))
        want = jcommon.build_classifier_batchers(
            _args(**kw, waveform_cache=str(tmp_path / "jc")))
        assert os.listdir(tmp_path / "pc")
    else:
        got = pcommon.build_classifier_batchers(_args(**kw))
        want = jcommon.build_classifier_batchers(_args(**kw))
    for g, w in zip(got, want):
        _equal_batchers(g, w)
    valid = [b["valid"] for b in got[1].eval_batches()]
    assert sum(int(v.sum()) for v in valid) == got[1].num_samples
