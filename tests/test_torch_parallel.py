"""The port's data parallelism (`audio_transformers_tpu_torch/parallel/`,
the loader's per-process slice, both trainers in a process group) on
the CPU.

The process geometry is held to the JAX package's with the ranks faked
(the port's own `process_count` and `process_index` monkeypatched, as
tests/test_multiprocess.py fakes JAX's). Two gloo processes launched by
`parallel.launch` take one step of each trainer (tests/torch_dp_worker.py)
and are held to the same worker run as one process on the global batch,
and the draw-free cases to JAX's single-process step on that batch (what
the reference's own two-process test holds to). Every launch has its own
deadline and kills its children when it ends.

Tolerances (float32):
  loss                               1e-5 relative
  gradients, every leaf              max |a - b| <= 1e-4 * max(1, max |b|)
                                     (the reference's two-process test);
                                     a leaf whose JAX gradient is rounding
                                     (under 1e-6 of the tree's largest: the
                                     conv biases before BatchNorm, the key
                                     biases) is rounding in the port too
  BatchNorm running statistics       1e-6 abs
  eval metrics (sums reduced over    1e-6 relative
  the ranks, before any step)
  one epoch of each trainer          1e-3 relative, as the trainer tests
                                     hold the two packages (Adam turns the
                                     rounding-level gradients of the
                                     leaves above into steps of lr)
The two ranks' gradients after the all-reduce are equal bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_dp_worker as worker
from audio_transformers_tpu.core import config as jcfg
from audio_transformers_tpu.data.loader import Batcher as JBatcher
from audio_transformers_tpu.parallel import distributed as jdist
from audio_transformers_tpu.train import classifier as jtc
from audio_transformers_tpu.train import optim as joptim
from audio_transformers_tpu.train import whisper_emotion as jtw
from audio_transformers_tpu_torch.core import params as cp
from audio_transformers_tpu_torch.data.loader import Batcher
from audio_transformers_tpu_torch.models.urbansound import model as us
from audio_transformers_tpu_torch.ops import nn
from audio_transformers_tpu_torch.ops import specaugment as sa
from audio_transformers_tpu_torch.parallel import distributed, mesh
from audio_transformers_tpu_torch.parallel.launch import launch

TESTS = os.path.dirname(os.path.abspath(__file__))
STEPS = ("cls_drop", "cls_plain", "wh_sa", "wh_plain")


@pytest.fixture(autouse=True)
def _one_thread():
    """The tensors here are small: one intra-op thread runs them as fast
    as many alone, and far faster beside other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _fake_procs(monkeypatch, n_proc: int, pid: int):
    for mod in (distributed, jax):
        monkeypatch.setattr(mod, "process_count", lambda: n_proc)
        monkeypatch.setattr(mod, "process_index", lambda: pid)


# --------------------------------------------------------------------------
# process geometry, ranks faked
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n_proc", [2, 4, 8])
@pytest.mark.parametrize("num_samples", [64, 61])  # with + without remainder
def test_process_shard_disjoint_exact_cover(monkeypatch, n_proc,
                                            num_samples):
    shards = []
    for pid in range(n_proc):
        _fake_procs(monkeypatch, n_proc, pid)
        shards.append(list(distributed.process_shard(num_samples)))
        assert shards[-1] == list(jdist.process_shard(num_samples))
    flat = [i for s in shards for i in s]
    assert flat == list(range(num_samples))  # contiguous, ordered, complete
    sizes = [len(s) for s in shards]
    assert all(sz == sizes[0] for sz in sizes[:-1])
    assert sizes[-1] == num_samples - (n_proc - 1) * sizes[0]  # remainder


@pytest.mark.parametrize("n_proc", [2, 4, 8])
def test_local_slice_covers_batch_and_valid(monkeypatch, n_proc):
    src = lambda i: {"x": np.asarray([i], np.float32)}  # noqa: E731
    b = Batcher(src, num_samples=32, batch_size=16)
    jb = JBatcher(src, num_samples=32, batch_size=16, process_sharded=True)
    idxs = list(range(100, 116))
    for valid in (16, 13, 5, 1):  # incl. wrap-padded eval batches
        got_idxs, got_valid = [], 0
        for pid in range(n_proc):
            _fake_procs(monkeypatch, n_proc, pid)
            li, lv = b._local_slice(idxs, valid)
            assert (li, lv) == jb._local_slice(idxs, valid)
            assert len(li) == 16 // n_proc and 0 <= lv <= len(li)
            got_idxs.extend(li)
            got_valid += lv
        assert got_idxs == idxs      # exact cover, in order
        assert got_valid == valid    # no valid row lost or double-counted


@pytest.mark.parametrize("n_proc", [2, 4])
def test_eval_batches_reassemble_across_processes(monkeypatch, n_proc):
    """Each process's sharded eval stream, concatenated, is the
    one-process stream row for row, the padded tail and its valid count
    included."""

    def source(i):
        return {"x": np.full((3,), i, np.float32)}

    kw = dict(num_samples=21, batch_size=8)
    _fake_procs(monkeypatch, 1, 0)
    want = list(Batcher(source, **kw).eval_batches())
    per_pid = []
    for pid in range(n_proc):
        _fake_procs(monkeypatch, n_proc, pid)
        per_pid.append(list(
            Batcher(source, **kw).eval_batches()))
    assert all(len(p) == len(want) for p in per_pid)
    for bi, wb in enumerate(want):
        x = np.concatenate([per_pid[pid][bi]["x"] for pid in range(n_proc)])
        v = np.concatenate([per_pid[pid][bi]["valid"]
                            for pid in range(n_proc)])
        np.testing.assert_array_equal(x, wb["x"])
        assert int(v.sum()) == int(wb["valid"].sum())


def test_local_slice_rejects_indivisible(monkeypatch):
    b = Batcher(lambda i: {"x": np.zeros(1, np.float32)},
                num_samples=10, batch_size=10)
    _fake_procs(monkeypatch, 4, 0)
    with pytest.raises(ValueError, match="not divisible"):
        b._local_slice(list(range(10)), 10)


def test_global_batch_to_local(monkeypatch):
    _fake_procs(monkeypatch, 4, 2)
    assert distributed.global_batch_to_local(32) == 8
    with pytest.raises(ValueError, match="not divisible"):
        distributed.global_batch_to_local(30)


def test_one_process_joins_no_group(monkeypatch):
    for var in ("ATX_NUM_PROCESSES", "WORLD_SIZE", "ATX_COORDINATOR"):
        monkeypatch.delenv(var, raising=False)
    assert not distributed.initialize_if_multihost(device="cpu")
    assert (distributed.process_count(), distributed.process_index()) \
        == (1, 0)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert distributed.process_device("cuda") == torch.device("cuda", 3)
    assert distributed.process_device("cuda:1") == torch.device("cuda", 1)
    assert distributed.process_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("shape,size", [((("data", -1),), 1),
                                        ((("data", 1),), 1),
                                        ((("data", -1), ("model", 1)), 1)])
def test_build_mesh_in_one_process(shape, size):
    m = mesh.build_mesh(shape)
    assert (m.size, m.rank, m.group) == (size, 0, None)
    t = torch.arange(3.0)
    assert mesh.all_reduce_sum(t, m) is t and t.tolist() == [0, 1, 2]


@pytest.mark.parametrize("shape,error,match", [
    ((("data", -1), ("model", 2)), NotImplementedError,
     "tensor parallelism"),
    ((("data", 2),), ValueError, "needs 2 processes, have 1"),
    ((("data", -1), ("model", -1)), ValueError, "at most one"),
    ((("batch", 1),), ValueError, "unknown mesh axes"),
])
def test_build_mesh_refuses(shape, error, match):
    with pytest.raises(error, match=match):
        mesh.build_mesh(shape)


@pytest.mark.parametrize("world", [2, 4])
def test_row_shards_draw_the_global_batch_rows(world):
    """Each rank's draws (uniforms, integers, dropout, SpecAugment's masks)
    are its rows of one process's draws on the global batch."""
    def draws(gen, b):
        x = torch.ones(b, 5, 7)
        return (nn.draw(torch.rand, gen, shape=(b, 3, 2), device="cpu"),
                nn.draw(torch.randint, gen, 0, 9, shape=(b, 4),
                        device="cpu"),
                nn.dropout(gen, x, 0.3, training=True),
                *sa.spec_augment_masks(gen, b, 50, 16))

    want = draws(torch.Generator().manual_seed(5), 2 * world)
    for rank in range(world):
        got = draws(nn.RowShard(torch.Generator().manual_seed(5), rank,
                                world), 2)
        for g, w in zip(got, want):
            assert torch.equal(g, w[2 * rank: 2 * rank + 2])


# --------------------------------------------------------------------------
# two gloo processes against one
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(one process's results, [rank 0's, rank 1's] of two)."""
    one = str(tmp_path_factory.mktemp("dp_one"))
    two = str(tmp_path_factory.mktemp("dp_two"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)    # the module fixture runs before _one_thread
    try:
        worker.run(one)
    finally:
        torch.set_num_threads(threads)
    launch("torch_dp_worker:run", 2, [two], timeout=120,
           env={"PYTHONPATH": TESTS, "OMP_NUM_THREADS": "1"})

    def load(d, r):
        return torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)

    return load(one, 0), [load(two, r) for r in (0, 1)], one, two


def _hold_grads(got: dict, want: dict, floor: float = 0.0):
    assert set(got) == set(want)
    for path, w in want.items():
        g, w = _np(got[path]), _np(w)
        if np.abs(w).max() <= floor:
            assert np.abs(g).max() <= floor, path
            continue
        err = np.abs(g - w).max()
        assert err <= 1e-4 * max(1.0, np.abs(w).max()), (path, err)


@pytest.mark.parametrize("case", STEPS)
def test_two_process_step_matches_one_process(runs, case):
    one, (r0, r1), _, _ = runs
    assert (one["world"], r0["world"]) == (1, 2)
    np.testing.assert_allclose(r0[case]["loss"], one[case]["loss"],
                               rtol=1e-5)
    _hold_grads(r0[case]["grads"], one[case]["grads"])
    for path, g in r0[case]["grads"].items():   # the replicas agree
        assert torch.equal(g, r1[case]["grads"][path]), path
    for path, t in one[case].get("state", {}).items():
        np.testing.assert_allclose(_np(r0[case]["state"][path]), _np(t),
                                   rtol=0, atol=1e-6, err_msg=str(path))
        assert torch.equal(r0[case]["state"][path], r1[case]["state"][path])


def test_ranks_hold_unequal_token_counts(runs):
    """The whisper cases split the global batch so that the ranks hold
    different token counts: a per-rank token mean would then differ from
    the global one, and the gradient check above would fail."""
    one, (r0, r1), _, _ = runs
    for case in ("wh_sa", "wh_plain"):
        assert r0[case]["tokens"] != r1[case]["tokens"]
        assert r0[case]["tokens"] + r1[case]["tokens"] \
            == one[case]["tokens"]
        assert r0[case]["host"]["labels"].shape[0] == worker.WH_BATCH // 2


@pytest.mark.parametrize("case", ["cls_drop", "wh_sa"])
def test_two_process_eval_sums_match_one_process(runs, case):
    one, (r0, r1), _, _ = runs
    assert r0[case]["eval"] == r1[case]["eval"]
    assert set(r0[case]["eval"]) == set(one[case]["eval"])
    for k, v in one[case]["eval"].items():
        np.testing.assert_allclose(r0[case]["eval"][k], v, rtol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("trainer", ["classifier", "whisper"])
def test_two_process_trainers_match_one_process(runs, trainer):
    """One epoch of the trainer function: the same history, and rank 0
    alone wrote the metrics (one line an epoch) and the checkpoints."""
    one, (r0, r1), one_dir, two_dir = runs
    want = one["trainers"][trainer]
    for got in (r0["trainers"][trainer], r1["trainers"][trainer]):
        assert len(got) == len(want) == 1
        for k, v in want[0].items():
            if k not in ("clips_per_sec", "data_wait_s"):
                np.testing.assert_allclose(got[0][k], v, rtol=1e-3,
                                           err_msg=k)
    for d in (one_dir, two_dir):
        with open(os.path.join(d, trainer, "metrics.jsonl")) as f:
            assert len(f.read().splitlines()) == 1
    assert sorted(os.listdir(os.path.join(two_dir, trainer))) \
        == sorted(os.listdir(os.path.join(one_dir, trainer)))


# --------------------------------------------------------------------------
# the two-process steps against JAX's one-process step
# --------------------------------------------------------------------------


def _capture_grads():
    """Passes the gradients on and keeps them as its state: chained
    before the optimizer, the JAX step's gradients are opt_state[0]."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))


def _jax_tcfg(tcfg):
    return jcfg.TrainConfig(
        batch_size=tcfg.batch_size, compute_dtype="float32",
        optimizer=jcfg.OptimizerConfig(**tcfg.optimizer.__dict__))


def _jax_grads(opt_state):
    return dict(cp.leaves_with_path(cp.from_jax_params(
        jax.device_get(opt_state[0]))))


def test_two_process_classifier_step_matches_jax(runs):
    one, (r0, _), _, _ = runs
    cfg = jcfg.UrbanSoundConfig(**worker.CLS.replace(dropout=0.0).__dict__)
    tcfg = _jax_tcfg(worker.cls_tcfg())
    tx = optax.chain(_capture_grads(), joptim.build_optimizer(tcfg.optimizer))
    step, _ = jtc.make_steps(cfg, jcfg.MelConfig.urbansound(), tcfg, tx)
    params, state = (jax.tree.map(jnp.asarray, cp.to_jax_params(t)) for t in
                     us.init(worker.CLS, torch.Generator().manual_seed(0)))
    host = one["cls_plain"]["host"]
    _, jstate, opt_state, m = step(
        params, state, tx.init(params),
        {k: jnp.asarray(v) for k, v in host.items()}, jax.random.PRNGKey(0))
    np.testing.assert_allclose(r0["cls_plain"]["loss"], float(m["loss"]),
                               rtol=1e-5)
    want = _jax_grads(opt_state)
    floor = 1e-6 * max(float(np.abs(_np(g)).max()) for g in want.values())
    _hold_grads(r0["cls_plain"]["grads"], want, floor)
    for path, t in cp.leaves_with_path(cp.from_jax_params(
            jax.device_get(jstate))):
        np.testing.assert_allclose(_np(r0["cls_plain"]["state"][path]),
                                   _np(t), rtol=0, atol=1e-6,
                                   err_msg=str(path))


def test_two_process_whisper_step_matches_jax(runs):
    one, (r0, _), _, _ = runs
    w = worker.WHISPER.whisper
    cfg = jcfg.EmotionWhisperConfig(
        whisper=jcfg.WhisperConfig.test().replace(
            encoder_layers=w.encoder_layers,
            decoder_layers=w.decoder_layers),
        num_emotion_classes=worker.WHISPER.num_emotion_classes)
    tcfg = _jax_tcfg(worker.wh_tcfg())
    tx = optax.chain(_capture_grads(), joptim.build_optimizer(
        tcfg.optimizer, decay_mask=joptim.frozen_leaf_decay_mask))
    step, _ = jtw.make_steps(cfg, jcfg.MelConfig.whisper(), tcfg, tx)
    params = jax.tree.map(jnp.asarray, cp.to_jax_params(
        cp.init(worker.WHISPER, torch.Generator().manual_seed(0))))
    host = one["wh_plain"]["host"]
    _, opt_state, m = step(params, tx.init(params),
                           {k: jnp.asarray(v) for k, v in host.items()})
    np.testing.assert_allclose(r0["wh_plain"]["loss"], float(m["loss"]),
                               rtol=1e-5)
    want = {p: g for p, g in _jax_grads(opt_state).items()
            if p not in cp.FROZEN}
    _hold_grads(r0["wh_plain"]["grads"], want)


# --------------------------------------------------------------------------
# the entry points
# --------------------------------------------------------------------------


def test_launch_kills_every_child_when_one_fails():
    with pytest.raises(RuntimeError, match="rank 1 exited with 3"):
        launch("torch_dp_worker:fail_on_rank_1", 2, timeout=60,
               env={"PYTHONPATH": TESTS})


def test_launch_kills_children_at_its_deadline():
    with pytest.raises(TimeoutError, match="outlived"):
        launch("torch_dp_worker:fail_on_rank_1", 1, [600.0], timeout=2,
               env={"PYTHONPATH": TESTS})


def test_dryrun_multichip_two_processes():
    from audio_transformers_tpu_torch.entry import dryrun_multichip
    outs = dryrun_multichip(2, timeout=120)
    for rank, out in enumerate(outs):
        assert f"rank {rank} loss=" in out
        assert "token-equal to one process" in out
