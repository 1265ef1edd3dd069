"""The port's tensor parallelism (`parallel/tensor.py`, the 2-D
`parallel/mesh.py`, whisper's and the classifier's `param_axes`, the TP
forward, greedy and beam decodes, the vocab-parallel cross-entropy, the
classifier's and whisper's TP train steps, K2's vocab-shard mode) on the
CPU.

gloo processes launched by `parallel.launch` run tests/torch_tp_worker.py
on a `model:2` mesh (2 processes) and on `data:2 x model:2` (4), and the
same worker runs as one process; the parameters are JAX's seeded init,
bridged. Held to:

  shards, every leaf                 equal to the JAX leaf cut by JAX's
                                     `emo.param_axes` PartitionSpec (the
                                     port's weights transposed); the
                                     embedding on its real rows of the
                                     padded cut pad_vocab(V) / t
  forward_train logits               JAX's forward_train within rtol = atol
                                     = 2e-4 (tests/test_sharding.py's
                                     bound on JAX's own TP)
  greedy decode (penalty 1.15, 3-gram
  ban; timestamped; int8 with
  step_attn and logits_impl "xla")   JAX's generate, token for token
  int4 cross K/V; the sampling
  fallback                           the same process's one-process decode
                                     of its rows, token for token
  beams (3, penalty 1.15, 3-gram
  ban; kv_quant none, int8, and
  timestamped)                       JAX's generate_beam: tokens, lengths,
                                     the kept set equal, scores within
                                     1e-5 relative; every model rank's
                                     outputs the same (and the ranks'
                                     parents and tokens compared every
                                     step, `check_ranks`)
  beams with int4, timestamped       the one-process port, the same
  vocab-parallel cross-entropy       JAX's dual_loss on the gathered logits
                                     within 1e-6 relative (targets at the
                                     shards' edges and on the pad id);
                                     gradients within 1e-6 * max(1, max
                                     |g|) of the gathered route's; in
                                     threads (hypothesis) F.cross_entropy's
                                     values (1e-6 relative + 1e-5) and
                                     gradients (1e-5 relative + 1e-6),
                                     float32 sums in another order; ids
                                     past the vocab ignored
  the classifier's shards            JAX's urbansound `param_axes`, leaf
                                     for leaf
  the classifier's TP forward        JAX's apply (eval mode) within rtol =
                                     atol = 2e-4
  one TP classifier step, dropout
  0.1                                one process: loss 1e-6 relative,
                                     gradients at hold's 1e-4 * max(1,
                                     max |g|), every whole leaf bit-equal
                                     over the model ranks
  two TP steps of each trainer, model
  rank 1's conv gradient one ulp up  every whole leaf, its Adam moments
                                     and BatchNorm's state bit-equal over
                                     the model ranks
  one TP train step                  one process on the global batch: loss
                                     1e-6 relative, the clip's norm 1e-6
                                     relative, gradients 1e-4 * max(1,
                                     max |g|) per leaf (torch_dp_worker.
                                     hold's), updated parameters within
                                     2 * lr (Adam's first step turns a
                                     rounding-level gradient into a step
                                     of lr either way); every whole leaf
                                     bit-equal over the model ranks
  one epoch of each trainer, a       one process's history, 1e-3 relative
  resume of whisper's to 2 epochs,   (hold's), rank 0 alone writing, the
  and train_classifier(tensor_       checkpoints the whole tree
  parallel=True) with its resume
  K2 partials merged over t in
  {1, 2, 4} shards                   the whole-vocab plain version, token
                                     for token (rows whose timestamp
                                     log-sum-exp lies within 1e-4 of the
                                     text max are left out: summed in
                                     another order, either answer is
                                     right)
"""

import os
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F
from hypothesis import given, settings
from hypothesis import strategies as st

import torch_tp_worker as worker
from audio_transformers_tpu.core import config as jcfg
from audio_transformers_tpu.models.urbansound import model as jus
from audio_transformers_tpu.models.whisper import beam as jbeam
from audio_transformers_tpu.models.whisper import decode as jdec
from audio_transformers_tpu.models.whisper import emotion as jemo
from audio_transformers_tpu.models.whisper import model as jwm
from audio_transformers_tpu_torch.core import params as cp
from audio_transformers_tpu.train import whisper_emotion as jtw
from audio_transformers_tpu_torch.core.config import WhisperConfig
from audio_transformers_tpu_torch.models.urbansound import model as us
from audio_transformers_tpu_torch.models.whisper import emotion as emo
from audio_transformers_tpu_torch.models.whisper import model as wm
from audio_transformers_tpu_torch.ops import decode_logits as dl
from audio_transformers_tpu_torch.ops import logit_processors as lp
from audio_transformers_tpu_torch.parallel import tensor as tp
from audio_transformers_tpu_torch.parallel.launch import launch

TESTS = os.path.dirname(os.path.abspath(__file__))
MESHES = ("model2", "data2model2")
RANKS = {"model2": 2, "data2model2": 4}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _jax_cfg():
    w = worker.WHISPER
    return jcfg.EmotionWhisperConfig(
        whisper=jcfg.WhisperConfig(**w.__dict__),
        num_emotion_classes=worker.CFG.num_emotion_classes)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": JAX params (numpy), "one": the one-process results,
    mesh: [each rank's results]} and the output directory."""
    out = str(tmp_path_factory.mktemp("tp"))
    jp = jax.tree.map(np.asarray, jemo.init(jax.random.PRNGKey(0),
                                            _jax_cfg()))
    torch.save(cp.from_jax_params(jp), os.path.join(out, "params.pt"))
    # both launches run while this process runs the one-process case
    with ThreadPoolExecutor(len(MESHES)) as pool:
        jobs = [pool.submit(launch, "torch_tp_worker:run", RANKS[name],
                            [out, name], timeout=150,
                            env={"PYTHONPATH": TESTS, "OMP_NUM_THREADS": "1"})
                for name in MESHES]
        threads = torch.get_num_threads()
        torch.set_num_threads(1)   # the module fixture runs before _one_thread
        try:
            worker.run(out, "one")
        finally:
            torch.set_num_threads(threads)
        for job in jobs:
            job.result()
    res = {"jax": jp, "dir": out}
    for name in ("one",) + MESHES:
        res[name] = [torch.load(os.path.join(out, f"{name}_rank{r}.pt"),
                                weights_only=False)
                     for r in range(RANKS.get(name, 1))]
    res["one"] = res["one"][0]
    return res


@pytest.fixture(scope="module")
def jax_outputs(runs):
    """JAX's forward_train and greedy decodes of the whole batch."""
    cfg = _jax_cfg()
    jp = runs["jax"]
    mel, ids = worker.inputs()
    logits, emo_logits = jemo.forward_train(jp, cfg, jnp.asarray(mel),
                                            jnp.asarray(ids))
    out = {"forward": (np.asarray(logits), np.asarray(emo_logits))}
    enc = jwm.encode(jp["whisper"], cfg.whisper, jnp.asarray(mel))
    jfields = set(jcfg.DecodeConfig.__dataclass_fields__)
    for case in ("greedy", "ts", "xla"):
        d = worker.DECODES[case]
        got = jdec.generate(jp["whisper"], cfg.whisper, jcfg.DecodeConfig(
            **{k: v for k, v in d.__dict__.items() if k in jfields}), enc)
        out[case] = {k: np.asarray(got[k]) for k in ("tokens", "lengths")}
    for case in ("beam", "beam_int8", "beam_ts"):
        d = worker.BEAMS[case]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = jbeam.generate_beam(jp["whisper"], cfg.whisper,
                                      jcfg.DecodeConfig(**{
                                          k: v for k, v in d.__dict__.items()
                                          if k in jfields}), enc)
        out[case] = {k: np.asarray(v) for k, v in got.items()}
    return out


# --------------------------------------------------------------------------
# the mesh and the layout
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", MESHES)
def test_build_mesh_has_a_model_axis(runs, name):
    """build_mesh((data, d), (model, t)) builds in gloo processes: rank =
    data_index * t + model_index, `Mesh.size/rank` the data axis."""
    t = 2
    d = RANKS[name] // t
    for rank, r in enumerate(runs[name]):
        assert r["mesh"] == (d, rank // t, t, rank % t)
        assert r["rows"] == ((rank // t) * worker.BATCH // d,
                             (rank // t + 1) * worker.BATCH // d)


def test_shards_match_jax_param_axes(runs):
    """Rank r's leaves are the JAX leaves cut as JAX's PartitionSpecs
    say, in the port's (out, in) layout; the embedding is cut on the
    padded vocab boundary, its real rows compared."""
    jp = runs["jax"]
    specs = jemo.param_axes(jp)
    spec_leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    jleaves = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    t = 2
    checked = 0
    for path, spec in spec_leaves:
        port_path = tuple(getattr(k, "key", getattr(k, "idx", None))
                          for k in path)
        leaf = np.asarray(jleaves[path])
        axis = [i for i, a in enumerate(spec) if a == "model"]
        for r, res in enumerate(runs["model2"]):
            got = _np(res["shards"][port_path])
            if not axis:
                want = leaf
            elif port_path[-2:] == ("embed", "table"):
                assert axis == [0]
                v0, v1, _ = tp.vocab_shard(worker.WHISPER.vocab_size, t, r)
                want = leaf[v0:v1]
            else:
                want = np.split(leaf, t, axis=axis[0])[r]
            key = port_path[-1]
            want = _np(cp.from_jax_params({key: want})[key])  # port layout
            np.testing.assert_array_equal(got, want, err_msg=str(port_path))
        checked += bool(axis)
    # per block q w/b, k w, v w/b, o w (self and cross), fc1 w/b, fc2 w
    assert checked == 2 * 9 + 2 * 15 + 1   # encoder, decoder blocks, table


def test_vocab_shards_cut_the_padded_vocab():
    v = WhisperConfig().vocab_size
    assert tp.vocab_shard(v, 2, 0) == (0, 26112, 26112)
    assert tp.vocab_shard(v, 2, 1) == (26112, 51865, 26112)   # 25753 rows
    assert tp.vocab_shard(v, 4, 3) == (3 * 13056, 51865, 13056)
    assert tp.vocab_shard(v, 1, 0) == (0, v, dl.pad_vocab(v))


def test_param_axes_refuses_a_split_inside_a_head():
    cfg = worker.CFG
    params = cp.init(cfg, torch.Generator().manual_seed(0))
    emo.param_axes(params, cfg, 2)
    with pytest.raises(ValueError, match="heads"):
        emo.param_axes(params, cfg, 4)          # 2 heads over 4 ranks
    with pytest.raises(ValueError, match="heads"):
        wm.param_axes(params["whisper"], WhisperConfig(), 4)   # tiny: 6


def test_classifier_param_axes_match_jax():
    """The classifier's layout is JAX's urbansound PartitionSpecs on the
    port's (out, in) weights: P(None, "model") cuts the port's dim 0,
    P("model", None) its dim 1, P("model") a bias's dim 0, P() nothing."""
    cfg = worker.dpw.CLS
    params, _ = us.init(cfg, torch.Generator().manual_seed(1))
    axes = {path: split for (path, _), split in zip(
        cp.leaves_with_path(params),
        tp.split_leaves(us.param_axes(params, cfg, 2)))}
    jp = cp.to_jax_params(params)
    specs = jax.tree_util.tree_flatten_with_path(
        jus.param_axes(jp),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    assert len(specs) == len(axes)
    cut = 0
    for path, spec in specs:
        port_path = tuple(getattr(k, "key", getattr(k, "idx", None))
                          for k in path)
        got = axes[port_path]
        want = {(): None, ("model",): tp.Split(0),
                (None, "model"): tp.Split(0),
                ("model", None): tp.Split(1)}[tuple(spec)]
        assert got == want, port_path
        cut += got is not None
    # per block q/k/v w and b, o w, fc1 w and b, fc2 w
    assert cut == 10 * cfg.num_encoder_blocks


def test_classifier_param_axes_refuse_an_uneven_split():
    cfg = worker.dpw.CLS                       # 2 heads, 96 hidden units
    params, _ = us.init(cfg, torch.Generator().manual_seed(1))
    us.param_axes(params, cfg, 2)
    with pytest.raises(ValueError, match="heads"):
        us.param_axes(params, cfg, 4)
    with pytest.raises(ValueError, match="hidden"):
        us.param_axes(params, cfg.replace(num_heads=8, encoder_dim=9), 8)


# --------------------------------------------------------------------------
# forward and decode
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", MESHES)
def test_tp_forward_matches_jax(runs, jax_outputs, name):
    """forward_train's logits (each rank's vocab shard, gathered here) and
    emotion logits within 2e-4 of JAX's."""
    for r in runs[name]:
        rows = slice(*r["rows"])
        assert r["forward_width"] == tp.vocab_shard(
            worker.WHISPER.vocab_size, 2, r["mesh"][3])[1] - tp.vocab_shard(
            worker.WHISPER.vocab_size, 2, r["mesh"][3])[0]
        for got, want in zip(r["forward"], jax_outputs["forward"]):
            np.testing.assert_allclose(_np(got), want[rows], rtol=2e-4,
                                       atol=2e-4)


@pytest.mark.parametrize("case", ["greedy", "ts", "xla"])
@pytest.mark.parametrize("name", MESHES)
def test_tp_greedy_decode_matches_jax(runs, jax_outputs, name, case):
    want = jax_outputs[case]
    for r in runs[name]:
        rows = slice(*r["rows"])
        for k in ("tokens", "lengths"):
            np.testing.assert_array_equal(_np(r["decode"][case][k]),
                                          want[k][rows])
    if case == "ts":   # rows mix timestamps and text
        toks = want["tokens"][:, 1:]
        assert (toks >= worker.WHISPER.timestamp_begin_id).any()
        assert (toks < worker.WHISPER.eos_token_id).any()


@pytest.mark.parametrize("case", ["int4", "fallback"])
@pytest.mark.parametrize("name", MESHES)
def test_tp_decode_matches_one_process(runs, name, case):
    """int4 cross K/V, and the sampling fallback (every row re-decoded at
    temperature 0.7: the logits gathered over the vocab shards, the same
    noise on every model rank), equal to t = 1 on the same rows."""
    for r in runs[name]:
        for k in ("tokens", "lengths"):
            assert torch.equal(r["decode"][case][k],
                               r["decode"][case + "_one"][k]), (case, k)
    one = runs["one"]["decode"]
    assert not torch.equal(one["fallback"]["tokens"], one["ts"]["tokens"])


def _hold_beams(got, want):
    for k in ("tokens", "lengths", "beam_tokens", "beam_lengths"):
        np.testing.assert_array_equal(_np(got[k]), want[k], err_msg=k)
    np.testing.assert_allclose(_np(got["beam_scores"]), want["beam_scores"],
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("case", ["beam", "beam_int8", "beam_ts"])
@pytest.mark.parametrize("name", MESHES)
def test_tp_beams_match_jax(runs, jax_outputs, name, case):
    """Beams on head shards, the logits gathered to whole rows each
    step, against JAX's single-device generate_beam of the same rows;
    every model rank returns the same outputs."""
    want = jax_outputs[case]
    for r in runs[name]:
        rows = slice(*r["rows"])
        _hold_beams(r["decode"][case], {k: v[rows] for k, v in want.items()})
        peer = runs[name][r["mesh"][1] * 2]
        for k in worker.BEAM_KEYS:
            assert torch.equal(r["decode"][case][k], peer["decode"][case][k])
    if case == "beam_ts":      # the kept beams mix timestamps and text
        toks = want["beam_tokens"][..., 1:]
        assert (toks >= worker.WHISPER.timestamp_begin_id).any()


@pytest.mark.parametrize("name", MESHES)
def test_tp_beams_int4_match_one_process(runs, name):
    """Timestamped beams over int4 cross K/V: the one-process port's
    search on the same rows, and its hiddens within 2e-4."""
    for r in runs[name]:
        got, one = r["decode"]["beam_int4"], r["decode"]["beam_int4_one"]
        _hold_beams(got, {k: _np(v) for k, v in one.items()})
        np.testing.assert_allclose(_np(got["hiddens"]), _np(one["hiddens"]),
                                   rtol=2e-4, atol=2e-4)


# --------------------------------------------------------------------------
# the vocab-parallel cross-entropy
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", MESHES)
def test_vocab_parallel_ce_matches_jax_dual_loss(runs, jax_outputs, name):
    """dual_loss over the vocab shards (targets at the shards' edges and
    on the pad id) equals JAX's dual_loss on its whole logits of the same
    rows within 1e-6 relative, and so does the gathered route."""
    labels = worker.ce_labels()
    logits, emo_logits = jax_outputs["forward"]
    for r in runs[name]:
        rows = slice(*r["rows"])
        emo_labels = np.arange(worker.BATCH)[rows] \
            % worker.CFG.num_emotion_classes
        want = jtw.dual_loss(jnp.asarray(logits[rows]),
                             jnp.asarray(emo_logits[rows]),
                             jnp.asarray(labels[rows]),
                             jnp.asarray(emo_labels),
                             pad_token_id=worker.WHISPER.pad_token_id,
                             emotion_weight=0.5)
        for route in ("parallel", "gathered"):
            got = r["ce"][route]
            np.testing.assert_allclose(got["loss"], float(want["loss"]),
                                       rtol=1e-6)
            np.testing.assert_allclose(
                got["transcription"], float(want["transcription_loss"]),
                rtol=1e-6)
    # the targets hit both shards and their edges
    targets = labels[:, 1:]
    assert np.isin(worker.EDGE_IDS, targets).all()


@pytest.mark.parametrize("name", MESHES)
def test_vocab_parallel_ce_gradients_equal_the_gathered_route(runs, name):
    for r in runs[name]:
        par, gat = r["ce"]["parallel"], r["ce"]["gathered"]
        assert set(par["grads"]) == set(gat["grads"])
        for path, g in gat["grads"].items():
            err = float((par["grads"][path] - g).abs().max())
            assert err <= 1e-6 * max(1.0, float(g.abs().max())), path
        # the vocab shards' rows of the table took their gradient
        table = ("whisper", "decoder", "embed", "table")
        assert float(par["grads"][table].abs().max()) > 0


class _Threads:
    """t threads as the ranks of a model group: `dist.all_reduce` patched
    to a barrier-synchronised reduction over them (each thread passes its
    rank as the group)."""

    def __init__(self, t):
        self.t, self.slots = t, [None] * t
        self.barrier = threading.Barrier(t)

    def all_reduce(self, x, op=dist.ReduceOp.SUM, group=None):
        self.slots[group] = x.clone()
        self.barrier.wait()
        parts = torch.stack(self.slots)
        x.copy_(parts.amax(0) if op == dist.ReduceOp.MAX else parts.sum(0))
        self.barrier.wait()

    def run(self, fn):
        out = [None] * self.t
        errors = []

        def body(r):
            try:
                out[r] = fn(r)
            except BaseException as e:      # noqa: BLE001 - re-raised
                errors.append(e)
                self.barrier.abort()
        threads = [threading.Thread(target=body, args=(r,))
                   for r in range(self.t)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        return out


@settings(max_examples=15, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2 ** 31 - 1), t=st.sampled_from([2, 4]),
       edge=st.integers(-2, 1), scale=st.sampled_from([1.0, 30.0]))
def test_vocab_parallel_ce_at_shard_edges(seed, t, edge, scale):
    """In t threads: each rank's shard of (B, T, V) float32 logits, the
    last rank's padded past V = 1000 (padded 1024) with large values that
    must be ignored; targets at every shard's first and last ids (+ edge).
    The per-token CE and the gradients equal F.cross_entropy's on the
    whole logits (float32 sums in another order: 1e-5 absolute on values
    up to about 100); the padded columns take no gradient."""
    v = 1000
    g = torch.Generator().manual_seed(seed)
    logits = scale * torch.randn((3, 5, v), generator=g)
    width = dl.pad_vocab(v) // t
    starts = [tp.vocab_shard(v, t, r)[0] for r in range(t)]
    ids = torch.tensor([min(max(s + edge, 0), v - 1) for s in starts]
                       + [min(max(s + width - 1 + edge, 0), v - 1)
                          for s in starts])
    targets = ids[torch.randint(0, len(ids), (3, 5), generator=g)]
    sim = _Threads(t)

    def rank(r):
        v0, v1, _ = tp.vocab_shard(v, t, r)
        shard = torch.full((3, 5, width), 1e4)
        shard[..., :v1 - v0] = logits[..., v0:v1]
        shard.requires_grad_(True)
        ce = tp.vocab_parallel_cross_entropy(shard, targets, r, v0, v)
        (ce * torch.arange(1.0, 16.0).view(3, 5)).sum().backward()
        return ce.detach(), shard.grad, v1 - v0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dist, "all_reduce", sim.all_reduce)
        out = sim.run(rank)
    whole = logits.clone().requires_grad_(True)
    want = F.cross_entropy(whole.transpose(1, 2), targets,
                           reduction="none")
    (want * torch.arange(1.0, 16.0).view(3, 5)).sum().backward()
    for r, (ce, grad, n) in enumerate(out):
        assert torch.allclose(ce, want.detach(), rtol=1e-6, atol=1e-5)
        v0 = starts[r]
        assert torch.allclose(grad[..., :n], whole.grad[..., v0:v0 + n],
                              rtol=1e-5, atol=1e-6)
        assert (grad[..., n:] == 0).all()


# --------------------------------------------------------------------------
# the classifier's tensor parallelism
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", MESHES)
def test_tp_classifier_forward_matches_jax(runs, name):
    """us.apply on each rank's shards, eval mode, within 2e-4 of JAX's
    apply on the whole tree."""
    cfg = worker.dpw.CLS
    params, state = us.init(cfg, torch.Generator().manual_seed(1))
    want, _ = jus.apply(cp.to_jax_params(params), cp.to_jax_params(state),
                        jcfg.UrbanSoundConfig(**cfg.__dict__),
                        jnp.asarray(worker.cls_mel()), training=False)
    want = np.asarray(want)
    for r in runs[name]:
        d_size, d_rank = r["mesh"][:2]
        per = worker.CLS_MEL[0] // d_size
        np.testing.assert_allclose(
            _np(r["classifier"]["logits"]),
            want[d_rank * per:(d_rank + 1) * per], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", MESHES)
def test_tp_classifier_step_matches_one_process(runs, name):
    """One TP classifier step with dropout 0.1 (the masks drawn for every
    head and hidden unit, each rank keeping its own) equals one process's
    step on the global batch; the whole leaves agree bit for bit over the
    model ranks."""
    want = runs["one"]["classifier"]
    assert want["rows"] == worker.dpw.CLS_BATCH
    for r in runs[name]:
        got = r["classifier"]
        assert got["rows"] == worker.dpw.CLS_BATCH * 2 // RANKS[name]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
        assert set(got["grads"]) == set(want["grads"])
        for path, g in want["grads"].items():
            err = float((got["grads"][path] - g).abs().max())
            assert err <= 1e-4 * max(1.0, float(g.abs().max())), path
        for path, s in want["state"].items():
            np.testing.assert_allclose(got["state"][path], s, rtol=1e-5,
                                       atol=1e-6, err_msg=str(path))
        peer = runs[name][r["mesh"][1] * 2]["classifier"]
        for path, t in got["whole_leaves"].items():
            assert torch.equal(t, peer["whole_leaves"][path]), path


# --------------------------------------------------------------------------
# the train step and the trainers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", MESHES)
def test_tp_train_step_matches_one_process(runs, name):
    want = runs["one"]["step"]
    lr = worker.dpw.LR
    for r in runs[name]:
        got = r["step"]
        assert got["rows"] == worker.dpw.WH_BATCH * 2 // RANKS[name]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
        assert set(got["grads"]) == set(want["grads"])
        for path, g in want["grads"].items():
            err = float((got["grads"][path] - g).abs().max())
            assert err <= 1e-4 * max(1.0, float(g.abs().max())), path
        for path, p in want["params"].items():
            assert got["params"][path].shape == p.shape, path
            assert float((got["params"][path] - p).abs().max()) <= 2 * lr


@pytest.mark.parametrize("name", MESHES)
def test_tp_clip_norm_is_the_whole_trees(runs, name):
    want = runs["one"]["step"]["norm"]
    assert want > worker.CLIP        # the clip acts
    for r in runs[name]:
        np.testing.assert_allclose(r["step"]["norm"], want, rtol=1e-6)


@pytest.mark.parametrize("name", MESHES)
def test_tp_whole_leaves_agree_over_the_model_ranks(runs, name):
    ranks = runs[name]
    for r in ranks:
        peer = ranks[r["mesh"][1] * 2]      # model rank 0 of its data group
        assert set(r["step"]["whole_leaves"]) \
            == set(peer["step"]["whole_leaves"])
        for path, t in r["step"]["whole_leaves"].items():
            assert torch.equal(t, peer["step"]["whole_leaves"][path]), path


@pytest.mark.parametrize("trainer", ["whisper", "classifier"])
@pytest.mark.parametrize("name", MESHES)
def test_whole_state_stays_equal_under_one_rank_s_rounding(runs, name,
                                                           trainer):
    """Model rank 1's first convolution takes a gradient one ulp off rank
    0's at each of two TP steps (`torch_tp_worker.drift`): every whole
    leaf, its Adam moments and BatchNorm's state stay bit-equal over the
    model ranks (`Optimizer.reconcile`)."""
    ranks = runs[name]
    for r in ranks:
        got = r["drift"]
        assert got[f"{trainer}_calls"] == (2 if r["mesh"][3] == 1 else 0)
        want = ranks[r["mesh"][1] * 2]["drift"][trainer]
        assert set(got[trainer]) == set(want)
        kinds = {key[0] for key in want}
        assert {"leaf", "exp_avg", "exp_avg_sq"} <= kinds
        assert ("state" in kinds) == (trainer == "classifier")
        for key, t in got[trainer].items():
            assert torch.equal(t, want[key]), key


@pytest.mark.parametrize("trainer", ["whisper", "classifier"])
@pytest.mark.parametrize("name", MESHES)
def test_trainers_on_a_model_axis_match_one_process(runs, name, trainer):
    want = runs["one"]["trainers"][trainer]
    for r in runs[name]:
        got = r["trainers"][trainer]
        assert len(got) == len(want) == 1
        for k, v in want[0].items():
            if k not in ("clips_per_sec", "data_wait_s"):
                np.testing.assert_allclose(got[0][k], v, rtol=1e-3,
                                           err_msg=k)
    d = os.path.join(runs["dir"], name, trainer)
    with open(os.path.join(d, "metrics.jsonl")) as f:
        # rank 0 alone, a line an epoch (whisper's second from its resume)
        assert len(f.read().splitlines()) == (2 if trainer == "whisper"
                                              else 1)
    if trainer == "whisper":
        # a resume on the mesh from its own checkpoint: one process's
        want = runs["one"]["trainers"]["whisper_resumed"]
        for r in runs[name]:
            got = r["trainers"]["whisper_resumed"]
            assert [g["epoch"] for g in got] == [w["epoch"] for w in want] \
                == [2]
            for k, v in want[0].items():
                if k not in ("clips_per_sec", "data_wait_s"):
                    np.testing.assert_allclose(got[0][k], v, rtol=1e-3,
                                               err_msg=k)
        # the checkpoints and the returned params are the whole tree
        full = runs["one"]["trainers"]["whisper_params"]
        for r in runs[name]:
            got = r["trainers"]["whisper_params"]
            assert {p: t.shape for p, t in got.items()} \
                == {p: t.shape for p, t in full.items()}
        assert sorted(os.listdir(d)) == sorted(os.listdir(os.path.join(
            runs["dir"], "one", "whisper")))


@pytest.mark.parametrize("name", MESHES)
def test_classifier_trainer_cut_over_the_model_axis(runs, name):
    """train_classifier(tensor_parallel=True): one epoch, then a resume
    to 2 epochs from its own checkpoint (the whole tree, cut again), each
    equal to one process's (1e-3 relative, hold's); the returned params
    are the whole tree."""
    want = runs["one"]["trainers"]
    for r in runs[name]:
        got = r["trainers"]
        for run_got, run_want in zip(got["classifier_tp"],
                                     want["classifier_tp"]):
            assert [g["epoch"] for g in run_got] \
                == [w["epoch"] for w in run_want]
            for g, w in zip(run_got, run_want):
                for k, v in w.items():
                    if k not in ("clips_per_sec", "data_wait_s"):
                        np.testing.assert_allclose(g[k], v, rtol=1e-3,
                                                   err_msg=k)
        assert {p: t.shape for p, t in got["classifier_tp_params"].items()} \
            == {p: t.shape for p, t in
                want["classifier_tp_params"].items()}
    assert [len(h) for h in want["classifier_tp"]] == [1, 1]   # resumed


# --------------------------------------------------------------------------
# K2's vocab-shard mode: plain partials merged over t shards
# --------------------------------------------------------------------------

V = 1000                    # padded to 1024: shards of 1024, 512, 256
V_PAD = dl.pad_vocab(V)


def _shard_partials(h, table_t, add, seen, ban, kw, t):
    w = V_PAD // t
    cut = (lambda m, r: None if m is None
           else m[:, r * w:(r + 1) * w].contiguous())
    return torch.stack([dl.fused_greedy_step(
        h, table_t[:, r * w:(r + 1) * w].contiguous(),
        add[r * w:(r + 1) * w].contiguous(), seen=cut(seen, r),
        ban=cut(ban, r), vocab_offset=r * w, partials=True, **kw)
        for r in range(t)])


def _decidable(h, table_t, add, seen, ban, kw) -> torch.Tensor:
    """Rows whose timestamp log-sum-exp (float64) is not within 1e-4 of
    the text max."""
    if kw.get("ts_bounds") is None:
        return torch.ones(h.shape[0], dtype=torch.bool)
    tb = kw["timestamp_begin"]
    l = dl.processed_logits(h, table_t, add, seen=seen, ban=ban,
                            **kw).double()
    return (torch.logsumexp(l[:, tb:], -1) - l[:, :tb].amax(-1)).abs() > 1e-4


@settings(max_examples=40, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2 ** 31 - 1), ts=st.booleans(),
       edge=st.sampled_from([256, 512, 768]),
       masked=st.integers(-40, 40), tb_shift=st.integers(-3, 3))
def test_merged_partials_equal_the_whole_vocab(seed, ts, edge, masked,
                                               tb_shift):
    """Integer logits (ties everywhere), a NEG_INF run across or up to the
    shard edge `edge`, and with timestamps timestamp_begin on a shard
    edge +- 3 and per-row bounds that mask whole shards."""
    g = torch.Generator().manual_seed(seed)
    b, d = 6, 8
    h = torch.randint(-1, 2, (b, d), generator=g).float()
    table_t = torch.randint(-2, 3, (d, V_PAD), generator=g).float()
    lo, hi = sorted((edge, edge + masked))
    add = lp.suppress_vector(V_PAD, tuple(range(lo, hi)), vocab=V)
    seen = (torch.rand(b, V_PAD, generator=g) < 0.1).to(torch.int8)
    ban = (torch.rand(b, V_PAD, generator=g) < 0.05).to(torch.int8)
    kw = {"penalty": 1.15}
    if ts:
        tb = edge + tb_shift
        big = torch.iinfo(torch.int32).max
        tlo = torch.tensor([0, 0, tb, 0, 0, 0], dtype=torch.int32)
        thi = torch.tensor([tb, tb + 100, tb, big, tb + 2, tb],
                           dtype=torch.int32)
        tcap = torch.tensor([big, big, tb + 10, big, big, tb - 1],
                            dtype=torch.int32)
        kw.update(ts_bounds=(tlo, thi, tcap), timestamp_begin=tb)
    want = dl.fused_greedy_step_reference(h, table_t, add, seen=seen,
                                          ban=ban, **kw)
    ok = _decidable(h, table_t, add, seen, ban, kw)
    for t in (1, 2, 4):
        parts = _shard_partials(h, table_t, add, seen, ban, kw, t)
        assert parts.shape == (t, b, 6 if ts else 2)
        got = dl.merge_partials(parts)
        assert torch.equal(got[ok], want[ok]), (t, got, want)


def test_partials_of_an_all_masked_shard():
    """A shard whose ids are all NEG_INF reports (NEG_INF, its lowest id),
    as the unsharded kernel's argmax would see them; a shard with no
    timestamp id reports an empty timestamp region."""
    d, t = 8, 4
    w = V_PAD // t
    h = torch.ones(2, d)
    table_t = torch.zeros(d, V_PAD)
    add = torch.full((V_PAD,), lp.NEG_INF)
    parts = _shard_partials(h, table_t, add, None, None, {}, t)
    assert parts[:, :, 0].eq(lp.NEG_INF).all()
    assert parts[:, 0, 1].tolist() == [r * w for r in range(t)]
    assert dl.merge_partials(parts).tolist() == [0, 0]
    kw = {"ts_bounds": tuple(torch.zeros(2, dtype=torch.int32)
                             for _ in range(3)), "timestamp_begin": 900}
    kw["ts_bounds"] = (kw["ts_bounds"][0], kw["ts_bounds"][1],
                       torch.full((2,), 2 ** 31 - 1, dtype=torch.int32))
    parts = _shard_partials(h, table_t, add, None, None, kw, t)
    assert parts[0, 0, 2] == float("-inf") and parts[0, 0, 3] == dl.NO_ID
    assert torch.equal(dl.merge_partials(parts),
                       dl.fused_greedy_step_reference(h, table_t, add, **kw))


def test_vocab_offset_needs_partials():
    h = torch.zeros(1, 8)
    with pytest.raises(ValueError, match="partials"):
        dl.fused_greedy_step(h, torch.zeros(8, 256), torch.zeros(256),
                             vocab_offset=256)


def test_dryrun_multichip_four_processes():
    """entry.dryrun_multichip(4): a data:2 x model:2 mesh, one TP train
    step held to one process, the TP decode token-equal to one process."""
    from audio_transformers_tpu_torch.entry import dryrun_multichip
    outs = dryrun_multichip(4, timeout=150)
    for rank, out in enumerate(outs):
        assert "mesh=data:2 x model:2" in out
        assert f"rank {rank} loss=" in out
        assert "params over model:2, token-equal to one process" in out
