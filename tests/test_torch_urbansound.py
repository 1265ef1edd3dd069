"""The port's UrbanSound classifier against the JAX package, on the CPU, at
small widths, both packages starting from the port's seeded weights (the
JAX side takes them through `core.params.to_jax_params`, whose round
trip is exact; the CLI test gives the JAX CLI the port CLI's init).
Everything runs in float32 with dropout 0 unless a test says otherwise;
SpecAugment runs on the reference's own masks (drawn by JAX
`spec_augment` from its key and fed to the port's `apply_spec_augment`
through a patched `spec_augment_masks`), since no torch generator
reproduces jax.random.

Tolerances:
  apply logits (train and eval, batch and     2e-5 abs + 2e-5 rel (f32
  group norm, with and without proj)          sums in another order)
  apply's new BatchNorm state                 1e-6 abs
  batch_norm, group_norm                      1e-6 abs in float32; one
                                              bf16 ulp (2^-7 rel) in bf16
  sinusoidal_embeddings_ref                   2e-4 abs (float32 args up
                                              to 1000 rad: an ulp of the
                                              frequency moves sin by ~1e-4)
  apply_spec_augment on JAX's masks           1e-6 abs (the fill is a
                                              float32 mean)
  the train step's gradients (jax.grad      1e-4 * max(1, max |g|) per
  inside JAX's step)                          leaf; a leaf whose JAX
                                              gradient is rounding (under
                                              1e-6 of the tree's largest)
                                              is rounding in the port too
  one Adam step                               params 1e-6 abs where the
                                              JAX gradient exceeds its
                                              tolerance, else 2 lr; BN
                                              state 1e-6 abs
  3 train steps, evaluate                     losses 1e-4 rel, accuracies
                                              equal
  the whisper step with SpecAugment           as the classifier's step
  export_classifier                           bit for bit
  the train_classifier CLI's metrics.jsonl    1e-3 rel
The port against itself: a resumed run equals an uninterrupted one bit
for bit, with dropout and SpecAugment drawing from its generators.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from audio_transformers_tpu.core.config import (EmotionWhisperConfig,
                                                MelConfig, OptimizerConfig,
                                                TrainConfig, UrbanSoundConfig,
                                                WhisperConfig)
from audio_transformers_tpu.data.synthetic import (SyntheticClassification,
                                                   SyntheticSeq2Seq)
from audio_transformers_tpu.models import urbansound as jus
from audio_transformers_tpu.ops import nn as jnn
from audio_transformers_tpu.ops import specaugment as jsa
from audio_transformers_tpu.parallel.mesh import build_mesh
from audio_transformers_tpu.train import classifier as jtc
from audio_transformers_tpu.train import optim as joptim
from audio_transformers_tpu.train import whisper_emotion as jtw
from audio_transformers_tpu_torch.core import params as cp
from audio_transformers_tpu_torch.models.urbansound import model as pus
from audio_transformers_tpu_torch.ops import nn
from audio_transformers_tpu_torch.ops import specaugment as sa
from audio_transformers_tpu_torch.train import classifier as tc
from audio_transformers_tpu_torch.train import common as tcommon
from audio_transformers_tpu_torch.train import optim
from audio_transformers_tpu_torch.train import whisper_emotion as tw

SMALL = UrbanSoundConfig(n_mels=64, num_classes=10, conv_dim=32,
                         encoder_dim=32, num_encoder_blocks=2, num_heads=4,
                         dropout=0.0, cnn_dims=(32, 48))
TINY = UrbanSoundConfig(n_mels=64, num_classes=4, conv_dim=24,
                        encoder_dim=24, num_encoder_blocks=1, num_heads=2,
                        dropout=0.0, cnn_dims=(24,))
MEL = MelConfig.urbansound()


@pytest.fixture(autouse=True)
def _one_thread():
    """The tests' tensors are tiny: one intra-op thread runs them as fast
    as many alone, and far faster beside other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x)


def _port(tree):
    return cp.from_jax_params(jax.device_get(tree))


def _by_path(tree):
    return dict(cp.leaves_with_path(tree))


def _jax_init(cfg, seed=1):
    """(params, state) in the JAX layout: the port's seeded init."""
    return tuple(cp.to_jax_params(t) for t in
                 pus.init(cfg, torch.Generator().manual_seed(seed)))


def jax_masks(key, b, t, f):
    """The (time, frequency) masks JAX `spec_augment` draws from `key`,
    read off its output on ones (no band covers a whole axis, so a frame
    or bin is masked exactly where every cell across it is)."""
    full = np.asarray(jsa.spec_augment(key, jnp.ones((b, t, f)),
                                       mask_value=0.0)) == 0
    return torch.from_numpy(full.all(axis=2)), torch.from_numpy(
        full.all(axis=1))


class JaxMasks:
    """Stands in for `spec_augment_masks`: the masks of the given JAX
    keys, one key per call, in order."""

    def __init__(self, keys):
        self.keys = list(keys)

    def __call__(self, generator, b, t, f):
        return jax_masks(self.keys.pop(0), b, t, f)


def _batch(n, seed=1, duration=1.0, num_classes=4):
    ds = SyntheticClassification(num_samples=n, num_classes=num_classes,
                                 duration=duration, seed=seed)
    return next(ds.batcher(n).train_epochs(epoch=0))


# --------------------------------------------------------------------------
# nn primitives
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_matches_jax(dtype, training):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 9, 6)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(6).astype(np.float32),
         "bias": rng.standard_normal(6).astype(np.float32)}
    s = {"mean": rng.standard_normal(6).astype(np.float32),
         "var": rng.uniform(0.5, 2, 6).astype(np.float32)}
    jy, js = jnn.batch_norm(p, s, jnp.asarray(x, dtype), training=training)
    ty, ts = nn.batch_norm(cp.from_jax_params(p), cp.from_jax_params(s),
                           torch.from_numpy(x).to(getattr(torch, dtype)),
                           training=training)
    assert ty.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7 * np.abs(_np(jy)).max()
    np.testing.assert_allclose(_np(ty), _np(jy).astype(np.float32),
                               atol=tol)
    for k in ("mean", "var"):
        assert ts[k].dtype == torch.float32 and not ts[k].requires_grad
        np.testing.assert_allclose(_np(ts[k]), _np(js[k]), atol=1e-6)


def test_batch_norm_uses_the_unbiased_running_var():
    x = torch.randn((3, 5, 2), generator=torch.Generator().manual_seed(0))
    s = {"mean": torch.zeros(2), "var": torch.ones(2)}
    _, ns = nn.batch_norm({"scale": torch.ones(2), "bias": torch.zeros(2)},
                          s, x, training=True)
    flat = x.reshape(-1, 2)
    torch.testing.assert_close(ns["var"], 0.9 + 0.1 * flat.var(dim=0),
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(ns["mean"], 0.1 * flat.mean(dim=0),
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("c,groups", [(32, 32), (48, 16), (24, 8)])
def test_group_norm_matches_jax(c, groups):
    rng = np.random.default_rng(c)
    x = (rng.standard_normal((3, 7, c)) * 2).astype(np.float32)
    p = {"scale": rng.standard_normal(c).astype(np.float32),
         "bias": rng.standard_normal(c).astype(np.float32)}
    want = jnn.group_norm(p, jnp.asarray(x), num_groups=groups)
    got = nn.group_norm(cp.from_jax_params(p), torch.from_numpy(x),
                        num_groups=groups)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6)


@pytest.mark.parametrize("length,dim", [(1000, 256), (50, 32), (7, 6)])
def test_sinusoidal_embeddings_ref_match_jax(length, dim):
    got = nn.sinusoidal_embeddings_ref(length, dim)
    want = jnn.sinusoidal_embeddings_ref(length, dim)
    assert got.shape == (length, dim) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-4)
    # the denominator is `half`, not whisper's `half - 1`
    assert not torch.allclose(got, nn.sinusoidal_embeddings(length, dim))


def test_dropout_keeps_rate_scales_and_replays():
    x = torch.ones(200_000)
    for rate in (0.1, 0.5):
        g = torch.Generator().manual_seed(3)
        y = nn.dropout(g, x, rate, training=True)
        kept = y != 0
        # a binomial draw: five standard deviations
        sd = (rate * (1 - rate) / x.numel()) ** 0.5
        assert abs(kept.float().mean().item() - (1 - rate)) < 5 * sd
        assert torch.all(y[kept] == 1.0 / (1.0 - rate))
        again = nn.dropout(torch.Generator().manual_seed(3), x, rate,
                           training=True)
        assert torch.equal(y, again)
        other = nn.dropout(torch.Generator().manual_seed(4), x, rate,
                           training=True)
        assert not torch.equal(y, other)
    xb = x[:64].to(torch.bfloat16)
    assert nn.dropout(torch.Generator().manual_seed(0), xb, 0.5,
                      training=True).dtype == torch.bfloat16
    g = torch.Generator().manual_seed(0)
    for args, kw in (((g, x, 0.5), {"training": False}),
                     ((g, x, 0.0), {"training": True}),
                     ((None, x, 0.5), {"training": True})):
        assert nn.dropout(*args, **kw) is x


def test_dropout_matches_jax_statistics():
    """The two packages draw different masks; both keep 1 - rate of the
    elements and scale them by 1 / (1 - rate)."""
    x = np.ones(100_000, np.float32)
    want = np.asarray(jnn.dropout(jax.random.PRNGKey(0), jnp.asarray(x), 0.2,
                                  training=True))
    got = _np(nn.dropout(torch.Generator().manual_seed(0),
                         torch.from_numpy(x), 0.2, training=True))
    assert set(np.unique(got)) == set(np.unique(want))
    assert abs((got != 0).mean() - (want != 0).mean()) < 0.01


def test_attention_dropout():
    rng = np.random.default_rng(0)
    jp = jax.device_get(jnn.mha_init(jax.random.PRNGKey(0), 16, 4))
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    p, xt = cp.from_jax_params(jp), torch.from_numpy(x)
    plain = nn.multihead_attention(p, xt, xt, num_heads=4)
    np.testing.assert_allclose(
        _np(plain), _np(jnn.multihead_attention(jp, x, x, num_heads=4)),
        atol=1e-5)

    def dropped(seed, rate=0.3):
        return nn.multihead_attention(
            p, xt, xt, num_heads=4, dropout_rate=rate,
            generator=torch.Generator().manual_seed(seed))

    assert torch.equal(dropped(1), dropped(1))
    assert not torch.allclose(dropped(1), plain)
    assert torch.equal(dropped(1, rate=0.0), plain)
    with pytest.raises(NotImplementedError):
        nn.multihead_attention(p, xt, xt, num_heads=4, impl="flash",
                               dropout_rate=0.3,
                               generator=torch.Generator())


# --------------------------------------------------------------------------
# SpecAugment
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_spec_augment_on_jax_masks(seed):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((3, 100, 64)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = jsa.spec_augment(key, jnp.asarray(mel))
    tmask, fmask = jax_masks(key, 3, 100, 64)
    assert tmask.any() and fmask.any()
    got = sa.apply_spec_augment(torch.from_numpy(mel), tmask, fmask)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6)


def test_spec_augment_masks_bounds_and_replay():
    def draw(seed):
        return sa.spec_augment_masks(torch.Generator().manual_seed(seed),
                                     64, 173, 64)

    tmask, fmask = draw(5)
    assert tmask.shape == (64, 173) and fmask.shape == (64, 64)
    assert tmask.dtype == fmask.dtype == torch.bool
    # two bands per row: at most 2 * max(1, int(173 * 0.05)) frames and
    # 2 * 8 bins, and some row masks something on each axis
    assert tmask.sum(dim=1).max() <= 16 and fmask.sum(dim=1).max() <= 16
    assert tmask.any() and fmask.any()
    assert all(torch.equal(a, b) for a, b in zip(draw(5), (tmask, fmask)))
    assert not torch.equal(draw(6)[0], tmask)


# --------------------------------------------------------------------------
# parameters and the model
# --------------------------------------------------------------------------


def _cfgs():
    # proj: a wider conv front end than the encoder
    return [SMALL, SMALL.replace(conv_dim=40),
            SMALL.replace(norm_type="group"),
            SMALL.replace(norm_type="group", conv_dim=40)]


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("cfg", _cfgs(), ids=["batch", "batch_proj", "group",
                                              "group_proj"])
def test_apply_matches_jax(cfg, training):
    jp, js = _jax_init(cfg)
    assert ("proj" in jp) == (cfg.conv_dim != cfg.encoder_dim)
    mel = np.random.default_rng(0).standard_normal((3, 173, 64)) \
        .astype(np.float32)
    jl, jns = jus.apply(jp, js, cfg, jnp.asarray(mel), training=training)
    tl, tns = pus.apply(_port(jp), _port(js), cfg, torch.from_numpy(mel),
                        training=training)
    assert tl.shape == (3, 10) and tl.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=2e-5, atol=2e-5)
    want = _by_path(jax.device_get(jns))
    got = _by_path(cp.to_jax_params(tns))
    assert set(got) == set(want)
    for path, a in got.items():
        np.testing.assert_allclose(a, want[path], atol=1e-6,
                                   err_msg=str(path))
    if not training or cfg.norm_type == "group":
        assert all(np.array_equal(a, _by_path(js)[p])
                   for p, a in got.items())


def test_apply_dropout_replays_from_its_generator():
    cfg = SMALL.replace(dropout=0.2)
    p, s = pus.init(cfg, torch.Generator().manual_seed(0))
    mel = torch.randn((2, 60, 64), generator=torch.Generator().manual_seed(1))

    def run(seed, training=True):
        g = None if seed is None else torch.Generator().manual_seed(seed)
        return pus.apply(p, s, cfg, mel, training=training, generator=g)[0]

    assert torch.equal(run(7), run(7))
    assert not torch.allclose(run(7), run(8))
    assert not torch.allclose(run(7), run(None))
    assert torch.equal(run(7, training=False), run(None, training=False))


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_param_bridge_round_trip_is_exact(norm):
    jp, js = _jax_init(SMALL.replace(conv_dim=40, norm_type=norm))
    for tree in (jp, js):
        back = _by_path(cp.to_jax_params(cp.from_jax_params(tree)))
        want = _by_path(tree)
        assert set(back) == set(want)
        for path, a in back.items():
            assert a.dtype == want[path].dtype
            assert np.array_equal(a, want[path]), path
    pp, ps = _port(jp), _port(js)
    assert pp["conv1"]["w"].shape == (40, 64, 3)       # (Cout, Cin, K)
    assert pp["cnn"][1]["conv"]["w"].shape == (48, 32, 3)
    assert pp["proj"]["w"].shape == (32, 40)            # (out, in)
    assert ps["pos"].shape == (1000, 32)
    if norm == "batch":
        assert ps["bn1"]["mean"].shape == (40,)
        assert ps["cnn"][1]["var"].shape == (48,)
    else:
        assert ps["bn1"] == {} and ps["cnn"] == [{}, {}]


def _uniform_bound(w):
    """torch's default init bound of a linear or conv weight (out, in[,
    K]): 1 / sqrt(fan_in)."""
    fan_in = w.shape[1] * (w.shape[2] if w.dim() == 3 else 1)
    return 1.0 / fan_in ** 0.5


def test_init_urbansound_matches_the_reference_at_full_width():
    cfg = UrbanSoundConfig()
    params, state = cp.init_urbansound(cfg, torch.Generator().manual_seed(0))
    # shapes only: the reference's tree, traced, not computed
    jshapes = jax.eval_shape(lambda: jus.init(jax.random.PRNGKey(0), cfg))
    for got, want in zip((params, state), jshapes):
        want = _by_path(want)
        got = _by_path(cp.to_jax_params(got))
        assert set(got) == set(want)
        for path, a in got.items():
            assert a.shape == want[path].shape, path
            assert a.dtype == np.float32, path
    n = sum(t.numel() for _, t in cp.leaves_with_path(params))
    assert 3_000_000 < n < 5_000_000, n
    assert n == sum(int(np.prod(x.shape)) for x in
                    jax.tree_util.tree_leaves(jshapes[0]))
    for path, t in cp.leaves_with_path(params):
        if path[-1] in ("scale", "bias"):
            want = 1.0 if path[-1] == "scale" else 0.0
            assert torch.all(t == want), path
            continue
        # U(-bound, bound) with torch's bound 1 / sqrt(fan_in); biases
        # share their weight's bound
        w = _by_path(params)[path[:-1] + ("w",)]
        bound = _uniform_bound(w)
        assert t.abs().max() <= bound, path
        if t.numel() >= 20_000:
            std = t.std().item()
            assert abs(std - bound / 3 ** 0.5) < 0.02 * bound, path
            assert abs(t.mean().item()) < 0.02 * bound, path
    for s in (state["bn1"], state["bn2"], *state["cnn"]):
        assert torch.all(s["mean"] == 0) and torch.all(s["var"] == 1)
    torch.testing.assert_close(
        state["pos"], nn.sinusoidal_embeddings_ref(1000, 256), rtol=0,
        atol=0)
    again, _ = cp.init_urbansound(cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(cp.leaves_with_path(params), cp.leaves_with_path(again)))
    with pytest.raises(ValueError, match="norm_type"):
        cp.init_urbansound(cfg.replace(norm_type="layer"), torch.Generator())


# --------------------------------------------------------------------------
# the train step, evaluation, the trainer
# --------------------------------------------------------------------------


def _tcfg(**kw):
    base = dict(batch_size=8, num_epochs=1, compute_dtype="float32",
                optimizer=OptimizerConfig(name="adam", learning_rate=1e-3,
                                          schedule="reduce_on_plateau"),
                mesh_shape=(("data", 1),))
    return TrainConfig(**{**base, **kw})


def _port_steps(cfg, tcfg, jp, js):
    params = cp.set_trainable(_port(jp), frozen=())
    opt = optim.build_optimizer(tcfg.optimizer, params)
    steps = tc.make_steps(cfg, MEL, tcfg, opt)
    return params, _port(js), steps


def _to_port_batch(batch):
    return tcommon.batch_to_device(batch, "cpu")


def _capture_grads():
    """An optax transformation that passes the gradients on unchanged and
    keeps them as its state: chained before Adam, the JAX step's own
    gradients come back in opt_state[0]."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))


@pytest.fixture(scope="module")
def jax_run():
    """3 JAX train steps of TINY (SpecAugment on keys 10-12, Adam at the
    trainer's lr 1e-3) from the port's seeded weights, each step's
    gradients, params and state kept, and the JAX eval step: one compile
    for the tests below."""
    tcfg = _tcfg(spec_augment=True)
    jp, js = _jax_init(TINY, seed=0)
    tx = optax.chain(_capture_grads(),
                     joptim.build_optimizer(tcfg.optimizer))
    jtrain, jeval = jtc.make_steps(TINY, MEL, tcfg, tx)
    batch = _batch(8)
    keys = [jax.random.PRNGKey(10 + i) for i in range(3)]
    jparams, jstate = jax.tree.map(jnp.asarray, (jp, js))
    opt_state = tx.init(jparams)
    steps = []
    for k in keys:
        jparams, jstate, opt_state, m = jtrain(
            jparams, jstate, opt_state,
            {k2: jnp.asarray(v) for k2, v in batch.items()}, k)
        steps.append({"metrics": {n: float(v) for n, v in m.items()},
                      **{name: _by_path(cp.from_jax_params(
                          jax.device_get(t))) for name, t in
                         (("grads", opt_state[0]), ("params", jparams),
                          ("state", jstate))}})
    return {"tcfg": tcfg, "init": _jax_init(TINY, seed=0), "batch": batch,
            "keys": keys,
            "steps": steps, "eval": jeval, "final": (jparams, jstate)}


def _port_run(monkeypatch, run):
    """The port's steps from the JAX run's weights, its SpecAugment on the
    JAX step's masks (the step splits its key and masks with the second
    half)."""
    monkeypatch.setattr(sa, "spec_augment_masks",
                        JaxMasks(jax.random.split(k)[1] for k in run["keys"]))
    return _port_steps(TINY, run["tcfg"], *run["init"])


def rounding_level(grads):
    """The gradient size below which a leaf's gradient is rounding: 1e-6
    of the largest gradient of the tree. The conv biases before each
    BatchNorm and the attention's key bias have an exact gradient of 0
    (BatchNorm and softmax cancel a constant shift); float32 sums leave
    some 1e-8 of it, which no two orders of summation share."""
    return 1e-6 * max(float(np.abs(_np(g)).max()) for g in grads.values())


def test_train_step_gradients_match_jax(monkeypatch, jax_run):
    """The port's first step against jax.grad inside the JAX step: every
    leaf's gradient within 1e-4 * max(1, max |g|); a leaf whose JAX
    gradient is rounding (`rounding_level`) is rounding in the port too.
    After that one Adam step, where the JAX gradient exceeds the leaf's
    tolerance (the comparison above then fixes its sign) the parameters
    agree within 1e-6, elsewhere within 2 lr (Adam moves an element by
    about lr whatever its gradient's size); the BatchNorm running stats
    within 1e-6; pos is untouched."""
    lr = jax_run["tcfg"].optimizer.learning_rate
    want = jax_run["steps"][0]
    params, state, (train_step, _) = _port_run(monkeypatch, jax_run)
    state, _ = train_step(params, state, _to_port_batch(jax_run["batch"]),
                          torch.Generator())
    floor = rounding_level(want["grads"])
    rounding = []
    for path, t in cp.leaves_with_path(params):
        g, w = _np(t.grad), _np(want["grads"][path])
        if np.abs(w).max() <= floor:
            rounding.append(path)
            assert np.abs(g).max() <= floor, path
            assert np.abs(_np(t) - _np(want["params"][path])).max() \
                <= 2 * lr, path
            continue
        tol = 1e-4 * max(1.0, np.abs(w).max())
        assert np.abs(g - w).max() <= tol, (path, np.abs(g - w).max())
        moved = np.abs(_np(t) - _np(want["params"][path]))
        sure = np.abs(w) > tol
        assert moved[sure].max() <= 1e-6, path
        assert moved.max() <= 2 * lr, path
    # the rule picks the leaves that BatchNorm or softmax make constant
    assert sorted(rounding, key=str) == sorted(
        [("conv1", "b"), ("conv2", "b"), ("cnn", 0, "conv", "b"),
         ("blocks", 0, "attn", "k", "b")], key=str)
    for path, t in cp.leaves_with_path(state):
        np.testing.assert_allclose(_np(t), _np(want["state"][path]),
                                   rtol=0, atol=1e-6, err_msg=str(path))


def test_train_steps_and_evaluate_match_jax(monkeypatch, jax_run):
    """3 train steps with SpecAugment on JAX's masks: losses within 1e-4
    relative, accuracies equal (train-mode BatchNorm cancels the conv
    biases' drift). Then `evaluate` of 11 samples in batches of 8 (the
    last batch wrap-padded: it counts 3) on JAX's weights after its 3
    steps, against JAX's `evaluate` of them: eval-mode BatchNorm
    subtracts running means that took in those biases at each step, so
    the two runs' own weights would differ by their drift."""
    params, state, (train_step, eval_step) = _port_run(monkeypatch, jax_run)
    batch = _to_port_batch(jax_run["batch"])
    for want in jax_run["steps"]:
        state, m = train_step(params, state, batch, torch.Generator())
        np.testing.assert_allclose(m["loss"].item(),
                                   want["metrics"]["loss"], rtol=1e-4)
        assert m["accuracy"].item() == want["metrics"]["accuracy"]

    ds = SyntheticClassification(num_samples=11, num_classes=4, duration=1.0)
    mesh = build_mesh((("data", 1),))
    jval = jtc.evaluate(jax_run["eval"], *jax_run["final"], ds.batcher(8),
                        mesh)
    params, state = (_port(t) for t in jax_run["final"])
    pval = tc.evaluate(eval_step, params, state, ds.batcher(8), "cpu")
    np.testing.assert_allclose(pval["loss"], jval["loss"], rtol=1e-4)
    assert pval["accuracy"] == jval["accuracy"]
    counts = [eval_step(params, state, _to_port_batch(b))["count"].item()
              for b in ds.batcher(8).eval_batches()]
    assert counts == [8.0, 3.0]


def test_plateau_scheduler_semantics():
    sched = optim.PlateauScheduler(OptimizerConfig(
        learning_rate=1.0, plateau_patience=2, plateau_factor=0.1))
    lrs = [sched.step(v) for v in [1.0, 0.9, 0.95, 0.95, 0.95, 0.8]]
    assert lrs == [1.0, 1.0, 1.0, 1.0, 0.1, 0.1]


def test_overfit_one_batch():
    tcfg = _tcfg(optimizer=OptimizerConfig(name="adam", learning_rate=1e-3,
                                           schedule="constant"))
    params, state = pus.init(SMALL, torch.Generator().manual_seed(0))
    params = cp.set_trainable(params, frozen=())
    opt = optim.build_optimizer(tcfg.optimizer, params)
    train_step, _ = tc.make_steps(SMALL, MEL, tcfg, opt)
    batch = _to_port_batch(_batch(8))
    losses = []
    for _ in range(30):
        state, m = train_step(params, state, batch)
        losses.append(m["loss"].item())
    assert losses[-1] < 0.3 * losses[0], losses
    assert losses[-1] < 0.5, losses


def _data():
    return (SyntheticClassification(num_samples=16, num_classes=4,
                                    duration=1.0, seed=1),
            SyntheticClassification(num_samples=8, num_classes=4,
                                    duration=1.0, seed=2))


def _run(tmp, epochs, cfg=TINY, **kw):
    ds_t, ds_v = _data()
    tcfg = _tcfg(num_epochs=epochs, checkpoint_dir=os.path.join(tmp, "ckpt"),
                 **kw)
    return tc.train_classifier(cfg, MEL, tcfg, ds_t.batcher(8),
                               ds_v.batcher(8), device="cpu")


def _timeless(history):
    return [{k: v for k, v in row.items()
             if k not in ("clips_per_sec", "data_wait_s")} for row in history]


def test_resume_equals_an_uninterrupted_run(tmp_path):
    """Dropout and SpecAugment on: the resumed run replays the draws."""
    cfg = TINY.replace(dropout=0.1)
    kw = dict(spec_augment=True, optimizer=OptimizerConfig(
        name="adam", learning_rate=1e-3, schedule="reduce_on_plateau",
        plateau_patience=0, plateau_factor=0.5))
    _run(str(tmp_path / "a"), 2, cfg, **kw)
    resumed = _run(str(tmp_path / "a"), 4, cfg, **kw)
    straight = _run(str(tmp_path / "b"), 4, cfg, **kw)
    assert [r["epoch"] for r in resumed["history"]] == [3, 4]
    assert _timeless(resumed["history"]) == _timeless(straight["history"][2:])
    assert resumed["best_val_accuracy"] == straight["best_val_accuracy"]
    for key in ("params", "state", "best_params", "best_state"):
        for (path, a), (_, b) in zip(cp.leaves_with_path(resumed[key]),
                                     cp.leaves_with_path(straight[key])):
            assert torch.equal(a.cpu(), b.cpu()), (key, path)
    assert resumed["optimizer"].learning_rate \
        == straight["optimizer"].learning_rate
    done = _run(str(tmp_path / "a"), 4, cfg, **kw)   # nothing left to train
    assert done["history"] == []
    for (_, a), (_, b) in zip(cp.leaves_with_path(done["best_params"]),
                              cp.leaves_with_path(straight["best_params"])):
        assert torch.equal(a, b)


def test_returns_the_best_epoch_tree(tmp_path):
    from audio_transformers_tpu_torch.core.checkpoint import Checkpointer
    out = _run(str(tmp_path), 3)
    assert out["best_val_accuracy"] == max(h["val/accuracy"]
                                           for h in out["history"])
    tcfg = _tcfg()
    opt = optim.build_optimizer(tcfg.optimizer, cp.set_trainable(
        pus.init(TINY, torch.Generator())[0], frozen=()))
    _, eval_step = tc.make_steps(TINY, MEL, tcfg, opt)
    val = tc.evaluate(eval_step, out["best_params"], out["best_state"],
                      _data()[1].batcher(8), "cpu")
    assert val["accuracy"] == out["best_val_accuracy"]
    ck = Checkpointer(os.path.join(str(tmp_path), "ckpt"), best_mode="max")
    tree, meta, _ = ck.restore(step=ck.best_step())
    assert meta["val_accuracy"] == out["best_val_accuracy"]
    for key in ("params", "state"):
        for (p, a), (_, b) in zip(cp.leaves_with_path(tree[key]),
                                  cp.leaves_with_path(out[f"best_{key}"])):
            assert torch.equal(a, b), p
    resume = Checkpointer(os.path.join(str(tmp_path), "ckpt-resume"))
    assert resume.restore()[1]["epoch"] == 3


def test_pos_reaches_neither_the_optimizer_nor_the_gradient(tmp_path):
    out = _run(str(tmp_path), 1)
    pos = out["state"]["pos"]
    assert not pos.requires_grad and pos.grad is None
    assert torch.equal(pos, nn.sinusoidal_embeddings_ref(1000, 24))
    opt_ids = {id(t) for t in out["optimizer"].params}
    leaves = [t for _, t in cp.leaves_with_path(out["params"])]
    assert opt_ids == {id(t) for t in leaves} and id(pos) not in opt_ids
    assert all(t.grad is not None for t in leaves)


def test_trainer_refuses_more_than_one_device():
    """A mesh of two devices in a process that joined no group of two is
    refused, as the reference refuses a mesh larger than its devices (a
    two-process group trains: tests/test_torch_parallel.py)."""
    ds_t, ds_v = _data()
    with pytest.raises(ValueError, match="needs 2 processes, have 1"):
        tc.train_classifier(TINY, MEL, _tcfg(mesh_shape=(("data", 2),)),
                            ds_t.batcher(8), ds_v.batcher(8), device="cpu")


# --------------------------------------------------------------------------
# the whisper trainer's SpecAugment
# --------------------------------------------------------------------------


# the test config at one layer each way: the JAX step compiles faster
WHISPER = EmotionWhisperConfig(
    whisper=WhisperConfig.test().replace(encoder_layers=1, decoder_layers=1),
    num_emotion_classes=4)


def _seq2seq(n, seed):
    w, mel_cfg = WHISPER.whisper, MelConfig.whisper()
    dur = 2 * w.max_source_positions * mel_cfg.hop_length \
        / mel_cfg.sample_rate
    return SyntheticSeq2Seq(num_samples=n, num_classes=4,
                            vocab_size=w.vocab_size, max_label_len=8,
                            duration=dur, seed=seed,
                            bos_id=w.decoder_start_token_id,
                            eos_id=w.eos_token_id, pad_id=w.pad_token_id)


def test_whisper_step_with_spec_augment_matches_jax(monkeypatch):
    """One step on JAX's masks: the loss within 1e-4 relative, the
    gradients and the AdamW step held as the classifier's are (frozen
    leaves: no gradient, unchanged)."""
    lr = 1e-3
    tcfg = TrainConfig(batch_size=4, compute_dtype="float32",
                       spec_augment=True,
                       optimizer=OptimizerConfig(name="adamw",
                                                 learning_rate=lr,
                                                 weight_decay=0.01))
    jparams = cp.to_jax_params(cp.init(WHISPER,
                                       torch.Generator().manual_seed(0)))
    batch = next(_seq2seq(4, 1).batcher(4).train_epochs(epoch=0))
    tx = optax.chain(_capture_grads(), joptim.build_optimizer(
        tcfg.optimizer, total_steps=10,
        decay_mask=joptim.frozen_leaf_decay_mask))
    jstep, _ = jtw.make_steps(WHISPER, MelConfig.whisper(), tcfg, tx)
    key = jax.random.PRNGKey(5)
    jp = jax.tree.map(jnp.asarray, jparams)
    jp, opt_state, m = jstep(jp, tx.init(jp),
                             {n: jnp.asarray(v) for n, v in batch.items()},
                             key)
    jgrads = _by_path(cp.from_jax_params(jax.device_get(opt_state[0])))
    want = _by_path(cp.from_jax_params(jax.device_get(jp)))

    # the whisper step masks with its key as it is
    monkeypatch.setattr(sa, "spec_augment_masks", JaxMasks([key]))
    params = cp.set_trainable(cp.from_jax_params(jparams))
    opt = optim.build_optimizer(tcfg.optimizer, params, total_steps=10,
                                decay_mask=optim.frozen_leaf_decay_mask)
    step, _ = tw.make_steps(WHISPER, MelConfig.whisper(), tcfg, opt, "cpu")
    loss = step(params, tcommon.batch_to_device(batch, "cpu"),
                torch.Generator())["loss"].item()
    np.testing.assert_allclose(loss, float(m["loss"]), rtol=1e-4)
    floor = rounding_level(jgrads)
    for path, t in cp.leaves_with_path(params):
        w = _np(jgrads[path])
        moved = np.abs(_np(t) - _np(want[path]))
        if path in cp.FROZEN:
            assert t.grad is None and not w.any() and not moved.any()
            continue
        g = _np(t.grad)
        if np.abs(w).max() <= floor:
            assert np.abs(g).max() <= floor, path
            assert moved.max() <= 2 * lr, path
            continue
        tol = 1e-4 * max(1.0, np.abs(w).max())
        assert np.abs(g - w).max() <= tol, (path, np.abs(g - w).max())
        assert moved[np.abs(w) > tol].max() <= 1e-6, path
        assert moved.max() <= 2 * lr, path


def test_whisper_trainer_draws_masks_per_step_and_replays(monkeypatch):
    calls = []
    draw = sa.spec_augment_masks

    def counting(generator, *a, **kw):
        calls.append(generator.initial_seed())
        return draw(generator, *a, **kw)

    monkeypatch.setattr(sa, "spec_augment_masks", counting)
    tcfg = TrainConfig(batch_size=4, num_epochs=2, compute_dtype="float32",
                       spec_augment=True,
                       optimizer=OptimizerConfig(name="adamw",
                                                 learning_rate=1e-3))
    ds_t, ds_v = _seq2seq(8, 1), _seq2seq(4, 2)
    params = cp.init(WHISPER, torch.Generator().manual_seed(0))
    runs = [tw.train_whisper_emotion(WHISPER, MelConfig.whisper(), tcfg,
                                     ds_t.batcher(4), ds_v.batcher(4),
                                     device="cpu", init_params=params)
            for _ in range(2)]
    # 2 steps an epoch, one generator an epoch (seed + 1, epoch)
    assert calls[:4] == [calls[0], calls[0], calls[2], calls[2]]
    assert calls[0] == tcommon.epoch_generator(43, 0, "cpu").initial_seed()
    assert calls[2] != calls[0] and calls[:4] == calls[4:]
    assert _timeless(runs[0]["history"]) == _timeless(runs[1]["history"])


def test_trainers_step_without_a_generator_masks_nothing(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("masks drawn without a generator")

    monkeypatch.setattr(sa, "spec_augment_masks", refuse)
    params, state = pus.init(TINY, torch.Generator().manual_seed(0))
    params = cp.set_trainable(params, frozen=())
    tcfg = _tcfg(spec_augment=True)
    opt = optim.build_optimizer(tcfg.optimizer, params)
    train_step, eval_step = tc.make_steps(TINY, MEL, tcfg, opt)
    batch = _to_port_batch(_batch(8))
    train_step(params, state, batch)
    eval_step(params, state, batch)


# --------------------------------------------------------------------------
# export and the CLI
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cfg", _cfgs(), ids=["batch", "batch_proj", "group",
                                              "group_proj"])
def test_export_classifier_matches_jax(tmp_path, cfg):
    from safetensors.numpy import load_file

    from audio_transformers_tpu.utils.hub import export_classifier as jexp
    from audio_transformers_tpu_torch.utils.hub import export_classifier
    jp, js = _jax_init(cfg)
    # running statistics off their init
    rng = np.random.default_rng(4)
    js = jax.tree_util.tree_map_with_path(
        lambda path, a: a if path[-1].key == "pos" else
        a + rng.uniform(0.1, 1.0, a.shape).astype(np.float32), js)
    want = load_file(jexp(jp, js, str(tmp_path / "jax.safetensors")))
    got = load_file(export_classifier(_port(jp), _port(js),
                                      str(tmp_path / "p" / "m.safetensors")))
    assert set(got) == set(want)
    assert ("conv_module.bn1.running_var" in got) == (cfg.norm_type
                                                      == "batch")
    assert got["position_embeddings"].shape == (1000, cfg.encoder_dim)
    for k, a in want.items():
        assert got[k].dtype == a.dtype == np.float32, k
        assert np.array_equal(got[k], a), k


class _NoCheckpoints:
    """Stands in for the JAX trainer's orbax Checkpointer, whose
    asynchronous commits take seconds; the JAX CLI exports from the best
    tree it keeps in memory."""

    def __init__(self, *a, **kw):
        pass

    def latest_step(self):
        return None

    best_step = latest_step

    def save(self, *a, **kw):
        pass

    def close(self):
        pass


def test_cli_metrics_match_the_jax_cli(tmp_path, monkeypatch):
    from audio_transformers_tpu.cli import train_classifier as jcli
    from audio_transformers_tpu_torch.cli import train_classifier as pcli
    from audio_transformers_tpu_torch.utils.safetensors import load_file
    args = ["--dataset", "synthetic", "--limit_samples", "20",
            "--batch_size", "8", "--epochs", "2", "--conv_dim", "32",
            "--encoder_dim", "32", "--num_encoder_blocks", "1",
            "--num_heads", "4", "--dropout", "0", "--compute_dtype",
            "float32", "--num_workers", "0", "--seed", "3"]
    # both CLIs start from the port's init of seed 3, which the port's
    # trainer draws itself
    monkeypatch.setattr(jus, "init", lambda key, cfg: _jax_init(cfg, seed=3))
    monkeypatch.setattr(jtc, "Checkpointer", _NoCheckpoints)
    jcli.main(args + ["--output_dir", str(tmp_path / "jax")])
    out = pcli.main(args + ["--output_dir", str(tmp_path / "port"),
                            "--device", "cpu"])
    rows = {}
    for name in ("jax", "port"):
        with open(tmp_path / name / "metrics.jsonl") as f:
            rows[name] = [json.loads(line) for line in f]
    assert len(rows["port"]) == len(rows["jax"]) == 2
    for g, w in zip(rows["port"], rows["jax"]):
        assert set(g) == set(w)
        for k in w:
            if k in ("clips_per_sec", "data_wait_s", "wall_time"):
                continue
            np.testing.assert_allclose(g[k], w[k], rtol=1e-3, err_msg=k)
    assert out["history"][-1]["epoch"] == 2
    got = load_file(str(tmp_path / "port" / "best_model.safetensors"))
    from safetensors.numpy import load_file as np_load
    want = np_load(str(tmp_path / "jax" / "best_model.safetensors"))
    assert set(got) == set(want)
    for k, a in want.items():
        assert tuple(got[k].shape) == a.shape, k
    assert os.path.isdir(tmp_path / "port" / "checkpoints-resume")
