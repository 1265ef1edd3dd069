"""The port's flash attention (K4) against the JAX package's, on the CPU.

The port's `flash_attention` here runs its kernels' plain versions inside
the same `torch.autograd.Function` the CUDA kernels run in; the JAX side
runs its Pallas kernels in interpret mode, as tests/test_attention.py
does (block_q = block_k = 128), and `attention_reference`. Inputs are
numpy draws from a seed, fed to both.

Tolerances:
  float32: 2e-5 abs + 2e-5 rel on the output, 1e-4 abs + 1e-4 rel on the
    gradients (f32 sums in another order; JAX's online softmax rescales
    per 128-key block where the plain versions take one max);
  bfloat16: within one bf16 ulp of the tensor's largest magnitude (the
    output is stored in bf16, and p is rounded to bf16 against the running
    maximum in JAX but against the final one in the plain version).
The plain kernel twins against JAX's own `_fwd_impl`/`_flash_bwd`: lse to
1e-5 abs, outputs and gradients as above.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_transformers_tpu.ops import attention as jatt
from audio_transformers_tpu_torch.ops import _build
from audio_transformers_tpu_torch.ops import attention as att

# (Tq, Tk, causal): the JAX tests' shapes, then the decoder's at
# whisper-tiny's label length (self-attention 31, cross-attention to keys)
SHAPES = [(256, 256, False), (300, 300, False), (128, 384, False),
          (256, 256, True), (200, 200, True), (31, 31, True),
          (31, 64, False)]
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (None, jnp.bfloat16, torch.bfloat16)}


def _inputs(tq, tk, seed, b=2, h=2, d=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, tk, d)).astype(np.float32)
    v = rng.standard_normal((b, h, tk, d)).astype(np.float32)
    g = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    return q, k, v, g


def _j(a, jdt):
    return jnp.asarray(a).astype(jdt)


def _t(a, tdt):
    return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(tdt)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype, *, grad=False):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    if dtype == "float32":
        tol = 1e-4 if grad else 2e-5
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        return
    scale = np.abs(want).max()
    ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
    err = np.abs(got - want).max()
    assert err <= ulp, f"max err {err} > one bf16 ulp {ulp} at {scale}"


def _jax_flash(q, k, v, g, causal, jdt):
    fn = lambda q, k, v: jatt.flash_attention(q, k, v, causal=causal,
                                              block_q=128, block_k=128)
    out, vjp = jax.vjp(fn, _j(q, jdt), _j(k, jdt), _j(v, jdt))
    return (out, *vjp(_j(g, jdt)))


def _jax_reference(q, k, v, g, causal, jdt):
    fn = lambda q, k, v: jatt.attention_reference(q, k, v, causal=causal)
    out, vjp = jax.vjp(fn, _j(q, jdt), _j(k, jdt), _j(v, jdt))
    return (out, *vjp(_j(g, jdt)))


def _port(q, k, v, g, causal, tdt):
    qt, kt, vt = (_t(x, tdt).requires_grad_() for x in (q, k, v))
    out = att.flash_attention(qt, kt, vt, causal=causal)
    out.backward(_t(g, tdt))
    return out, qt.grad, kt.grad, vt.grad


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("tq,tk,causal", SHAPES)
def test_flash_matches_jax_flash(tq, tk, causal, dtype):
    _, jdt, tdt = DTYPES[dtype]
    q, k, v, g = _inputs(tq, tk, seed=tq * 3 + tk + causal)
    got = _port(q, k, v, g, causal, tdt)
    want = _jax_flash(q, k, v, g, causal, jdt)
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a, b, dtype, grad=i > 0)
        assert a.dtype == tdt


@pytest.mark.parametrize("tq,tk,causal", SHAPES)
def test_flash_matches_attention_reference(tq, tk, causal):
    q, k, v, g = _inputs(tq, tk, seed=tq + 7 * tk)
    got = _port(q, k, v, g, causal, torch.float32)
    want = _jax_reference(q, k, v, g, causal, jnp.float32)
    for i, (a, b) in enumerate(zip(got, want)):
        _close(a, b, "float32", grad=i > 0)
    # the port's own unfused reference agrees too
    ref = att.attention_reference(*(_t(x, torch.float32) for x in (q, k, v)),
                                  causal=causal)
    _close(ref, want[0], "float32")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("tq,tk,causal", [(300, 300, False),
                                          (200, 200, True), (31, 64, False)])
def test_plain_twins_match_jax_kernels(tq, tk, causal, dtype):
    """Each plain kernel twin against the JAX kernel it stands for, on
    pre-scaled q in the (BH, T, d) layout."""
    _, jdt, tdt = DTYPES[dtype]
    q, k, v, g = _inputs(tq, tk, seed=5 * tq + tk)
    d = q.shape[-1]
    qs = _j(q, jdt) * jnp.asarray(1.0 / math.sqrt(d), jdt)
    kj, vj, gj = _j(k, jdt), _j(v, jdt), _j(g, jdt)
    out_j, res = jatt._flash_fwd(qs, kj, vj, causal, 1.0, 128, 128, True)
    dq_j, dk_j, dv_j = jatt._flash_bwd(causal, 1.0, 128, 128, True, res, gj)
    lse_j = np.asarray(res[4])[:, :tq, 0]

    bh = q.shape[0] * q.shape[1]
    flat = lambda x, t: torch.from_numpy(_f32(x)).to(tdt).reshape(bh, t, d)
    qt, kt, vt, gt = (flat(qs, tq), flat(kj, tk), flat(vj, tk),
                      flat(gj, tq))
    out, lse = att.flash_attention_fwd_reference(qt, kt, vt, causal)
    _close(out.reshape(out_j.shape), out_j, dtype)
    np.testing.assert_allclose(lse.numpy(), lse_j, atol=1e-5, rtol=0)
    assert lse.dtype == torch.float32 and out.dtype == tdt

    # the backward twins from JAX's own residuals (lse, delta)
    lse_t = torch.from_numpy(lse_j.copy())
    delta = (gt.float() * flat(out_j, tq).float()).sum(-1)
    dq = att.flash_attention_bwd_dq_reference(qt, kt, vt, gt, lse_t, delta,
                                              causal)
    dk, dv = att.flash_attention_bwd_dkv_reference(qt, kt, vt, gt, lse_t,
                                                   delta, causal)
    for a, b in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        assert a.dtype == tdt
        _close(a.reshape(b.shape), b, dtype, grad=True)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    q, k, v, g = _inputs(40, 50, seed=3, b=1, h=2, d=16)
    _build.reset_stats()
    _port(q, k, v, g, True, torch.float32)
    for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert _build.STATS[name].launches == 0
        assert _build.STATS[name].plain_cuda_calls == 0


def test_wrappers_check_their_inputs():
    x = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError):   # a CPU tensor never reaches a kernel
        att._check(x, x, x)
    with pytest.raises(ValueError):   # head dim above 128
        att._check(*(torch.zeros(2, 8, 160),) * 3)


def test_mha_flash_path_rejects_a_mask():
    from audio_transformers_tpu_torch.ops import nn
    p = {n: {"w": torch.zeros(8, 8), "b": torch.zeros(8)}
         for n in ("q", "k", "v", "o")}
    x = torch.zeros(1, 4, 8)
    with pytest.raises(NotImplementedError):
        nn.multihead_attention(p, x, x, num_heads=2, impl="flash",
                               mask=torch.ones(1, 1, 4, 4, dtype=torch.bool))
