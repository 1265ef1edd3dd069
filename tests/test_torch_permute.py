"""The plain version of the port's row-gather kernel K5
(`ops/permute.permute_rows_reference`) against the JAX Pallas kernel it
replaces, `permute_rows_pallas`, run interpreted on the CPU as the JAX
tests run it: bit for bit, on the beam cache's buffer mix (bf16 4-D, f32
3-D, int8 4-D, bool 2-D rows of 37 bytes, int64 token rows). And the
wrapper's CPU dispatch and operand checks. The kernel itself runs only on
a GPU (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from audio_transformers_tpu.ops.permute import permute_rows_pallas
from audio_transformers_tpu_torch.ops import _build
from audio_transformers_tpu_torch.ops import permute as pm


def _bufs(rng, rows):
    """numpy buffers of the beam-cache mix (the JAX test's, plus int64)."""
    return [
        rng.standard_normal((rows, 3, 8, 16)).astype(ml_dtypes.bfloat16),
        rng.standard_normal((rows, 3, 16)).astype(np.float32),
        rng.integers(-127, 128, (rows, 3, 8, 16)).astype(np.int8),
        rng.integers(0, 2, (rows, 37)).astype(bool),
    ]


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t):
    """A tensor's raw bytes as a numpy array, for bit-for-bit equality."""
    return t.contiguous().view(torch.uint8).numpy()


def _jax_bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _perms(rng, rows):
    ident = np.arange(rows)
    return {"repeats": rng.integers(0, rows, rows),
            "all_one_parent": np.full(rows, rows // 2),
            "identity": ident, "reverse": ident[::-1].copy()}


@pytest.mark.parametrize("rows", [8, 16])
@pytest.mark.parametrize("kind", ["repeats", "all_one_parent", "identity",
                                  "reverse"])
def test_plain_matches_pallas_bit_for_bit(rows, kind):
    rng = np.random.default_rng(rows)
    bufs = _bufs(rng, rows)
    perm = _perms(rng, rows)[kind]
    want = permute_rows_pallas([jnp.asarray(a) for a in bufs],
                               jnp.asarray(perm, jnp.int32), interpret=True)
    got = pm.permute_rows(
        [_torch(a) for a in bufs], torch.from_numpy(perm))
    for g, w, a in zip(got, want, bufs):
        assert tuple(g.shape) == a.shape
        np.testing.assert_array_equal(_bits(g), _jax_bits(w))
        np.testing.assert_array_equal(_bits(g), _jax_bits(a[perm]))


@pytest.mark.parametrize("perm_dtype", [torch.int32, torch.int64])
def test_into_given_outputs_with_int64_rows(perm_dtype):
    # the beam loop's use: a second set of buffers, token rows in int64
    rng = np.random.default_rng(3)
    bufs = [_torch(a) for a in _bufs(rng, 12)]
    bufs.append(torch.from_numpy(rng.integers(0, 2 ** 40, (12, 66))))
    out = [torch.empty_like(a) for a in bufs]
    perm = torch.from_numpy(rng.integers(0, 12, 12)).to(perm_dtype)
    got = pm.permute_rows(bufs, perm, out=out)
    for g, o, a in zip(got, out, bufs):
        assert g is o
        assert torch.equal(g, a[perm.long()])


def test_cpu_runs_the_plain_version():
    before = {n: (s.launches, s.plain_cuda_calls)
              for n, s in _build.STATS.items()}
    x = torch.arange(12).reshape(4, 3)
    got = pm.permute_rows([x], torch.tensor([3, 3, 0, 1]))
    assert torch.equal(got[0], x[[3, 3, 0, 1]])
    # a CPU call neither launches the kernel nor counts as a plain run on
    # the card
    assert {n: (s.launches, s.plain_cuda_calls)
            for n, s in _build.STATS.items()} == before


def test_refuses_overlapping_destination():
    x = torch.arange(40, dtype=torch.float32).reshape(8, 5)
    perm = torch.tensor([1, 1, 0, 2, 7, 7, 3, 4])
    with pytest.raises(ValueError, match="overlaps"):
        pm.permute_rows([x], perm, out=[x])
    big = torch.zeros(16, 5)
    with pytest.raises(ValueError, match="overlaps"):   # a view into a source
        pm.permute_rows([big[:8]], perm, out=[big[4:12]])
    y = torch.zeros(8, 5)
    with pytest.raises(ValueError, match="overlaps"):   # another buffer's
        pm.permute_rows([x, y], perm, out=[y, torch.zeros(8, 5)])
    # adjacent but disjoint halves of one allocation are fine
    pm.permute_rows([big[:8]], perm, out=[big[8:]])
    assert torch.equal(big[8:], big[:8][perm])


def test_rejects_bad_operands():
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError):                   # rows differ
        pm.permute_rows([x, torch.zeros(5, 3)], torch.arange(4))
    with pytest.raises(ValueError):                   # perm length
        pm.permute_rows([x], torch.arange(3))
    with pytest.raises(TypeError):                    # perm dtype
        pm.permute_rows([x], torch.zeros(4))
    with pytest.raises(ValueError):                   # not contiguous
        pm.permute_rows([torch.zeros(3, 4).t()], torch.arange(4))
    with pytest.raises(ValueError):                   # output mismatch
        pm.permute_rows([x], torch.arange(4), out=[torch.zeros(4, 3,
                                                               dtype=int)])
    with pytest.raises(ValueError):                   # output count
        pm.permute_rows([x], torch.arange(4), out=[])
    with pytest.raises(ValueError):
        pm.permute_rows([], torch.arange(4))
