"""
PyTorch port, SPD linear algebra: the panel inverse (plain version of
the ``panel_inverse`` CUDA kernel) and the divide-and-conquer inverse
factor, held against the JAX package on the same numpy inputs.  The
JAX panel kernel runs in interpret mode on the CPU.

Tolerances: the panel elimination repeats the JAX kernel's operations
in the same order, so 2e-5 absolute on unit-scale panels bounds the
rounding of 64 dependent float32 steps; the factor blocks add float32
matrix products whose summation order differs between XLA and PyTorch
(1e-5 of max|G|).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from springcraft_tpu.ops import pallas_linalg  # noqa: E402
from springcraft_tpu_torch.ops import spd_linalg  # noqa: E402


def _equilibrated_spd(b, m, seed):
    """Unit-diagonal SPD batch, like the pipeline's equilibrated input."""
    rng = np.random.RandomState(seed)
    a = rng.randn(b, m, m)
    a = a @ a.transpose(0, 2, 1) / m + 0.5 * np.eye(m)
    d = 1.0 / np.sqrt(np.diagonal(a, axis1=1, axis2=2))
    return (a * d[:, :, None] * d[:, None, :]).astype(np.float32)


def _rel(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


@pytest.mark.parametrize("pb", [16, 64])
def test_panel_inverse_matches_jax_shrink_kernel(pb):
    panels = _equilibrated_spd(5, pb, seed=pb)
    ref = np.asarray(pallas_linalg.panel_inverse_batched(
        jnp.asarray(panels), shrink_block=8, interpret=True))

    before = spd_linalg.panel_inverse_batched.launches
    got = spd_linalg.panel_inverse_batched(torch.from_numpy(panels))
    assert spd_linalg.panel_inverse_batched.launches == before
    assert got.dtype == torch.float32 and got.shape == (5, pb, pb)
    assert np.max(np.abs(got.numpy() - ref)) <= 2e-5
    # strict upper triangle is exactly zero
    upper = torch.triu(got, diagonal=1)
    assert torch.equal(upper, torch.zeros_like(upper))
    # and it is L^-1: G A G^T = I
    gag = got.double() @ torch.from_numpy(panels).double() \
        @ got.double().transpose(-1, -2)
    assert float((gag - torch.eye(pb)).abs().max()) < 1e-4


def test_panel_inverse_breakdown_is_not_finite():
    panels = _equilibrated_spd(3, 16, seed=2)
    panels[1, 5, 5] = -1.0                     # not SPD
    got = spd_linalg.panel_inverse_plain(torch.from_numpy(panels))
    assert not torch.isfinite(got[1]).all()
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[2]).all()


@pytest.mark.parametrize("shape", [(4, 16, 8), (4, 12, 12), (16, 16)])
def test_panel_inverse_rejects_bad_shapes(shape):
    with pytest.raises(ValueError):
        spd_linalg.panel_inverse_batched(torch.zeros(shape))


@pytest.mark.parametrize("m,mp", [(8, 8), (30, 32), (90, 128), (200, 256),
                                  (300, 384), (900, 1024)])
def test_padded_size_matches_jax(m, mp):
    assert spd_linalg.padded_size(m) == pallas_linalg.padded_size(m) == mp


@pytest.mark.parametrize("h", [64, 128, 192, 256, 384, 512])
def test_tri_split_matches_jax(h):
    assert spd_linalg._tri_split(h) == pallas_linalg._tri_split(h)


@pytest.mark.parametrize("m", [90, 300])
def test_inverse_factor_parts_match_jax(m):
    a = _equilibrated_spd(2, m, seed=m)
    ref = pallas_linalg.spd_inverse_factor_parts(jnp.asarray(a),
                                                 interpret=True)
    got = spd_linalg.spd_inverse_factor_parts(torch.from_numpy(a))
    mp = spd_linalg.padded_size(m)
    assert got[0].shape[-1] + got[2].shape[-1] == mp
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert _rel(g, r) <= 1e-5
    # G = [[g11, 0], [g21, g22]] is L^-1 of the identity-padded input
    g11, g21, g22 = (p.double() for p in got)
    h = g11.shape[-1]
    g = torch.zeros(2, mp, mp, dtype=torch.float64)
    g[:, :h, :h], g[:, h:, :h], g[:, h:, h:] = g11, g21, g22
    inv = (g.transpose(-1, -2) @ g)[:, :m, :m]
    np.testing.assert_allclose(
        inv.numpy(), np.linalg.inv(a.astype(np.float64)), atol=2e-4)


def test_inverse_factor_single_leaf_and_batch_shape():
    a = _equilibrated_spd(6, 40, seed=4).reshape(2, 3, 40, 40)
    g, g21, g22 = spd_linalg.spd_inverse_factor_parts(torch.from_numpy(a))
    assert g21 is None and g22 is None and g.shape == (2, 3, 40, 40)
    ref = spd_linalg.panel_inverse_plain(torch.from_numpy(a.reshape(6, 40,
                                                                    40)))
    assert torch.equal(g.reshape(6, 40, 40), ref)
