"""
PyTorch port, the blocked inverse past 64-row leaves: the plain panel
inverse (the version of kernels K3 and K9 that runs on the CPU) at the
leaves of ``block`` 72-128, the ``block=`` and ``precision=`` keywords of
the divide-and-conquer inverse, and ``panel_inverse_batched``'s default
(``shrink_block=None``, the full-window kernel, as in the JAX package),
each held against the JAX package on the same numpy inputs, its Pallas
kernels in interpret mode.

Tolerances: the panel elimination repeats the JAX kernel's operations in
the same order, so 2e-5 absolute on unit-scale panels bounds the rounding
of up to 128 dependent float32 steps and ``G A G^T = I`` holds to 1e-4;
the inverse adds float32 products whose summation order differs between
XLA and PyTorch (1e-4 of max|x| in float32, 1e-10 in float64).
"""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from springcraft_tpu.ops import pallas_linalg  # noqa: E402
from springcraft_tpu_torch.ops import spd_linalg  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the plain panel inverse is a loop of small
    ops, and under pytest-xdist every worker's OpenMP pool would spin on
    all cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _equilibrated_spd(b, m, seed, dtype=np.float32):
    """Unit-diagonal SPD batch, like the pipeline's equilibrated input."""
    rng = np.random.RandomState(seed)
    a = rng.randn(b, m, m)
    a = a @ a.transpose(0, 2, 1) / m + 0.5 * np.eye(m)
    d = 1.0 / np.sqrt(np.diagonal(a, axis1=1, axis2=2))
    return (a * d[:, :, None] * d[:, None, :]).astype(dtype)


def _rel(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


@pytest.mark.parametrize("shrink_block", [8, None])
@pytest.mark.parametrize("pb", [72, 96, 128])
def test_plain_panel_inverse_past_64_matches_jax(pb, shrink_block):
    panels = _equilibrated_spd(3, pb, seed=pb)
    ref = np.asarray(pallas_linalg.panel_inverse_batched(
        jnp.asarray(panels), shrink_block=shrink_block, interpret=True))
    got = spd_linalg.panel_inverse_batched(torch.from_numpy(panels),
                                           shrink_block=shrink_block)
    assert got.dtype == torch.float32 and got.shape == (3, pb, pb)
    assert np.max(np.abs(got.numpy() - ref)) <= 2e-5
    upper = torch.triu(got, diagonal=1)
    assert torch.equal(upper, torch.zeros_like(upper))
    g = got.double()
    gag = g @ torch.from_numpy(panels).double() @ g.transpose(-1, -2)
    assert float((gag - torch.eye(pb, dtype=torch.float64)).abs().max()) \
        <= 1e-4
    assert torch.equal(got, spd_linalg.panel_inverse_plain(
        torch.from_numpy(panels)))


def test_plain_panel_inverse_past_64_breaks_down_in_its_panel():
    panels = _equilibrated_spd(3, 128, seed=5)
    panels[1, 70, 70] = -1.0
    got = spd_linalg.panel_inverse_plain(torch.from_numpy(panels))
    assert not torch.isfinite(got[1]).all()
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[2]).all()


@pytest.mark.parametrize("fn", ["spd_inverse_blocked", "spd_inverse_factor",
                                "spd_inverse_factor_parts"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m", [300, 120])
@pytest.mark.parametrize("block", [32, 96, 128])
def test_blocked_inverse_block_keyword_matches_jax(fn, dtype, m, block):
    """Both packages factor the same padded problem with the same leaves:
    (2, 300, 300) splits down to its leaves, (2, 120, 120) is one leaf of
    120 rows at block 128."""
    a = _equilibrated_spd(2, m, seed=m + block, dtype=dtype)
    ref = getattr(pallas_linalg, fn)(jnp.asarray(a), block=block,
                                     interpret=True)
    got = getattr(spd_linalg, fn)(torch.from_numpy(a), block=block)
    tol = 1e-4 if dtype == np.float32 else 1e-10
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is None:
            continue
        assert tuple(g.shape) == r.shape
        assert g.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
        assert _rel(g, r) <= tol
    if fn == "spd_inverse_blocked":
        np.testing.assert_allclose(
            got[0].double().numpy(), np.linalg.inv(a.astype(np.float64)),
            atol=2e-4 if dtype == np.float32 else 1e-9)


def test_single_leaf_at_block_128_is_one_panel():
    a = torch.from_numpy(_equilibrated_spd(2, 120, seed=1))
    g11, g21, g22 = spd_linalg.spd_inverse_factor_parts(a, block=128)
    assert g21 is None and g22 is None and g11.shape == (2, 120, 120)
    assert torch.equal(g11, spd_linalg.panel_inverse_plain(a))
    g11, g21, _ = spd_linalg.spd_inverse_factor_parts(a)
    assert g21 is not None and g11.shape == (2, 64, 64)


@pytest.mark.parametrize("block", [4, 8, 24, 64, 96, 128, 160])
def test_padded_size_matches_jax_at_every_block(block):
    for m in range(1, 1101):
        assert spd_linalg.padded_size(m, block) == \
            pallas_linalg.padded_size(m, block), (m, block)


def test_padded_size_matches_jax_for_blocks_4_to_160():
    ms = (1, 7, 8, 9, 63, 64, 65, 100, 127, 128, 129, 200, 256, 257, 300,
          900, 1100)
    for block in range(4, 161):
        for m in ms:
            assert spd_linalg.padded_size(m, block) == \
                pallas_linalg.padded_size(m, block), (m, block)


def test_block_is_clamped_to_8_and_128():
    a = torch.from_numpy(_equilibrated_spd(1, 200, seed=2))
    for low, high in ((1, 8), (160, 128)):
        for fn in (spd_linalg.spd_inverse_factor,
                   spd_linalg.spd_inverse_blocked):
            assert torch.equal(fn(a, block=low), fn(a, block=high))


@pytest.mark.parametrize("precision", [None, "highest"])
def test_precision_keyword_takes_full_float32(precision):
    a = torch.from_numpy(_equilibrated_spd(1, 100, seed=3))
    for fn in (spd_linalg.spd_inverse_blocked, spd_linalg.spd_inverse_factor):
        assert torch.equal(fn(a, precision=precision), fn(a))


@pytest.mark.parametrize("precision", ["high", "default", "float32"])
def test_precision_keyword_refuses_lower_precisions(precision):
    a = torch.from_numpy(_equilibrated_spd(1, 40, seed=3))
    for fn in (spd_linalg.spd_inverse_blocked, spd_linalg.spd_inverse_factor,
               spd_linalg.spd_inverse_factor_parts):
        with pytest.raises(ValueError, match="precision"):
            fn(a, precision=precision)


def test_panel_inverse_batched_defaults_to_the_full_window_kernel():
    """The JAX package's default, ``shrink_block=None`` (K9); the
    recursion's leaves still ask for ``shrink_block=8`` (K3)."""
    for fn in (spd_linalg.panel_inverse_batched,
               pallas_linalg.panel_inverse_batched):
        assert inspect.signature(fn).parameters[
            "shrink_block"].default is None
    calls = []
    original = spd_linalg.panel_inverse_batched

    def spy(panels, shrink_block=None):
        calls.append(shrink_block)
        return original(panels, shrink_block=shrink_block)

    a = torch.from_numpy(_equilibrated_spd(1, 300, seed=4))
    spd_linalg.panel_inverse_batched = spy
    try:
        spd_linalg.spd_inverse_factor_parts(a)
    finally:
        spd_linalg.panel_inverse_batched = original
    assert calls and set(calls) == {8}


def test_max_leaf_is_the_jax_clamp():
    assert spd_linalg.MAX_LEAF == 128 and spd_linalg.LEAF == 64
