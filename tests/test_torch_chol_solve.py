"""
The solve pair of a Cholesky factor (``ops.spd_linalg.chol_solve``, kernel
``csrc/chol_solve.cu``): its plain blocked version against
``torch.cholesky_solve`` on the CPU, the shift-invert engine's inverse
apply through it, and on the card the kernel against the plain version
and a float64 solve, its determinism, its refusals and its launch count.

The card tests are marked ``cuda`` and skip without an NVIDIA GPU; this
file imports neither JAX nor the JAX package::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_chol_solve.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from springcraft_tpu_torch.ops import modes, spd_linalg  # noqa: E402

#: float32 / float64 relative agreement of two solves with the same
#: factor: the condition number of these factors (below 10) times a few
#: hundred roundings of a sum of m terms.
TOL = {torch.float32: 2e-5, torch.float64: 1e-12}


def _factor(m, seed, dtype=torch.float64):
    """A lower Cholesky factor of a well-conditioned SPD matrix, in the
    column-major storage ``torch.linalg.cholesky`` gives, and a scaling."""
    rng = np.random.RandomState(seed)
    a = rng.randn(m, m)
    a = a @ a.T / m + np.eye(m)
    chol = torch.linalg.cholesky(torch.as_tensor(a)).to(dtype)
    scale = torch.as_tensor(0.5 + rng.rand(m), dtype=dtype)
    return chol, scale


def _rel(got, ref):
    return float((got.double() - ref.double()).abs().max()
                 / ref.double().abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m", [1, 7, 64, 65, 200, 1000])
@pytest.mark.parametrize("b", [1, 8, 48, 56])
def test_plain_blocked_solve_matches_cholesky_solve(dtype, m, b):
    chol, scale = _factor(m, seed=m + b, dtype=dtype)
    x = torch.as_tensor(np.random.RandomState(b).randn(m, b), dtype=dtype)
    ref = scale[:, None] * torch.cholesky_solve(scale[:, None] * x, chol)
    got = spd_linalg.chol_solve_plain(x, chol, scale)
    assert got.dtype == dtype and got.shape == (m, b)
    assert _rel(got, ref) < TOL[dtype]
    # through the wrapper on the CPU
    assert torch.equal(spd_linalg.chol_solve(x, chol, scale), got)


@pytest.mark.parametrize("layout", ["column-major", "row-major"])
@pytest.mark.parametrize("m", [300, 301])
def test_chol_inverse_equals_the_scaled_cholesky_solve(layout, m):
    chol, scale = _factor(m, seed=5)
    if layout == "row-major":
        chol = chol.contiguous()
    # the shift-invert iterate: an orthonormal block, column-major
    x = torch.linalg.qr(torch.as_tensor(
        np.random.RandomState(6).randn(m, 48)))[0]
    ref = scale[:, None] * torch.cholesky_solve(scale[:, None] * x, chol)
    got = modes._chol_inverse(chol, scale)(x)
    assert _rel(got, ref) < TOL[torch.float64]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("m", [1, 7, 64, 65, 66])
def test_chol_solve_factor_aligns_the_leading_dimension(dtype, m):
    chol = _factor(m, seed=13, dtype=dtype)[0]
    got = spd_linalg.chol_solve_factor(chol)
    align = 16 // chol.element_size()
    assert torch.equal(got, chol) and got.stride(0) == 1
    assert got.stride(1) % align == 0 and got.stride(1) < m + align
    # as it is when it is aligned already, else a copy
    assert (got.data_ptr() == chol.data_ptr()) == (m % align == 0 and m > 1)


def test_wrapper_refuses_mismatched_shapes():
    chol, scale = _factor(10, seed=7)
    x = torch.zeros(10, 3, dtype=torch.float64)
    with pytest.raises(ValueError):
        spd_linalg.chol_solve(x[:9], chol, scale)
    with pytest.raises(ValueError):
        spd_linalg.chol_solve(x, chol[:, :9], scale)
    with pytest.raises(ValueError):
        spd_linalg.chol_solve(x, chol, scale[:9])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [1, 7, 64, 200, 1000, 3001])
@pytest.mark.parametrize("b", [1, 8, 48, 56])
def test_kernel_matches_plain_and_float64(cuda, dtype, m, b):
    chol64, scale64 = _factor(m, seed=m + b)
    x64 = torch.as_tensor(np.random.RandomState(b).randn(m, b))
    exact = scale64[:, None] * torch.cholesky_solve(scale64[:, None] * x64,
                                                    chol64)
    chol, scale, x = (t.to(cuda, dtype) for t in (chol64, scale64, x64))
    chol = spd_linalg.chol_solve_factor(chol)
    got = spd_linalg.chol_solve(x, chol, scale)
    plain = spd_linalg.chol_solve_plain(x, chol, scale)
    library = scale[:, None] * torch.cholesky_solve(scale[:, None] * x, chol)
    assert got.shape == (m, b) and got.is_contiguous()
    assert bool(torch.isfinite(got).all())
    assert _rel(got, plain) < TOL[dtype]
    # no worse against float64 than the library's solve, to rounding
    floor = 64 * torch.finfo(dtype).eps
    assert _rel(got, exact.to(cuda)) <= 2 * max(_rel(library, exact.to(cuda)),
                                               floor)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_is_deterministic(cuda, dtype):
    chol, scale = _factor(2000, seed=8)
    chol, scale = chol.to(cuda, dtype), scale.to(cuda, dtype)
    x = torch.linalg.qr(torch.randn(2000, 48, dtype=dtype, device=cuda))[0]
    first = spd_linalg.chol_solve(x, chol, scale)
    for _ in range(5):
        assert torch.equal(spd_linalg.chol_solve(x, chol, scale), first)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [998, 1001, 1002, 1003])
def test_kernel_reads_a_padded_leading_dimension(cuda, dtype, m):
    # the last 16-byte copy of each column lies astride m: the padding
    # below it (NaN here) is never read
    chol, scale = _factor(m, seed=12, dtype=dtype)
    chol, scale = chol.to(cuda), scale.to(cuda)
    x = torch.randn(m, 48, dtype=dtype, device=cuda)
    align = 16 // chol.element_size()
    ld = -(-m // align) * align + align
    padded = torch.full((m, ld), float("nan"), dtype=dtype,
                        device=cuda)[:, :m].mT
    padded.copy_(chol)
    got = spd_linalg.chol_solve(x, padded, scale)
    assert torch.equal(got, spd_linalg.chol_solve(
        x, spd_linalg.chol_solve_factor(chol), scale))
    assert _rel(got, spd_linalg.chol_solve_plain(x, chol, scale)) \
        < TOL[dtype]


@pytest.mark.cuda
def test_kernel_takes_any_right_hand_side_strides(cuda):
    chol, scale = _factor(500, seed=9, dtype=torch.float32)
    chol, scale = chol.to(cuda), scale.to(cuda)
    x = torch.randn(48, 500, device=cuda).T  # column-major
    ref = spd_linalg.chol_solve(x.contiguous(), chol, scale)
    assert torch.equal(spd_linalg.chol_solve(x, chol, scale), ref)
    wide = torch.randn(500, 96, device=cuda)
    assert torch.equal(spd_linalg.chol_solve(wide[:, ::2], chol, scale),
                       spd_linalg.chol_solve(wide[:, ::2].contiguous(), chol,
                                             scale))


@pytest.mark.cuda
def test_staged_engine_equals_chol_engine_bit_for_bit(cuda):
    rng = np.random.RandomState(10)
    n = 400
    a = rng.randn(n, n)
    h = torch.as_tensor((a @ a.T) / n, dtype=torch.float32, device=cuda)
    t = torch.linalg.qr(torch.as_tensor(rng.randn(n, 3),
                                        dtype=torch.float32, device=cuda))[0]
    # the null space of h: project it out
    h = h - t @ (t.T @ h) - (h @ t) @ t.T + t @ (t.T @ h @ t) @ t.T
    before = spd_linalg.chol_solve.launches
    sweeps = modes.lowest_modes_shift_invert.sweeps
    vals, vecs = modes.lowest_modes_shift_invert(h, t, k=4, engine="chol")
    n_sweeps = modes.lowest_modes_shift_invert.sweeps - sweeps
    assert n_sweeps == 24
    assert spd_linalg.chol_solve.launches - before == 2 * n_sweeps
    staged = modes.lowest_modes_shift_invert_staged(h, t, k=4)
    assert torch.equal(staged[0], vals) and torch.equal(staged[1], vecs)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    chol, scale = _factor(100, seed=11, dtype=torch.float32)
    x = torch.randn(100, 8, device=cuda)
    with pytest.raises(ValueError):  # a factor on the CPU
        spd_linalg.chol_solve(x, chol, scale.to(cuda))
    with pytest.raises(ValueError):  # a row-major factor
        spd_linalg.chol_solve(x, chol.to(cuda).contiguous(), scale.to(cuda))
    ragged, ragged_scale = _factor(101, seed=11, dtype=torch.float32)
    with pytest.raises(ValueError):  # a leading dimension of 101 floats
        spd_linalg.chol_solve(torch.randn(101, 8, device=cuda),
                              ragged.to(cuda), ragged_scale.to(cuda))
    with pytest.raises(TypeError):  # mixed dtypes
        spd_linalg.chol_solve(x.double(), chol.to(cuda), scale.to(cuda))
    with pytest.raises(TypeError):  # half precision
        spd_linalg.chol_solve(x.half(), chol.to(cuda).half(),
                              scale.to(cuda).half())
