"""
PyTorch port, the last dense-path kernels: the assembly-fused prep
(plain version of the ``assembly_stitch`` CUDA kernel, ``prep="direct"``
of the ANM ensemble), the panel Cholesky factor (plain version of
``panel_cholesky``) and the full-window panel inverse, each held against
the JAX package on the same numpy inputs.  The JAX Pallas kernels run in
interpret mode on the CPU.

Tolerances: the fused prep repeats the stitch's arithmetic on planes it
recomputes (1e-5 of max|reg|, as the stitch; scale and sigma 1e-6
relative: short float32 reductions).  The panel functions repeat the JAX
kernels' eliminations step for step (2e-5 absolute on unit-scale panels,
as the shrink kernel's test); ``L^-1`` by Newton products adds float32
matrix products in another summation order (1e-5 of max).  The slice is
held to 1e-4 of max in float32 and 1e-10 in float64, as everywhere.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import springcraft_tpu as sc  # noqa: E402
from springcraft_tpu.ops import ffparams as jff  # noqa: E402
from springcraft_tpu.ops import pallas_linalg  # noqa: E402
from springcraft_tpu.ops import rigid as jrigid  # noqa: E402
from springcraft_tpu.parallel import pipeline as jpipe  # noqa: E402
from springcraft_tpu.structure import load_structure as jload  # noqa: E402
import springcraft_tpu_torch as sct  # noqa: E402
from springcraft_tpu_torch.ops import assembly, assembly_kernels  # noqa: E402
from springcraft_tpu_torch.ops import rigid as trigid  # noqa: E402
from springcraft_tpu_torch.ops import spd_linalg  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.realpath(__file__)), "data")
KINDS = ("invariant", "hinsen", "pfenm")


def _dense_coords(b, n, seed):
    # connected at a 7 A cutoff (see tests/test_pallas_linalg.py)
    rng = np.random.RandomState(seed)
    base = (rng.rand(n, 3) * 6.0).astype(np.float32)
    return base[None] + 0.05 * rng.randn(b, n, 3).astype(np.float32)


def _params(kind, cutoff=7.0):
    return (getattr(jff, f"{kind}_params")(cutoff),
            getattr(sct, f"{kind}_params")(cutoff))


def _masses(n):
    return np.linspace(0.8, 2.5, n).astype(np.float32)


def _rel(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _equilibrated_spd(b, m, seed):
    """Unit-diagonal SPD batch, like the pipeline's equilibrated input."""
    rng = np.random.RandomState(seed)
    a = rng.randn(b, m, m)
    a = a @ a.transpose(0, 2, 1) / m + 0.5 * np.eye(m)
    d = 1.0 / np.sqrt(np.diagonal(a, axis1=1, axis2=2))
    return (a * d[:, :, None] * d[:, None, :]).astype(np.float32)


# ---------------------------------------------------------------------------
# The assembly-fused prep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_hessian_diagonal_matches_jax(kind):
    jparams, params = _params(kind)
    coords = _dense_coords(3, 30, seed=5)
    ref = jrigid._hessian_diag_xyz_batched(jnp.asarray(coords), jparams,
                                           jnp.float32)
    got = trigid._hessian_diag_xyz_batched(torch.from_numpy(coords), params)
    assert got.shape == (3, 90)
    assert _rel(got, ref) <= 1e-6
    # and it is the diagonal of the Hessian the planes hold
    planes = assembly.hessian_planes_plain(torch.from_numpy(coords), params)
    diag = torch.cat([torch.diagonal(planes[4 * a], dim1=-2, dim2=-1)
                      for a in range(3)], dim=-1)
    assert _rel(got, diag) <= 1e-6


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-6),
                                       (np.float64, 1e-12)])
def test_row_sums_plain_matches_the_plain_planes(kind, dtype, tol):
    """The first pass of the fused prep: the nine diagonal superelements
    ``H_ae[p, p]`` are the negated sums of the off-diagonal entries of
    each row of the plain Hessian planes (the float64 sums of the
    float32 entries within 1e-6 of max, float64 within 1e-12)."""
    _, params = _params(kind)
    coords = torch.from_numpy(_dense_coords(3, 30, seed=6).astype(dtype))
    got = assembly_kernels.assembly_row_sums(coords, params)
    assert got.shape == (3, 30, 9) and got.dtype == coords.dtype
    planes = assembly.hessian_planes_plain(coords, params).double()
    idx = torch.arange(30)
    diag = planes[:, :, idx, idx]                       # (9, B, n)
    off = planes.clone()
    off[:, :, idx, idx] = 0.0
    ref = -off.sum(dim=-1)
    assert _rel(got, ref.permute(1, 2, 0)) <= tol
    assert _rel(got, diag.permute(1, 2, 0)) <= tol
    # the superelements are symmetric: H_ae[p, p] = H_ea[p, p]
    sym = got.reshape(3, 30, 3, 3)
    assert _rel(sym, sym.transpose(-1, -2)) <= tol


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("with_masses", [False, True])
def test_row_sum_diagonal_matches_jax(kind, with_masses):
    """The ``a == e`` row sums are the JAX package's
    ``_hessian_diag_xyz_batched``; with masses the prep folds the
    weights ``1 / m`` into that diagonal before its scale, as the JAX
    prep does (``springcraft_tpu/ops/rigid.py``
    ``_regularize_equilibrated_direct``)."""
    jparams, params = _params(kind)
    n = 30
    coords = _dense_coords(3, n, seed=9)
    jdiag = jrigid._hessian_diag_xyz_batched(jnp.asarray(coords), jparams,
                                             jnp.float32)
    row_sums = assembly_kernels.assembly_row_sums(torch.from_numpy(coords),
                                                  params)
    diag = trigid._diagonal_of_row_sums(row_sums)
    assert diag.shape == (3, 3 * n)
    assert _rel(diag, jdiag) <= 1e-6
    assert _rel(diag, trigid._hessian_diag_xyz_batched(
        torch.from_numpy(coords), params)) <= 1e-6
    masses = _masses(n) if with_masses else None
    t = np.stack([np.asarray(jrigid.rigid_modes_anm(
        jnp.asarray(c), masses=None if masses is None else
        jnp.asarray(masses), layout="xyz")) for c in coords])
    # the JAX prep's scale from its own diagonal
    w = None if masses is None else np.tile(1.0 / np.sqrt(masses), 3)
    jdiag_m = jdiag if w is None else jdiag * jnp.asarray(w * w)[None]
    jsigma = jnp.mean(jdiag_m, axis=-1)
    jscale = 1.0 / jnp.sqrt(jdiag_m + jsigma[:, None]
                            * jnp.sum(jnp.asarray(t) ** 2, axis=-1))
    jscale_h = jscale if w is None else jscale * jnp.asarray(w)[None]
    scale, sigma, scale_h, _ = trigid._stitch_inputs_from_diag(
        diag, torch.from_numpy(t),
        None if masses is None else torch.from_numpy(masses))
    assert _rel(sigma.reshape(-1), jsigma) <= 1e-6
    assert _rel(scale, jscale) <= 1e-6
    assert _rel(scale_h, jscale_h) <= 1e-6


def test_row_sums_check_their_inputs():
    coords = torch.zeros(2, 10, 3)
    table = sct.table_pair_params(np.zeros((10, 10, 1)), None)
    with pytest.raises(ValueError, match="analytic"):
        assembly_kernels.assembly_row_sums(coords, table)
    with pytest.raises(ValueError, match=r"\(B, n, 3\)"):
        assembly_kernels.assembly_row_sums(coords[0],
                                           sct.invariant_params(7.0))
    with pytest.raises(ValueError, match="row_sums must be"):
        assembly_kernels.assembly_stitch(
            coords, sct.invariant_params(7.0), torch.ones(2, 30),
            torch.zeros(2, 30, 6), 32, torch.zeros(2, 10, 3))


@pytest.mark.parametrize("kind", KINDS)
def test_assembly_stitch_plain_takes_the_row_sums(kind):
    """Handed the row sums, the plain fused prep writes them as the
    diagonal superelements and leaves every other element as it was."""
    _, params = _params(kind)
    n = 20
    coords = torch.from_numpy(_dense_coords(2, n, seed=4))
    rng = np.random.RandomState(1)
    scale_h = torch.from_numpy(rng.rand(2, 3 * n).astype(np.float32) + 0.5)
    ts = torch.from_numpy(rng.randn(2, 3 * n, 6).astype(np.float32))
    plain = assembly_kernels.assembly_stitch_plain(coords, params, scale_h,
                                                   ts, 64)
    row_sums = assembly_kernels.assembly_row_sums(coords, params)
    got = assembly_kernels.assembly_stitch(coords, params, scale_h, ts, 64,
                                           row_sums)
    assert _rel(got, plain) <= 1e-6
    marked = row_sums + 1.0
    moved = assembly_kernels.assembly_stitch(coords, params, scale_h, ts, 64,
                                             marked)
    rows = torch.arange(3 * n)
    cols = (rows % n)[:, None] + n * torch.arange(3)[None, :]  # (3n, 3)
    mask = torch.zeros(64, 64, dtype=torch.bool)
    mask[rows[:, None], cols] = True
    assert torch.equal(moved[:, ~mask], got[:, ~mask])
    # each moved by s_r s_c, to the rounding of elements of its size
    sr, sc = scale_h[:, rows, None], scale_h[:, cols]
    step = (moved[:, mask] - got[:, mask]).reshape(2, 3 * n, 3)
    assert float((step - sr * sc).abs().max()) \
        <= 1e-6 * float(got[:, mask].abs().max())


def test_store_pass_stages_the_largest_conformer():
    """The store pass stages 24 n floats of column side and a band's row
    side in one block's shared memory: at ``MAX_ATOMS_STITCH`` that fits
    the 227 KB a block can opt in to."""
    import pathlib
    import re

    text = (pathlib.Path(assembly_kernels.__file__).resolve().parent.parent
            / "csrc" / "assembly_stitch.cu").read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    n = assembly_kernels.MAX_ATOMS_STITCH
    smem = 4 * (24 * n + constant("kBandAtoms") * constant("kSide"))
    assert 48 * 1024 < smem <= 232_448


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("with_masses", [False, True])
def test_assembly_stitch_plain_matches_jax_kernel(kind, with_masses):
    """``_regularize_equilibrated_direct`` of both packages: the JAX one
    packs its aux arrays and runs ``assembly_stitch_pallas``."""
    jparams, params = _params(kind)
    n = 30
    coords = _dense_coords(3, n, seed=3)
    masses = _masses(n) if with_masses else None
    jmasses = None if masses is None else jnp.asarray(masses)
    bases = np.stack([np.asarray(jrigid.rigid_modes_anm(
        jnp.asarray(c), masses=jmasses, layout="xyz")) for c in coords])
    ref_reg, ref_scale, ref_sigma = jrigid._regularize_equilibrated_direct(
        jnp.asarray(coords), jparams, jnp.asarray(bases), None,
        masses=jmasses, interpret=True)

    before = assembly_kernels.assembly_stitch.launches
    got_reg, got_scale, got_sigma = trigid._regularize_equilibrated_direct(
        torch.from_numpy(coords), params, torch.from_numpy(bases),
        masses=None if masses is None else torch.from_numpy(masses))
    assert assembly_kernels.assembly_stitch.launches == before
    mp = spd_linalg.padded_size(3 * n)
    assert got_reg.shape == (3, mp, mp) == ref_reg.shape
    assert _rel(got_reg, ref_reg) <= 1e-5
    assert _rel(got_scale, ref_scale) <= 1e-6
    assert _rel(got_sigma, ref_sigma) <= 1e-6
    # identity pad, exact
    pad = got_reg[:, 3 * n:, :]
    eye = torch.zeros_like(pad)
    eye[:, torch.arange(mp - 3 * n), 3 * n + torch.arange(mp - 3 * n)] = 1.0
    assert torch.equal(pad, eye)
    assert torch.equal(got_reg[:, :3 * n, 3 * n:],
                       torch.zeros(3, 3 * n, mp - 3 * n))


@pytest.mark.parametrize("kind", KINDS)
def test_assembly_stitch_equals_planes_then_stitch(kind):
    _, params = _params(kind)
    n = 20
    coords = torch.from_numpy(_dense_coords(2, n, seed=8))
    rng = np.random.RandomState(0)
    scale_h = torch.from_numpy(rng.rand(2, 3 * n).astype(np.float32) + 0.5)
    ts = torch.from_numpy(rng.randn(2, 3 * n, 6).astype(np.float32))
    planes = assembly_kernels.hessian_planes_ensemble(coords, params)
    idx = torch.arange(n)
    # handed the planes' own diagonal superelements, bit for bit
    row_sums = planes[:, :, idx, idx].permute(1, 2, 0).contiguous()
    got = assembly_kernels.assembly_stitch(coords, params, scale_h, ts, 64,
                                           row_sums)
    ref = assembly_kernels.regularize_stitch(planes, scale_h, ts, 64)
    assert torch.equal(got, ref)


def test_assembly_stitch_checks_its_inputs():
    n = 10
    coords = torch.zeros(2, n, 3)
    scale_h = torch.ones(2, 3 * n)
    ts = torch.zeros(2, 3 * n, 6)
    rs = torch.zeros(2, n, 9)
    params = sct.invariant_params(7.0)
    with pytest.raises(ValueError, match="mp=16"):
        assembly_kernels.assembly_stitch(coords, params, scale_h, ts, 16, rs)
    with pytest.raises(ValueError, match="scale_h must be"):
        assembly_kernels.assembly_stitch(coords, params, scale_h[:, :-1],
                                         ts, 32, rs)
    with pytest.raises(ValueError, match=r"\(B, n, 3\)"):
        assembly_kernels.assembly_stitch(coords[0], params, scale_h, ts, 32,
                                         rs)
    table = sct.table_pair_params(np.zeros((n, n, 1)), None)
    with pytest.raises(ValueError, match="analytic"):
        assembly_kernels.assembly_stitch(coords, table, scale_h, ts, 32, rs)
    assert trigid.direct_prep_applies(params, n)
    assert not trigid.direct_prep_applies(table, n)
    assert not trigid.direct_prep_applies(
        params, assembly_kernels.MAX_ATOMS_STITCH + 1)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("with_masses", [False, True])
@pytest.mark.parametrize("with_covariance", [False, True])
def test_direct_slice_matches_jax(kind, with_masses, with_covariance):
    jparams, params = _params(kind)
    n = 30
    coords = _dense_coords(4, n, seed=n)
    masses = _masses(n) if with_masses else None
    options = dict(with_covariance=with_covariance,
                   with_prs=with_covariance)
    ref = jpipe.ensemble_anm_fluctuations(
        jnp.asarray(coords), jparams,
        masses=None if masses is None else jnp.asarray(masses),
        inverse="blocked", use_pallas=True, prep="direct",
        dtype=jnp.float32, **options)
    got = sct.ensemble_anm_fluctuations(
        coords, params, masses=masses, inverse="blocked", prep="direct",
        chunk=2, device="cpu", **options)
    assert set(got) == set(ref)
    for key in ref:
        assert tuple(got[key].shape) == tuple(ref[key].shape), key
        assert got[key].dtype == torch.float32
        assert _rel(got[key], ref[key]) <= 1e-4, key
    # and the port's own planes path, to float32 summation order
    planes = sct.ensemble_anm_fluctuations(
        coords, params, masses=masses, inverse="blocked", prep="planes",
        device="cpu", **options)
    for key in planes:
        assert _rel(got[key], planes[key]) <= 1e-4, key


def test_direct_float64_matches_cho_solve():
    """The plain fused prep runs in any dtype on the CPU: float64 direct
    against the float64 ``cho_solve`` engine."""
    coords = _dense_coords(2, 30, seed=1).astype(np.float64)
    params = sct.hinsen_params(7.0)
    direct = sct.ensemble_anm_fluctuations(
        coords, params, inverse="blocked", prep="direct", with_prs=True,
        dtype=torch.float64, device="cpu")
    ref = sct.ensemble_anm_fluctuations(
        coords, params, inverse="cho_solve", with_prs=True,
        dtype=torch.float64, device="cpu")
    for key in ref:
        assert _rel(direct[key], ref[key]) <= 1e-10, key


def _ca(load):
    atoms = load(os.path.join(DATA, "1l2y.pdb"), model=1)
    return atoms[(atoms.atom_name == "CA") & (atoms.element == "C")]


def test_direct_falls_through_for_a_tabulated_family():
    """``prep="direct"`` covers the analytic families; a tabulated one
    takes the planes path, as in the JAX package
    (``_fused_direct_applies``)."""
    ca = _ca(sct.load_structure)
    ff = sct.TabulatedForceField.e_anm(ca)
    coords = np.repeat(ca.coord[None], 2, axis=0)
    before = assembly_kernels.assembly_stitch.launches
    direct = sct.ensemble_anm_fluctuations(
        coords, ff, inverse="blocked", prep="direct", device="cpu")
    planes = sct.ensemble_anm_fluctuations(
        coords, ff, inverse="blocked", prep="planes", device="cpu")
    for key in planes:
        assert torch.equal(direct[key], planes[key]), key
    assert assembly_kernels.assembly_stitch.launches == before
    ref = jpipe.ensemble_anm_fluctuations(
        jnp.asarray(coords),
        sc.TabulatedForceField.e_anm(_ca(jload)).to_compact_params(),
        inverse="blocked", use_pallas=True, prep="direct",
        dtype=jnp.float32)
    for key in ref:
        assert _rel(direct[key], ref[key]) <= 1e-4, key


# ---------------------------------------------------------------------------
# Panel Cholesky, full-window panel inverse, blocked inverse
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pb", [16, 64, 128])
def test_panel_cholesky_matches_jax_kernel(pb):
    panels = _equilibrated_spd(4, pb, seed=pb)
    ref_l, ref_w = pallas_linalg.panel_cholesky_batched(
        jnp.asarray(panels), interpret=True)

    before = spd_linalg.panel_cholesky.launches
    got_l, got_w = sct.panel_cholesky_batched(torch.from_numpy(panels))
    assert spd_linalg.panel_cholesky.launches == before
    assert got_l.dtype == torch.float32 and got_l.shape == (4, pb, pb)
    assert np.max(np.abs(got_l.numpy() - np.asarray(ref_l))) <= 2e-5
    assert _rel(got_w, ref_w) <= 1e-5
    upper = torch.triu(got_l, diagonal=1)
    assert torch.equal(upper, torch.zeros_like(upper))
    # L L^T = A, and W = L^-1
    a = torch.from_numpy(panels).double()
    assert float((got_l.double() @ got_l.double().transpose(-1, -2)
                  - a).abs().max()) < 1e-5
    assert float((got_w.double() @ got_l.double()
                  - torch.eye(pb)).abs().max()) < 1e-4
    assert np.max(np.abs(
        got_l.numpy() - np.linalg.cholesky(panels.astype(np.float64)))) \
        <= 2e-5


def test_panel_cholesky_breakdown_is_not_finite():
    panels = _equilibrated_spd(3, 16, seed=2)
    panels[1, 5, 5] = -1.0                     # not SPD
    got = spd_linalg.panel_cholesky_plain(torch.from_numpy(panels))
    assert not torch.isfinite(got[1]).all()
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[2]).all()
    ref, _ = pallas_linalg.panel_cholesky_batched(jnp.asarray(panels),
                                                  interpret=True)
    assert not np.isfinite(np.asarray(ref)[1]).all()


@pytest.mark.parametrize("shape", [(4, 16, 8), (4, 12, 12), (16, 16)])
def test_panel_cholesky_rejects_bad_shapes(shape):
    with pytest.raises(ValueError):
        spd_linalg.panel_cholesky(torch.zeros(shape))
    with pytest.raises(ValueError):
        spd_linalg.panel_inverse_full(torch.zeros(shape))


@pytest.mark.parametrize("pb", [8, 16, 24, 32, 64])
def test_panel_inverse_full_window_matches_jax_kernel(pb):
    panels = _equilibrated_spd(5, pb, seed=pb)
    ref = np.asarray(pallas_linalg.panel_inverse_batched(
        jnp.asarray(panels), shrink_block=None, interpret=True))
    before = (spd_linalg.panel_inverse_full.launches,
              spd_linalg.panel_inverse_batched.launches)
    got = sct.panel_inverse_batched(torch.from_numpy(panels),
                                    shrink_block=None)
    assert (spd_linalg.panel_inverse_full.launches,
            spd_linalg.panel_inverse_batched.launches) == before
    assert np.max(np.abs(got.numpy() - ref)) <= 2e-5
    # the two forms agree bit for bit, in the JAX package and here
    shrink = np.asarray(pallas_linalg.panel_inverse_batched(
        jnp.asarray(panels), shrink_block=8, interpret=True))
    assert np.array_equal(ref, shrink)
    assert torch.equal(got, sct.panel_inverse_batched(
        torch.from_numpy(panels), shrink_block=8))
    assert torch.equal(got, spd_linalg.panel_inverse_full(
        torch.from_numpy(panels)))


def test_panel_inverse_shrink_block_rules():
    panels = torch.from_numpy(_equilibrated_spd(2, 16, seed=1))
    ref = sct.panel_inverse_batched(panels)
    for block in (1, 4, 16):
        assert torch.equal(sct.panel_inverse_batched(
            panels, shrink_block=block), ref)
    for block in (0, 3, 32):
        with pytest.raises(ValueError, match="shrink_block"):
            sct.panel_inverse_batched(panels, shrink_block=block)
    bad = panels.clone()
    bad[1, 5, 5] = -1.0
    assert not torch.isfinite(sct.panel_inverse_batched(
        bad, shrink_block=None)[1]).all()


@pytest.mark.parametrize("m", [40, 90, 300])
def test_spd_inverse_blocked_matches_jax(m):
    a = _equilibrated_spd(2, m, seed=m)
    ref = np.asarray(pallas_linalg.spd_inverse_blocked(jnp.asarray(a),
                                                       interpret=True))
    got = sct.spd_inverse_blocked(torch.from_numpy(a))
    assert got.shape == (2, m, m)
    assert _rel(got, ref) <= 1e-5
    np.testing.assert_allclose(got.numpy(),
                               np.linalg.inv(a.astype(np.float64)),
                               atol=2e-4)
    batched = sct.spd_inverse_blocked(
        torch.from_numpy(np.stack([a, a])))          # (2, 2, m, m)
    assert torch.equal(batched[1], got)


def test_kernel_wrappers_lists_the_new_kernels():
    wrappers = sct.kernel_wrappers()
    assert len(wrappers) == 14
    for name in ("assembly_stitch", "panel_cholesky", "panel_inverse_full"):
        assert wrappers[name].launches == 0
