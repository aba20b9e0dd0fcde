"""
PyTorch port, covariance layer: the Kirchhoff and the xyz-layout Hessian
assembly (plain versions of the ``kirchhoff`` and ``hessian_xyz`` CUDA
kernels), the mass weighting, the full inverse factor, the
lower-triangular Gram, both covariance engines and the batched PRS
observables, each held against the JAX package on the same numpy inputs
(its Pallas kernels in interpret mode on the CPU).

Tolerances: the assembly repeats the JAX kernels' arithmetic except for
the diagonal's summation order (1e-5 of max, as for the Hessian planes);
the inverse factor and the float32 covariance add float32 matrix
products whose summation order differs between XLA and PyTorch (1e-5 of
max); a Gram of exact inputs differs only in that order (1e-6); the
float64 engines agree to 1e-10 and elementwise observables to 1e-12.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from springcraft_tpu.ops import ffparams as jff  # noqa: E402
from springcraft_tpu.ops import pallas_kernels, pallas_linalg  # noqa: E402
from springcraft_tpu.ops import rigid as jrigid  # noqa: E402
from springcraft_tpu.parallel import pipeline as jpipe  # noqa: E402
import springcraft_tpu_torch as sct  # noqa: E402
from springcraft_tpu_torch.ops import assembly, assembly_kernels  # noqa: E402
from springcraft_tpu_torch.ops import nma_core as tcore  # noqa: E402
from springcraft_tpu_torch.ops import rigid as trigid  # noqa: E402
from springcraft_tpu_torch.ops import spd_linalg  # noqa: E402
from springcraft_tpu_torch.parallel import pipeline as tpipe  # noqa: E402

KINDS = ("invariant", "hinsen", "pfenm")


def _dense_coords(b, n, seed):
    # connected at a 7 A cutoff (see tests/test_pallas_linalg.py)
    rng = np.random.RandomState(seed)
    base = (rng.rand(n, 3) * 6.0).astype(np.float32)
    return base[None] + 0.05 * rng.randn(b, n, 3).astype(np.float32)


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


# ---------------------------------------------------------------------------
# Assembly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_kirchhoff_matches_pallas_kernels(kind):
    """The plain version against both TPU kernels it stands for: the
    ensemble kernel and the vmapped single-structure kernel."""
    coords = _dense_coords(3, 41, seed=17)
    jparams = getattr(jff, f"{kind}_params")(7.0)
    ref_ensemble = np.asarray(pallas_kernels.kirchhoff_pallas_ensemble(
        jnp.asarray(coords), jparams, dtype=jnp.float32, interpret=True))
    ref_single = np.asarray(jax.vmap(
        lambda c: pallas_kernels.kirchhoff_pallas(
            c, jparams, dtype=jnp.float32, interpret=True))(
                jnp.asarray(coords)))

    before = assembly_kernels.kirchhoff_ensemble.launches
    got = assembly_kernels.kirchhoff_ensemble(
        torch.from_numpy(coords), getattr(sct, f"{kind}_params")(7.0))
    # a CPU tensor takes the plain version and launches nothing
    assert assembly_kernels.kirchhoff_ensemble.launches == before
    assert got.shape == (3, 41, 41) and got.dtype == torch.float32
    assert _rel(got, ref_ensemble) <= 1e-5
    assert _rel(got, ref_single) <= 1e-5
    # rows sum to zero: the constant vector is the null mode
    assert float(got.sum(dim=-1).abs().max()) <= 1e-5 * float(
        got.abs().max())


@pytest.mark.parametrize("n,kind", [(41, "invariant"), (41, "hinsen"),
                                    (41, "pfenm"), (130, "invariant")])
def test_hessian_xyz_matches_hessian_pallas(n, kind):
    coords = _dense_coords(2, n, seed=n)
    jparams = getattr(jff, f"{kind}_params")(7.0)
    ref = np.asarray(jax.vmap(
        lambda c: pallas_kernels.hessian_pallas(
            c, jparams, dtype=jnp.float32, interpret=True))(
                jnp.asarray(coords)))
    before = assembly_kernels.hessian_xyz_ensemble.launches
    got = assembly_kernels.hessian_xyz_ensemble(
        torch.from_numpy(coords), getattr(sct, f"{kind}_params")(7.0))
    assert assembly_kernels.hessian_xyz_ensemble.launches == before
    assert got.shape == (2, 3 * n, 3 * n) and got.dtype == torch.float32
    assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("xyz", [False, True])
def test_mass_weight_matches_jax(xyz):
    rng = np.random.RandomState(6)
    n = 12
    m = 3 * n if xyz else n
    matrix = rng.randn(m, m)
    masses = rng.rand(n) + 0.5
    if xyz:
        ref = jpipe._mass_weight_xyz(jnp.asarray(matrix), jnp.asarray(masses))
    else:
        ref = jpipe._mass_weight(jnp.asarray(matrix), jnp.asarray(masses),
                                 repeat3=False)
    got = tpipe._mass_weight(torch.from_numpy(matrix),
                             torch.from_numpy(masses), xyz=xyz)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12)
    assert tpipe._mass_weight(got, None) is got


@pytest.mark.parametrize("bad", [(2, 10), (2, 10, 2)])
def test_assembly_wrappers_reject_bad_shapes(bad):
    params = sct.invariant_params(7.0)
    for wrapper in (assembly_kernels.kirchhoff_ensemble,
                    assembly_kernels.hessian_xyz_ensemble):
        with pytest.raises(ValueError, match="coords"):
            wrapper(torch.zeros(bad), params)


# ---------------------------------------------------------------------------
# Inverse factor and Gram
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [90, 300])
def test_spd_inverse_factor_matches_jax(m):
    a = _equilibrated_spd(2, m, seed=m + 1)
    ref = np.asarray(pallas_linalg.spd_inverse_factor(jnp.asarray(a),
                                                      interpret=True))
    got = spd_linalg.spd_inverse_factor(torch.from_numpy(a))
    mp = spd_linalg.padded_size(m)
    assert got.shape == ref.shape == (2, mp, mp)
    assert _rel(got, ref) <= 1e-5
    upper = torch.triu(got, diagonal=1)
    assert torch.equal(upper, torch.zeros_like(upper))
    # the same blocks as the top-split form
    g11, g21, g22 = spd_linalg.spd_inverse_factor_parts(torch.from_numpy(a))
    h = g11.shape[-1]
    assert torch.equal(got[:, :h, :h], g11)
    assert torch.equal(got[:, h:, :h], g21)
    assert torch.equal(got[:, h:, h:], g22)
    inv = (got.double().transpose(-1, -2) @ got.double())[:, :m, :m]
    np.testing.assert_allclose(
        inv.numpy(), np.linalg.inv(a.astype(np.float64)), atol=2e-4)


@pytest.mark.parametrize("mp", [128, 384])
def test_gram_lower_matches_full_gram_and_jax(mp):
    rng = np.random.RandomState(mp)
    w = np.tril(rng.randn(2, mp, mp)).astype(np.float32)
    w = w * (rng.rand(mp) + 0.5).astype(np.float32)[None, None, :]
    got = trigid._gram_lower(torch.from_numpy(w))
    full = torch.from_numpy(w).transpose(-1, -2) @ torch.from_numpy(w)
    ref = np.asarray(jrigid._gram_lower(jnp.asarray(w)))
    assert got.shape == (2, mp, mp)
    assert _rel(got, full) <= 1e-6
    assert _rel(got, ref) <= 1e-6


# ---------------------------------------------------------------------------
# Covariance engines
# ---------------------------------------------------------------------------

def _anm_problem(dtype):
    coords = torch.from_numpy(_dense_coords(2, 30, seed=21).astype(dtype))
    matrix = assembly.hessian_xyz_plain(coords, sct.invariant_params(7.0))
    return matrix, trigid.rigid_modes_anm(coords)


def _gnm_problem(dtype):
    coords = torch.from_numpy(_dense_coords(2, 30, seed=22).astype(dtype))
    matrix = assembly.kirchhoff_plain(coords, sct.invariant_params(7.0))
    dt = torch.float32 if dtype == np.float32 else torch.float64
    return matrix, trigid.null_mode_gnm(30, dtype=dt, device="cpu")


@pytest.mark.parametrize("problem", [_anm_problem, _gnm_problem])
@pytest.mark.parametrize("inverse,dtype,tol", [
    ("blocked", np.float32, 1e-5), ("cho_solve", np.float64, 1e-10)])
def test_covariance_cholesky_matches_jax(problem, inverse, dtype, tol):
    """Both engines from dense matrices, same inputs in both packages:
    the ANM Hessian with a per-conformer rigid basis, the GNM Kirchhoff
    matrix with the shared constant mode."""
    matrix, basis = problem(dtype)
    ref = jrigid.covariance_cholesky(
        jnp.asarray(matrix.numpy()), jnp.asarray(basis.numpy()),
        inverse=inverse, interpret=True)
    got = trigid.covariance_cholesky(matrix, basis, inverse=inverse)
    assert got.shape == matrix.shape and got.dtype == matrix.dtype
    assert _rel(got, ref) <= tol
    with pytest.raises(ValueError, match="engine"):
        trigid.covariance_cholesky(matrix, basis, inverse="eigh")


def test_covariance_from_planes_matches_float64_engine():
    """The stitch-fed blocked engine (masses folded into its scale)
    against the float64 Cholesky engine on the mass-weighted Hessian."""
    coords = torch.from_numpy(_dense_coords(2, 30, seed=23))
    params = sct.hinsen_params(7.0)
    masses = torch.linspace(0.8, 2.5, 30)
    bases = trigid.rigid_modes_anm(coords, masses=masses)
    got = trigid.covariance_cholesky_from_planes(
        assembly.hessian_planes_plain(coords, params), 30, bases,
        masses=masses)
    hessians = tpipe._mass_weight(
        assembly.hessian_xyz_plain(coords.double(), params),
        masses.double(), xyz=True)
    ref = trigid.covariance_cholesky(
        hessians, trigid.rigid_modes_anm(coords.double(),
                                         masses=masses.double()))
    assert got.shape == (2, 90, 90) and got.dtype == torch.float32
    assert _rel(got, ref) <= 1e-4


def test_cho_solve_engine_marks_breakdown_not_finite():
    matrix, basis = _gnm_problem(np.float64)
    broken = matrix.clone()
    broken[1] = -broken[1]                            # not PSD
    got = trigid.covariance_cholesky(broken, basis)
    assert torch.isfinite(got[0]).all()
    assert not torch.isfinite(got[1]).any()


# ---------------------------------------------------------------------------
# Batched PRS observables
# ---------------------------------------------------------------------------

def _spd_covariances(b, n, seed):
    rng = np.random.RandomState(seed)
    a = rng.randn(b, 3 * n, 3 * n)
    return a @ a.transpose(0, 2, 1)


def test_batched_prs_equals_per_conformer_loop():
    covs = torch.from_numpy(_spd_covariances(3, 8, seed=5))
    prs = tcore.prs_matrix(covs, layout="xyz")
    effector, sensor = tcore.effector_sensor_profiles(prs)
    assert prs.shape == (3, 8, 8) and effector.shape == sensor.shape == (3, 8)
    for i in range(3):
        one = tcore.prs_matrix(covs[i], layout="xyz")
        assert torch.allclose(prs[i], one, rtol=1e-13, atol=0)
        for got, ref in zip((effector[i], sensor[i]),
                            tcore.effector_sensor_profiles(one)):
            assert torch.allclose(got, ref, rtol=1e-13, atol=0)
    # the atom-layout fold of the permuted covariance is the same matrix
    perm = torch.arange(24).reshape(3, 8).T.reshape(-1)   # atom <- xyz
    atom = covs[:, perm][:, :, perm]
    assert torch.allclose(tcore.prs_matrix(atom), prs, rtol=1e-13, atol=0)
    with pytest.raises(ValueError, match="layout"):
        tcore.prs_matrix(covs, layout="planes")


def test_xyz_prs_matches_jax_pipeline_fold():
    """The port's xyz fold against the JAX pipeline's
    (``pipeline.py:658-673``), and the observables around it."""
    covs = _spd_covariances(2, 7, seed=8)
    got = tpipe._anm_cov_observables(torch.from_numpy(covs), 7, True, True)
    for i in range(2):
        ref = jpipe._anm_cov_observables(jnp.asarray(covs[i]), 7, True,
                                         True)
        assert set(got) == set(ref)
        for key in ref:
            np.testing.assert_allclose(got[key][i].numpy(),
                                       np.asarray(ref[key]), rtol=1e-12,
                                       err_msg=key)


# ---------------------------------------------------------------------------
# sigma=, block_size=, layout="atom", pinv_diagonal (float64 against JAX)
# ---------------------------------------------------------------------------

SIGMAS = (None, 2.5, "per-matrix")


def _sigma(sigma, batch):
    if sigma == "per-matrix":
        return np.linspace(1.5, 4.0, batch)
    return sigma


@pytest.mark.parametrize("sigma", SIGMAS)
@pytest.mark.parametrize("problem", [_anm_problem, _gnm_problem])
def test_covariance_cholesky_sigma_matches_jax(problem, sigma):
    matrix, basis = problem(np.float64)
    s = _sigma(sigma, matrix.shape[0])
    ref = jrigid.covariance_cholesky(jnp.asarray(matrix.numpy()),
                                     jnp.asarray(basis.numpy()), sigma=s)
    got = trigid.covariance_cholesky(matrix, basis, sigma=s)
    assert _rel(got, ref) <= 1e-10
    # the pseudo-inverse does not depend on the weight of the null space
    assert _rel(got, trigid.covariance_cholesky(matrix, basis)) <= 1e-10


@pytest.mark.parametrize("sigma", SIGMAS)
def test_covariance_plane_traces_sigma_matches_jax(sigma):
    matrix, basis = _anm_problem(np.float64)
    s = _sigma(sigma, matrix.shape[0])
    ref = jrigid.covariance_plane_traces(jnp.asarray(matrix.numpy()),
                                         jnp.asarray(basis.numpy()), sigma=s)
    got = trigid.covariance_plane_traces(matrix, basis, sigma=s)
    assert _rel(got, ref) <= 1e-10


@pytest.mark.parametrize("sigma", [2.5, "per-matrix"])
@pytest.mark.parametrize("route", ["dense", "planes", "direct"])
@pytest.mark.parametrize("what", ["traces", "covariance"])
def test_blocked_engines_take_sigma(route, what, sigma):
    """The three float32 blocked routes with a given sigma: the
    regularized factor input is JAX's for that sigma, and the result
    stays the float64 pseudo-inverse."""
    coords = torch.from_numpy(_dense_coords(2, 30, seed=24))
    params = sct.invariant_params(7.0)
    basis = trigid.rigid_modes_anm(coords)
    s = _sigma(sigma, 2)
    h32 = assembly.hessian_xyz_plain(coords, params)
    fn = {"traces": "covariance_plane_traces",
          "covariance": "covariance_cholesky"}[what]
    if route == "dense":
        got = getattr(trigid, fn)(h32, basis, sigma=s, inverse="blocked")
        reg, _, sig = trigid._regularize_equilibrated(h32, basis, sigma=s)
    elif route == "planes":
        planes = assembly.hessian_planes_plain(coords, params)
        got = getattr(trigid, f"{fn}_from_planes")(planes, 30, basis,
                                                   sigma=s)
        reg, _, sig = trigid._regularize_equilibrated_planes(
            planes, 30, basis, sigma=s)
        reg = reg[:, :90, :90]
    else:
        got = getattr(trigid, f"{fn}_direct")(coords, params, basis,
                                              sigma=s)
        reg, _, sig = trigid._regularize_equilibrated_direct(
            coords, params, basis, sigma=s)
        reg = reg[:, :90, :90]
    assert torch.equal(sig.reshape(-1).double(),
                       torch.as_tensor(s, dtype=torch.float64).reshape(-1)
                       .expand(sig.numel()))
    jreg, _, _ = jrigid._regularize_equilibrated(
        jnp.asarray(h32.numpy()), jnp.asarray(basis.numpy()),
        jnp.asarray(s, jnp.float32) if s is not None else None)
    assert _rel(reg, jreg) <= 1e-5
    ref = getattr(trigid, fn)(h32.double(), basis.double())
    assert _rel(got, ref) <= 1e-4


@pytest.mark.parametrize("block_size", [10, 45, 90])
@pytest.mark.parametrize("sigma", [None, 2.5])
def test_covariance_cholesky_block_size_matches_jax(block_size, sigma):
    matrix, basis = _anm_problem(np.float64)
    matrix, basis = matrix[0], basis[0]
    ref = jrigid.covariance_cholesky(jnp.asarray(matrix.numpy()),
                                     jnp.asarray(basis.numpy()), sigma=sigma,
                                     block_size=block_size)
    got = trigid.covariance_cholesky(matrix, basis, sigma=sigma,
                                     block_size=block_size)
    assert _rel(got, ref) <= 1e-10
    assert _rel(got, trigid.covariance_cholesky(matrix, basis)) <= 1e-12


def test_covariance_cholesky_block_size_rules():
    matrix, basis = _anm_problem(np.float64)
    with pytest.raises(ValueError, match="divide"):
        trigid.covariance_cholesky(matrix[0], basis[0], block_size=7)
    with pytest.raises(ValueError, match="block_size"):
        trigid.covariance_cholesky(matrix[0].float(), basis[0].float(),
                                   block_size=10, inverse="blocked")
    # a batch solves the whole identity at once, as in the JAX package
    assert _rel(trigid.covariance_cholesky(matrix, basis, block_size=7),
                trigid.covariance_cholesky(matrix, basis)) <= 1e-12


@pytest.mark.parametrize("masses", [False, True])
def test_rigid_modes_atom_layout_matches_jax(masses):
    coords = _dense_coords(1, 30, seed=25)[0].astype(np.float64)
    m = np.linspace(0.8, 2.5, 30) if masses else None
    for layout in ("atom", "xyz"):
        ref = np.asarray(jrigid.rigid_modes_anm(coords, masses=m,
                                                layout=layout))
        got = trigid.rigid_modes_anm(
            torch.from_numpy(coords),
            masses=None if m is None else torch.from_numpy(m),
            layout=layout).numpy()
        # same span: the projectors agree
        assert np.max(np.abs(got @ got.T - ref @ ref.T)) <= 1e-10
        assert np.max(np.abs(got.T @ got - np.eye(6))) <= 1e-12
    atom = trigid.rigid_modes_anm(torch.from_numpy(coords), layout="atom")
    hessian = assembly.hessian_matrix(torch.from_numpy(coords),
                                      sct.invariant_params(7.0))
    assert float((hessian @ atom).abs().max()) <= 1e-10
    with pytest.raises(ValueError, match="layout"):
        trigid.rigid_modes_anm(torch.from_numpy(coords), layout="planes")


@pytest.mark.parametrize("block_size", [15, 45, 90])
@pytest.mark.parametrize("sigma", [None, 2.5])
@pytest.mark.parametrize("problem", [_anm_problem, _gnm_problem])
def test_pinv_diagonal_matches_jax(problem, sigma, block_size):
    matrix, basis = problem(np.float64)
    matrix, basis = matrix[0], basis[0] if basis.ndim == 3 else basis
    m = matrix.shape[0]
    if m % block_size:
        block_size = m
    ref = jrigid.pinv_diagonal(jnp.asarray(matrix.numpy()),
                               jnp.asarray(basis.numpy()), sigma=sigma,
                               block_size=block_size)
    got = trigid.pinv_diagonal(matrix, basis, sigma=sigma,
                               block_size=block_size)
    assert got.shape == (m,) and _rel(got, ref) <= 1e-10
    full = trigid.covariance_cholesky(matrix, basis)
    assert _rel(got, torch.diagonal(full)) <= 1e-10


def test_pinv_diagonal_donate_overwrites_its_input():
    matrix, basis = _anm_problem(np.float64)
    matrix, basis = matrix[0].clone(), basis[0]
    ref = trigid.pinv_diagonal(matrix, basis, block_size=45)
    kept = matrix.clone()
    got = trigid.pinv_diagonal(matrix, basis, block_size=45, donate=True)
    assert _rel(got, ref) <= 1e-12
    assert not torch.equal(matrix, kept)
    with pytest.raises(ValueError, match="unbatched"):
        trigid.pinv_diagonal(kept[None], basis)
    with pytest.raises(ValueError, match="divide"):
        trigid.pinv_diagonal(kept, basis, block_size=7)
