"""
PyTorch port, ``GNM`` on ``device="cpu"`` in float64: every dense
observable against the JAX package's ``GNM`` on the same structure and
force field (x64 on), the ProDy golden files of ``tests/test_gnm.py`` at
its tolerances (1l2y; 7cal against the JAX package, the file's one 7cal
eigendecomposition of 1,776 rows), the duals and their setters,
``lowest_modes`` dense (shift-invert; the JAX method's Pallas kernels in
interpret mode) and matrix-free with their float64 refinement, and the
matrix-free DCC rows.

Tolerances: eigenvalues within 1e-10 of max|lambda|, the
covariance-derived outputs within 1e-8 of max|x|, refined eigenvalues to
1e-6 relative, the float32 CG rows to 1e-4 of max|x|.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import springcraft_tpu as sc  # noqa: E402
import springcraft_tpu_torch as sct  # noqa: E402

from .conftest import load_csv  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.realpath(__file__)), "data")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the mode solvers run many small products and
    decompositions, and under pytest-xdist every worker's OpenMP pool
    would spin on all cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ca(module, name):
    atoms = module.load_structure(os.path.join(DATA, f"{name}.pdb"), model=1)
    return atoms[(atoms.atom_name == "CA") & (atoms.element == "C")]


@pytest.fixture(scope="module")
def cas():
    return _ca(sc.structure, "1l2y"), _ca(sct, "1l2y")


def _rel(got, ref):
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


MODELS = [
    ("invariant7", lambda m, ca: m.InvariantForceField(7.0), None),
    ("invariant13_masses", lambda m, ca: m.InvariantForceField(13.0), True),
    ("eanm", lambda m, ca: m.TabulatedForceField.e_anm(ca), None),
    ("pfenm_masses", lambda m, ca: m.ParameterFreeForceField(), "arange"),
]


@pytest.fixture(scope="module", params=MODELS, ids=[m[0] for m in MODELS])
def pair(request, cas):
    _, make, masses = request.param
    jca, tca = cas
    if masses == "arange":
        masses = np.arange(1, tca.array_length() + 1, dtype=float)
    return (sc.GNM(jca, make(sc, jca), masses=masses),
            sct.GNM(tca, make(sct, tca), masses=masses, device="cpu"))


@pytest.mark.parametrize("observable", [
    "eigenvalues", "frequencies", "kirchhoff", "covariance", "msf",
    "msf_subset", "bfactor", "dcc", "dcc_absolute_tem", "dcc_subset"])
def test_observables_match_jax(pair, observable):
    jm, tm = pair
    get = {
        "eigenvalues": lambda m: m.eigen()[0],
        "frequencies": lambda m: m.frequencies()[1:],
        "kirchhoff": lambda m: m.kirchhoff,
        "covariance": lambda m: m.covariance,
        "msf": lambda m: m.mean_square_fluctuation(),
        "msf_subset": lambda m: m.mean_square_fluctuation(
            mode_subset=np.arange(3, 15)),
        "bfactor": lambda m: m.bfactor(tem=300),
        "dcc": lambda m: m.dcc(),
        "dcc_absolute_tem": lambda m: m.dcc(norm=False, tem=310),
        "dcc_subset": lambda m: m.dcc(mode_subset=np.arange(1, 12)),
    }[observable]
    ref = np.asarray(get(jm))
    got = get(tm)
    assert isinstance(got, np.ndarray) and got.shape == ref.shape
    tol = 1e-10 if observable in ("eigenvalues", "frequencies") else 1e-8
    if observable == "kirchhoff":
        tol = 1e-12
    assert _rel(got, ref) <= tol


@pytest.mark.parametrize("cutoff", [4, 7, 13])
def test_kirchhoff_vs_prody(cas, cutoff):
    gnm = sct.GNM(cas[1], sct.InvariantForceField(cutoff), device="cpu")
    assert np.allclose(gnm.kirchhoff, load_csv(
        f"prody_gnm_{cutoff}_ang_cutoff_kirchhoff_1l2y.csv.gz"))


# as in tests/test_gnm.py: larger cutoffs give degenerate eigenvalues
@pytest.mark.parametrize("cutoff", [4, 7])
def test_eigen_fluctuation_dcc_vs_prody(cas, cutoff):
    gnm = sct.GNM(cas[1], sct.InvariantForceField(cutoff), device="cpu")
    vals, vecs = gnm.eigen()
    ref_vals = load_csv(f"prody_gnm_{cutoff}_ang_cutoff_evals_1l2y.csv.gz")
    ref_vecs = load_csv(f"prody_gnm_{cutoff}_ang_cutoff_evecs_1l2y.csv.gz")
    vecs = vecs * np.sign(vecs[:, 0])[:, None]
    ref_vecs = ref_vecs * np.sign(ref_vecs[:, 0])[:, None]
    assert np.allclose(vals[1:], ref_vals[1:])
    assert vecs[1:].flatten().tolist() == pytest.approx(
        ref_vecs[1:].flatten().tolist())
    assert np.allclose(gnm.mean_square_fluctuation(), load_csv(
        f"prody_gnm_{cutoff}_ang_cutoff_fluctuations_1l2y.csv.gz"))
    assert np.allclose(gnm.dcc(), load_csv(
        f"prody_gnm_{cutoff}_ang_cutoff_dcc_norm_1l2y.csv.gz"))
    assert np.allclose(gnm.dcc(mode_subset=np.arange(1, 17)), load_csv(
        f"prody_gnm_{cutoff}_ang_cutoff_dcc_norm_subset_1l2y.csv.gz"))
    assert np.allclose(gnm.dcc(norm=False), load_csv(
        f"prody_gnm_{cutoff}_ang_cutoff_dcc_absolute_1l2y.csv.gz"))


def test_7cal_matches_jax():
    """7cal's CA trace (four chains), its one eigendecomposition: the
    spectrum and MSF against the JAX package."""
    jm = sc.GNM(_ca(sc.structure, "7cal"), sc.InvariantForceField(7.0))
    tm = sct.GNM(_ca(sct, "7cal"), sct.InvariantForceField(7.0),
                 device="cpu")
    ref = jm.eigen()[0]
    assert np.abs(tm.eigen()[0] - ref).max() <= 1e-10 * np.abs(ref).max()
    assert _rel(tm.mean_square_fluctuation(),
                jm.mean_square_fluctuation()) <= 1e-8


def test_duals_and_setters(cas):
    """Assigning the Kirchhoff matrix or the covariance invalidates the
    other and the eigensystem; the covariance's dual is its
    pseudo-inverse (``rcond=1e-6``); wrong shapes raise as in the JAX
    package."""
    tca = cas[1]
    gnm = sct.GNM(tca, sct.InvariantForceField(7.0), device="cpu")
    kirchhoff, cov = gnm.kirchhoff, gnm.covariance
    vals = gnm.eigen()[0]
    gnm.kirchhoff = 2.0 * kirchhoff
    assert np.allclose(gnm.eigen()[0], 2.0 * vals)
    assert np.allclose(gnm.covariance, cov / 2.0)
    fresh = sct.GNM(tca, sct.InvariantForceField(7.0), device="cpu")
    fresh.covariance = cov
    assert np.allclose(fresh.kirchhoff, np.linalg.pinv(cov, hermitian=True,
                                                       rcond=1e-6))
    assert np.allclose(fresh.covariance, cov)
    out = gnm.kirchhoff
    out[:] = 0.0
    assert np.allclose(gnm.kirchhoff, 2.0 * kirchhoff)
    with pytest.raises(ValueError):
        gnm.kirchhoff = np.zeros((3, 3))
    with pytest.raises(IndexError):
        gnm.covariance = np.zeros((3, 3))
    with pytest.raises(ValueError, match="Trivial"):
        fresh.mean_square_fluctuation(mode_subset=np.array([0, 3]))


@pytest.fixture(scope="module")
def fragments():
    jca, tca = _ca(sc.structure, "7cal")[:150], _ca(sct, "7cal")[:150]
    masses = np.linspace(50.0, 150.0, 150)
    return (sc.GNM(jca, sc.InvariantForceField(7.0), masses=masses),
            sct.GNM(tca, sct.InvariantForceField(7.0), masses=masses,
                    device="cpu"))


@pytest.mark.parametrize("matrix_free", [False, True])
def test_lowest_modes_match_jax_and_the_dense_spectrum(fragments,
                                                       matrix_free):
    jm, tm = fragments
    vals, vecs, res = tm.lowest_modes(5, matrix_free=matrix_free,
                                      refine=True)
    ref_vals = np.asarray(jm.lowest_modes(5, matrix_free=matrix_free,
                                          refine=True)[0])
    dense = tm.eigen()[0][1:6]
    assert vals.shape == (5,) and vecs.shape == (5, 150)
    assert np.abs(vals - dense).max() / np.abs(dense).max() <= 1e-6
    assert np.abs(vals - ref_vals).max() / np.abs(dense).max() <= 1e-6
    r = tm.kirchhoff @ vecs.T - vecs.T * vals[None, :]
    np.testing.assert_allclose(np.linalg.norm(r, axis=0) / vals, res,
                               rtol=1e-6)


def test_matrix_free_dcc_rows_match_jax(fragments):
    jm, tm = fragments
    msf = tm.mean_square_fluctuation()
    sites = np.array([2, 40, 149])
    rows = tm.dcc(matrix_free=True, sites=sites, msf=msf)
    ref = np.asarray(jm.dcc(matrix_free=True, sites=sites, msf=msf))
    assert rows.shape == (3, 150)
    assert _rel(rows, ref) <= 1e-4
    assert _rel(rows, tm.dcc()[sites]) <= 1e-4
    plain = tm.dcc(matrix_free=True, sites=sites, norm=False, tem=300)
    assert _rel(plain, tm.dcc(norm=False, tem=300)[sites]) <= 1e-4
