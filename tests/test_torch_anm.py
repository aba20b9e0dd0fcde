"""
PyTorch port, ``ANM`` on ``device="cpu"`` in float64: every dense
observable against the JAX package's ``ANM`` on the same structure and
force field (x64 on), the golden files of ``tests/test_anm.py`` at its
tolerances (ProDy, bio3d and BioPhysConnectoR on 1l2y; eANM's
eigenvalues and MSF on 7cal, this file's one dense 7cal
eigendecomposition), ``lowest_modes`` dense (shift-invert, the JAX
method's Pallas kernels in interpret mode) and matrix-free with its
float64 refinement, and the matrix-free linear response and DCC rows.

Tolerances: eigenvalues within 1e-10 of max|lambda|; the
covariance-derived outputs (MSF, B-factors, DCC, PRS, linear response)
within 1e-8 of max|x|; refined ``lowest_modes`` eigenvalues to 1e-6
relative; the matrix-free CG outputs (float32 on the JAX side too) to
1e-4 of max|x|.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import springcraft_tpu as sc  # noqa: E402
import springcraft_tpu_torch as sct  # noqa: E402
from springcraft_tpu_torch.structure import check_res_id_continuity  # noqa: E402,E501

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
K_B = 1.380649e-23
N_A = 6.02214076e23


def _ca(module, name):
    atoms = module.load_structure(os.path.join(DATA, f"{name}.pdb"), model=1)
    return atoms[(atoms.atom_name == "CA") & (atoms.element == "C")]


@pytest.fixture(scope="module")
def cas():
    return _ca(sc.structure, "1l2y"), _ca(sct, "1l2y")


def _rel(got, ref):
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


#: (name, maker(package module, CA trace), masses) of the compared models.
MODELS = [
    ("invariant13", lambda m, ca: m.InvariantForceField(13.0), None),
    ("eanm_masses", lambda m, ca: m.TabulatedForceField.e_anm(ca), True),
    ("sdenm", lambda m, ca: m.TabulatedForceField.sd_enm(ca), None),
    ("hinsen_masses", lambda m, ca: m.HinsenForceField(), "arange"),
]


@pytest.fixture(scope="module", params=MODELS, ids=[m[0] for m in MODELS])
def pair(request, cas):
    """The JAX package's ANM and the port's on 1l2y."""
    _, make, masses = request.param
    jca, tca = cas
    if masses == "arange":
        masses = np.arange(1, tca.array_length() + 1, dtype=float)
    return (sc.ANM(jca, make(sc, jca), masses=masses),
            sct.ANM(tca, make(sct, tca), masses=masses, device="cpu"))


def test_eigen_matches_jax(pair):
    jm, tm = pair
    vals, vecs = tm.eigen()
    ref_vals, ref_vecs = jm.eigen()
    assert vals.dtype == np.float64 and vals.flags.writeable
    assert np.abs(vals - ref_vals).max() <= 1e-10 * np.abs(ref_vals).max()
    # modes agree up to sign on the non-degenerate non-trivial spectrum
    dots = np.abs(np.sum(vecs[6:] * ref_vecs[6:], axis=1))
    assert np.all(dots > 1 - 1e-8)
    assert _rel(tm.frequencies()[6:], jm.frequencies()[6:]) <= 1e-10
    vals[:] = 0.0
    assert np.abs(tm.eigen()[0] - ref_vals).max() <= 1e-10 * np.abs(
        ref_vals).max()


@pytest.mark.parametrize("observable", [
    "covariance", "msf", "msf_subset", "bfactor_tem", "dcc", "dcc_absolute",
    "dcc_subset", "prs", "effector", "sensor", "linear_response",
    "linear_response_flat", "normal_mode", "normal_mode_triangle"])
def test_observables_match_jax(pair, observable):
    jm, tm = pair
    n = len(tm._coord)
    force = np.random.RandomState(1).randn(n, 3)
    get = {
        "covariance": lambda m: m.covariance,
        "msf": lambda m: m.mean_square_fluctuation(),
        "msf_subset": lambda m: m.mean_square_fluctuation(
            mode_subset=np.arange(8, 30)),
        "bfactor_tem": lambda m: m.bfactor(tem=300, tem_factors=K_B * N_A),
        "dcc": lambda m: m.dcc(),
        "dcc_absolute": lambda m: m.dcc(norm=False, tem=300),
        "dcc_subset": lambda m: m.dcc(mode_subset=np.arange(6, 36)),
        "prs": lambda m: m.prs_effector_sensor()[0],
        "effector": lambda m: m.prs_effector_sensor(norm=False)[1],
        "sensor": lambda m: m.prs_effector_sensor()[2],
        "linear_response": lambda m: m.linear_response(force),
        "linear_response_flat": lambda m: m.linear_response(
            force.reshape(-1)),
        "normal_mode": lambda m: m.normal_mode(7, 2.0, 8),
        "normal_mode_triangle": lambda m: m.normal_mode(
            9, 1.0, 6, movement="triangle"),
    }[observable]
    ref = np.asarray(get(jm))
    got = get(tm)
    assert isinstance(got, np.ndarray) and got.shape == ref.shape
    if observable.startswith("normal_mode"):
        # a mode's sign is free
        got = got * np.sign(np.sum(got * ref))
    assert _rel(got, ref) <= 1e-8


def test_covariance_pseudoinverse(cas):
    anm = sct.ANM(cas[1], sct.InvariantForceField(13), device="cpu")
    hessian, covariance = anm.hessian, anm.covariance
    assert np.allclose(hessian, hessian @ covariance @ hessian)
    assert np.allclose(covariance, covariance @ hessian @ covariance)


def test_invariant_nma_vs_prody(cas):
    anm = sct.ANM(cas[1], sct.InvariantForceField(13), device="cpu")
    prody_evals = load_csv("prody_anm_13_ang_cutoff_evals_1l2y.csv.gz")
    assert np.allclose(anm.frequencies()[6:],
                       np.sqrt(prody_evals[6:]) / (2 * np.pi))
    assert np.allclose(anm.mean_square_fluctuation(tem=None), load_csv(
        "prody_anm_13_ang_cutoff_fluctuations_1l2y.csv.gz"))
    assert np.allclose(anm.dcc(), load_csv(
        "prody_anm_13_ang_cutoff_dcc_norm_1l2y.csv.gz"))
    assert np.allclose(anm.dcc(norm=False), load_csv(
        "prody_anm_13_ang_cutoff_dcc_absolute_1l2y.csv.gz"))
    assert np.allclose(anm.dcc(mode_subset=np.arange(6, 36)), load_csv(
        "prody_anm_13_ang_cutoff_dcc_norm_subset_1l2y.csv.gz"))
    prs_mat, eff, sens = anm.prs_effector_sensor()
    assert np.allclose(prs_mat, load_csv(
        "prody_anm_13_ang_cutoff_prs_mat_1l2y.csv.gz"))
    assert np.allclose(eff, load_csv(
        "prody_anm_13_ang_cutoff_prs_eff_1l2y.csv.gz"))
    assert np.allclose(sens, load_csv(
        "prody_anm_13_ang_cutoff_prs_sens_1l2y.csv.gz"))


def _bio3d_forcefield(ca, ff_name):
    if ff_name == "calpha":
        return sct.HinsenForceField()
    if ff_name == "pfanm":
        return sct.ParameterFreeForceField()
    ff = sct.TabulatedForceField.sd_enm(ca)
    after_break = check_res_id_continuity(ca)
    if len(after_break):
        pairs = np.stack([after_break - 1, after_break], axis=1)
        ff = sct.PatchedForceField(
            ff, contact_pair_off=pairs, contact_pair_on=pairs,
            force_constants=np.full(len(pairs),
                                    43.52 * 0.0083144621 * 300 * 10))
    return ff


@pytest.mark.parametrize("ff_name", ["calpha", "sdenm", "pfanm"])
def test_bio3d_nma_observables(cas, ff_name):
    """Mass- and temperature-weighted eigenvalues, frequencies,
    fluctuations and DCCs against bio3d (``tests/test_anm.py``)."""
    tca = cas[1]
    tem, tem_scaling = 300, K_B * N_A
    ff = _bio3d_forcefield(tca, ff_name)
    masses = load_csv("bio3d_mass_1l2y.csv.gz")
    weighted = sct.ANM(tca, ff, masses=masses, device="cpu")
    tol = dict(rtol=5e-3, atol=2e-3)
    assert np.allclose(weighted.eigen()[0][6:], load_csv(
        f"bio3d_anm_{ff_name}_ff_evals_mw_1l2y.csv.gz")[6:], **tol)
    assert np.allclose(weighted.frequencies()[6:], load_csv(
        f"bio3d_anm_{ff_name}_ff_frequencies_mw_1l2y.csv.gz")[6:], **tol)
    fluc = weighted.mean_square_fluctuation(
        tem=tem, tem_factors=tem_scaling) / (1000 * masses)
    assert np.allclose(fluc, load_csv(
        f"bio3d_anm_{ff_name}_ff_fluctuations_non_mw_1l2y.csv.gz"), **tol)
    fluc_subset = weighted.mean_square_fluctuation(
        tem=tem, tem_factors=tem_scaling,
        mode_subset=np.arange(11, 33)) / (1000 * masses)
    assert np.allclose(fluc_subset, load_csv(
        f"bio3d_anm_{ff_name}_ff_fluctuations_subset_mw_1l2y.csv.gz"), **tol)
    assert np.allclose(weighted.dcc(), load_csv(
        f"bio3d_anm_{ff_name}_ff_dcc_mw_1l2y.csv.gz"), **tol)
    assert np.allclose(weighted.dcc(mode_subset=np.arange(6, 36)), load_csv(
        f"bio3d_anm_{ff_name}_ff_dcc_subset_mw_1l2y.csv.gz"), **tol)


def test_eanm_vs_biophysconnector_1l2y(cas):
    anm = sct.ANM(cas[1], sct.TabulatedForceField.e_anm(cas[1]),
                  device="cpu")
    assert np.allclose(anm.eigen()[0][6:], load_csv(
        "biophysconnector_anm_eanm_evals_1l2y.csv.gz", skip_header=1)[6:])
    fluc = anm.mean_square_fluctuation()
    assert np.allclose(fluc, load_csv(
        "biophysconnector_anm_eanm_bfacs_1l2y.csv.gz", skip_header=1))
    diag = anm.covariance.diagonal().reshape(-1, 3).sum(axis=1)
    assert np.allclose(fluc, diag)


@pytest.fixture(scope="module")
def eanm_7cal():
    """7cal's CA trace under eANM: the file's one dense 7cal
    eigendecomposition (5,328 rows)."""
    ca = _ca(sct, "7cal")
    anm = sct.ANM(ca, sct.TabulatedForceField.e_anm(ca), device="cpu")
    # two intra-op threads: 14 s alone on 8 cores; all of them, beside
    # the other test workers' pools, took 108 s
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        anm.eigen()
    finally:
        torch.set_num_threads(threads)
    return anm


@pytest.mark.parametrize("what", ["eigenvalues", "msf"])
def test_eanm_7cal_vs_biophysconnector(eanm_7cal, what):
    if what == "eigenvalues":
        ref = load_csv("biophysconnector_anm_eanm_evals_7cal.csv.gz",
                       skip_header=1)
        assert np.allclose(eanm_7cal.eigen()[0][6:], ref[6:])
    else:
        ref = load_csv("biophysconnector_anm_eanm_bfacs_7cal.csv.gz",
                       skip_header=1)
        assert np.allclose(eanm_7cal.mean_square_fluctuation(), ref)


@pytest.fixture(scope="module")
def fragments():
    """The first 120 residues of 7cal under eANM with residue masses, read
    by each package: large enough for the shift-invert solver."""
    jca, tca = _ca(sc.structure, "7cal")[:120], _ca(sct, "7cal")[:120]
    return (sc.ANM(jca, sc.TabulatedForceField.e_anm(jca), masses=True),
            sct.ANM(tca, sct.TabulatedForceField.e_anm(tca), masses=True,
                    device="cpu"))


@pytest.mark.parametrize("matrix_free", [False, True])
def test_lowest_modes_match_jax_and_the_dense_spectrum(fragments,
                                                       matrix_free):
    """``lowest_modes(k, refine=True)`` (float32 solve, float64
    refinement) against the JAX method and the dense float64 eigenvalues
    to 1e-6, orthonormal modes in the atom layout with their float64
    residuals; the unrefined solve's residuals come back with it."""
    jm, tm = fragments
    vals, vecs, res = tm.lowest_modes(5, matrix_free=matrix_free,
                                      refine=True)
    ref_vals = jm.lowest_modes(5, matrix_free=matrix_free, refine=True)[0]
    dense = tm.eigen()[0][6:11]
    assert vals.shape == (5,) and vecs.shape == (5, 3 * 120)
    assert np.abs(vals - dense).max() / np.abs(dense).max() <= 1e-6
    assert np.abs(vals - np.asarray(ref_vals)).max() / np.abs(dense).max() \
        <= 1e-6
    # the residuals returned are the float64 |H v - theta v| / theta of
    # the atom-layout modes against the model's (mass-weighted) Hessian
    r = tm.hessian @ vecs.T - vecs.T * vals[None, :]
    np.testing.assert_allclose(np.linalg.norm(r, axis=0) / vals, res,
                               rtol=1e-6)
    np.testing.assert_allclose(vecs @ vecs.T, np.eye(5), atol=1e-10)
    if not matrix_free:
        raw = tm.lowest_modes(5)
        assert raw[2].shape == (5,) and np.all(np.isfinite(raw[2]))


def test_matrix_free_linear_response_and_dcc_rows_match_jax(fragments):
    jm, tm = fragments
    force = np.random.RandomState(2).randn(120, 3)
    got = tm.linear_response(force, matrix_free=True)
    ref = np.asarray(jm.linear_response(force, matrix_free=True))
    assert got.shape == (120, 3)
    assert _rel(got, ref) <= 1e-4
    assert _rel(got, tm.linear_response(force)) <= 1e-4
    msf = tm.mean_square_fluctuation()
    sites = np.array([0, 17, 64])
    rows = tm.dcc(matrix_free=True, sites=sites, msf=msf)
    ref_rows = np.asarray(jm.dcc(matrix_free=True, sites=sites, msf=msf))
    assert rows.shape == (3, 120)
    assert _rel(rows, ref_rows) <= 1e-4
    assert _rel(rows, tm.dcc()[sites]) <= 1e-4
