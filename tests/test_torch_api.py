"""
PyTorch port, the reference-compatible API surface: the exports and the
flat alias modules (``anm``, ``gnm``, ``forcefield``, ``interaction``,
the ``nma`` module alias), signatures equal to the JAX package's plus
``device=``, the error probes of the verify recipe (an invariant field
without a cutoff, masses of the wrong length, zero masses,
``masses=True`` without residue names, a mode subset with trivial modes,
``lowest_modes`` after an assigned matrix), ``lowest_modes`` on a
cutoff that float32 coordinates would decide otherwise than float64
ones, the matrix-free methods that raised until the second matrix-free
slice (each now against the JAX model), the dense paths' refusal of
matrix-free arguments, and ``use_pallas=``.
"""

import importlib
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import springcraft_tpu as sc  # noqa: E402
import springcraft_tpu_torch as sct  # noqa: E402

from .test_torch_cuda import flip_cutoff  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.realpath(__file__)), "data")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

API = ("ANM", "GNM", "compute_hessian", "compute_kirchhoff", "eigen",
       "frequencies", "mean_square_fluctuation", "bfactor", "dcc",
       "normal_mode", "linear_response", "prs", "effector_sensor")


@pytest.fixture(scope="module")
def ca():
    atoms = sct.load_structure(os.path.join(DATA, "1l2y.pdb"), model=1)
    return atoms[(atoms.atom_name == "CA") & (atoms.element == "C")]


@pytest.fixture
def anm(ca):
    return sct.ANM(ca, sct.InvariantForceField(13.0), device="cpu")


@pytest.fixture
def gnm(ca):
    return sct.GNM(ca, sct.InvariantForceField(7.0), device="cpu")


@pytest.mark.parametrize("name", API + ("nma",))
def test_exported_at_the_top(name):
    assert name in sct.__all__
    assert getattr(sct, name) is getattr(sct.models, name)


def test_flat_aliases():
    for module, names in (("anm", ("ANM",)), ("gnm", ("GNM",)),
                          ("interaction", ("compute_hessian",
                                           "compute_kirchhoff")),
                          ("forcefield", ("TabulatedForceField",
                                          "InvariantForceField",
                                          "PatchedForceField", "AA_LIST"))):
        alias = importlib.import_module(f"springcraft_tpu_torch.{module}")
        for name in names:
            assert getattr(alias, name) is getattr(
                importlib.import_module(
                    f"springcraft_tpu_torch.models.{module}"), name)
    nma = importlib.import_module("springcraft_tpu_torch.nma")
    assert nma is sct.models.nma and nma is sct.nma
    assert nma.K_B == sc.nma.K_B


def _parameters(fn):
    return [(p.name, p.default) for p in
            inspect.signature(fn).parameters.values()]


def _methods(cls):
    return {name for name, value in vars(cls).items()
            if callable(value) and not name.startswith("_")}


@pytest.mark.parametrize("name", API)
def test_signatures_are_the_jax_packages_plus_device(name):
    """Same parameters, in the same order and with the same defaults as
    the JAX package's, and ``device=None`` where the JAX package picks
    its backend instead (the classes, the interaction functions,
    ``effector_sensor``)."""
    ours, theirs = getattr(sct, name), getattr(sc, name)
    if inspect.isclass(ours):
        assert _methods(theirs) <= _methods(ours)
        for method in _methods(theirs):
            assert _parameters(getattr(ours, method)) == _parameters(
                getattr(theirs, method)), method
        ours, theirs = ours.__init__, sc.models.base.ElasticNetworkModel \
            .__init__
    got, ref = _parameters(ours), _parameters(theirs)
    if got != ref:
        assert got == ref + [("device", None)]
        assert name in ("ANM", "GNM", "compute_hessian",
                        "compute_kirchhoff", "effector_sensor")


def test_import_leaves_jax_out():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, springcraft_tpu_torch as sct, springcraft_tpu_torch.nma,"
         " springcraft_tpu_torch.anm, springcraft_tpu_torch.gnm, "
         "springcraft_tpu_torch.interaction, springcraft_tpu_torch.forcefield,"
         " springcraft_tpu_torch.ops.linalg, "
         "springcraft_tpu_torch.structure.celllist, "
         "springcraft_tpu_torch.structure.info, "
         "springcraft_tpu_torch.utils.network; "
         "bad = sorted(m for m in sys.modules if m == 'jax' or "
         "m.startswith(('jax.', 'springcraft_tpu.')) or "
         "m == 'springcraft_tpu'); print(bad)"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_models_default_to_the_card(ca):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        sct.ANM(ca, sct.InvariantForceField(7.0))
    with pytest.raises(RuntimeError, match="cuda"):
        sct.compute_kirchhoff(ca.coord, sct.InvariantForceField(7.0))
    assert sct.GNM(ca, sct.InvariantForceField(7.0),
                   device="cpu")._device == torch.device("cpu")


def test_error_probes(ca, anm):
    with pytest.raises(ValueError):
        sct.InvariantForceField(None)
    with pytest.raises(IndexError):
        sct.ANM(ca, sct.InvariantForceField(7.0), masses=np.ones(5),
                device="cpu")
    with pytest.raises(ValueError, match="0"):
        sct.GNM(ca, sct.InvariantForceField(7.0),
                masses=np.zeros(ca.array_length()), device="cpu")
    with pytest.raises(TypeError, match="AtomArray"):
        sct.GNM(ca.coord, sct.InvariantForceField(7.0), masses=True,
                device="cpu")
    with pytest.raises(ValueError, match="Trivial"):
        anm.mean_square_fluctuation(mode_subset=np.arange(4, 10))
    with pytest.raises(IndexError):
        anm.hessian = np.zeros((3, 3))
    anm.hessian = anm.hessian
    with pytest.raises(ValueError, match="explicitly assigned"):
        anm.lowest_modes(2)
    with pytest.raises(ValueError, match="explicitly assigned"):
        anm.linear_response(np.zeros((20, 3)), matrix_free=True)


def test_masses_true_uses_residue_masses(ca):
    from springcraft_tpu_torch.structure import info

    gnm = sct.GNM(ca, sct.InvariantForceField(7.0), masses=True,
                  device="cpu")
    np.testing.assert_array_equal(gnm.masses,
                                  info.residue_masses(ca.res_name))
    plain = sct.GNM(ca, sct.InvariantForceField(7.0), device="cpu")
    w = 1.0 / np.sqrt(gnm.masses)
    np.testing.assert_allclose(gnm.kirchhoff,
                               plain.kirchhoff * np.outer(w, w), rtol=1e-14)


def test_anm_duals_and_eigen_cache(anm):
    hessian, cov = anm.hessian, anm.covariance
    vals = anm.eigen()[0]
    anm.hessian = 3.0 * hessian
    np.testing.assert_allclose(anm.eigen()[0], 3.0 * vals, atol=1e-12)
    np.testing.assert_allclose(anm.covariance, cov / 3.0, atol=1e-12)
    anm.covariance = cov
    np.testing.assert_allclose(anm.hessian, hessian, atol=1e-9)
    with pytest.raises(IndexError):
        anm.covariance = np.zeros((5, 5))


def _low(model, trivial):
    """The model's four lowest non-trivial modes of its dense
    eigensystem, the deflation subspace of the calls below."""
    vals, vecs = model.eigen()
    return vals[trivial:trivial + 4], vecs[trivial:trivial + 4]


#: The matrix-free calls that raised ``NotImplementedError`` until the
#: port had the second matrix-free slice (ROADMAP.md queue 1 item 3);
#: ``f64`` is the package's float64 dtype.
NOT_PORTED = {
    "anm_msf": lambda a, g, f64: a.mean_square_fluctuation(
        matrix_free=True, modes=_low(a, 6), dtype=f64, tol=1e-10),
    "anm_bfactor": lambda a, g, f64: a.bfactor(
        matrix_free=True, modes=_low(a, 6), dtype=f64, tol=1e-10),
    "anm_dcc_in_place_msf": lambda a, g, f64: a.dcc(
        matrix_free=True, sites=[0, 1], modes=_low(a, 6), dtype=f64,
        tol=1e-10),
    "anm_prs_sites": lambda a, g, f64: a.prs_effector_sensor(
        matrix_free=True, sites=[0, 1], modes=_low(a, 6), dtype=f64,
        tol=1e-10),
    "anm_prs_modes": lambda a, g, f64: a.prs_effector_sensor(
        matrix_free=True, modes=4, dtype=f64, block=32),
    "anm_prs_probes": lambda a, g, f64: a.prs_effector_sensor(
        matrix_free=True, probes=8, modes=_low(a, 6), dtype=f64,
        tol=1e-10),
    "gnm_msf": lambda a, g, f64: g.mean_square_fluctuation(
        matrix_free=True, modes=_low(g, 1), dtype=f64, tol=1e-10),
    "gnm_bfactor": lambda a, g, f64: g.bfactor(
        matrix_free=True, modes=_low(g, 1), dtype=f64, tol=1e-10),
    "gnm_dcc_in_place_msf": lambda a, g, f64: g.dcc(
        matrix_free=True, sites=[0, 1], modes=_low(g, 1), dtype=f64,
        tol=1e-10),
}


@pytest.mark.parametrize("name", list(NOT_PORTED))
def test_matrix_free_operations_not_ported_raise(anm, gnm, name):
    """These calls raised ``NotImplementedError`` before the port had
    their operations; each now runs on the CPU and gives the JAX model's
    answer (NumPy out, within 1e-8 of max), the in-place normalizers
    included."""
    import jax.numpy as jnp

    from springcraft_tpu.structure import load_structure

    atoms = load_structure(os.path.join(DATA, "1l2y.pdb"), model=1)
    jca = atoms[(atoms.atom_name == "CA") & (atoms.element == "C")]
    got = NOT_PORTED[name](anm, gnm, torch.float64)
    ref = NOT_PORTED[name](sc.ANM(jca, sc.InvariantForceField(13.0)),
                           sc.GNM(jca, sc.InvariantForceField(7.0)),
                           jnp.float64)
    if name.startswith("anm_prs"):
        assert got[0] is None and ref[0] is None
        got, ref = got[1:], ref[1:]
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert isinstance(g, np.ndarray) and g.shape == np.shape(r)
        assert np.abs(g - r).max() <= 1e-8 * np.abs(r).max()


@pytest.mark.parametrize("model, trivial", [("ANM", 6), ("GNM", 1)])
def test_lowest_modes_solve_the_float64_pairs(ca, model, trivial):
    """The float32 solve of ``lowest_modes`` assembles from the float64
    coordinates that ``eigen()`` and the refinement use: a pair that
    float32 coordinates would put inside the cutoff stays out, and the
    refined eigenvalues meet the dense ones to 1e-6 and their residuals
    (first order in the float32 subspace's error, the eigenvalues second
    order) stay under 1e-4."""
    m = getattr(sct, model)(ca, sct.InvariantForceField(flip_cutoff(ca)),
                            device="cpu")
    dense = m.eigen()[0][trivial:trivial + 5]
    vals, _, res = m.lowest_modes(5, refine=True)
    assert np.abs(vals - dense).max() / np.abs(dense).max() <= 1e-6
    assert res.max() <= 1e-4


#: Calls that fail on their arguments first, as in the JAX package.
BAD_ARGUMENTS = {
    "msf_without_modes": lambda a, g: a.mean_square_fluctuation(
        matrix_free=True),
    "msf_subset": lambda a, g: g.mean_square_fluctuation(
        matrix_free=True, modes=4, mode_subset=[3]),
    "dcc_without_sites": lambda a, g: a.dcc(matrix_free=True),
    "dcc_without_normalizer": lambda a, g: g.dcc(matrix_free=True,
                                                 sites=[0]),
    "dcc_ignored_modes": lambda a, g: a.dcc(matrix_free=True, sites=[0],
                                            msf=np.ones(20), modes=4),
    "prs_nothing": lambda a, g: a.prs_effector_sensor(matrix_free=True),
    "prs_sites_and_probes": lambda a, g: a.prs_effector_sensor(
        matrix_free=True, sites=[0], probes=4),
    "prs_modes_and_diag": lambda a, g: a.prs_effector_sensor(
        matrix_free=True, modes=4, prs_diag=np.ones(20)),
    "dense_msf_with_modes": lambda a, g: a.mean_square_fluctuation(
        modes=4),
    "dense_dcc_with_sites": lambda a, g: g.dcc(sites=[0]),
    "dense_lr_with_tol": lambda a, g: a.linear_response(np.zeros(60),
                                                        tol=1e-3),
    "dense_prs_with_probes": lambda a, g: a.prs_effector_sensor(probes=4),
}


@pytest.mark.parametrize("name", list(BAD_ARGUMENTS))
def test_argument_errors_match_jax(anm, gnm, name):
    with pytest.raises(ValueError):
        BAD_ARGUMENTS[name](anm, gnm)


def test_use_pallas(ca):
    """``use_pallas=`` follows ``utils/config.check_use_pallas``: any of
    its values runs the plain versions on the CPU; anything else
    raises."""
    gnm = sct.GNM(ca, sct.InvariantForceField(7.0), device="cpu")
    ref = gnm.lowest_modes(3)[0]
    for value in ("auto", None, True, False):
        np.testing.assert_allclose(gnm.lowest_modes(3, use_pallas=value)[0],
                                   ref, rtol=1e-12)
    with pytest.raises(ValueError, match="use_pallas"):
        gnm.lowest_modes(3, use_pallas="always")
    with pytest.raises(ValueError, match="use_pallas"):
        gnm.lowest_modes(3, matrix_free=True, use_pallas="always")
