"""
PyTorch port, the functional ``nma`` API (``sct.nma.*``) on
``device="cpu"`` in float64: each of the nine functions against the JAX
package's on the same models (x64 on) and against the model's own
method, the checks on its arguments (model type, trivial modes in a
subset, force shapes, movements), and the constants.

Tolerances: eigenvalues within 1e-10 of max|lambda|, everything derived
from the covariance or the modes within 1e-8 of max|x|.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import springcraft_tpu as sc  # noqa: E402
import springcraft_tpu_torch as sct  # noqa: E402
from springcraft_tpu import nma as jnma  # noqa: E402
from springcraft_tpu_torch import nma  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.realpath(__file__)), "data")


def _ca(module):
    atoms = module.load_structure(os.path.join(DATA, "1l2y.pdb"), model=1)
    return atoms[(atoms.atom_name == "CA") & (atoms.element == "C")]


@pytest.fixture(scope="module")
def models():
    jca, tca = _ca(sc.structure), _ca(sct)
    return {
        "ANM": (sc.ANM(jca, sc.InvariantForceField(13.0), masses=True),
                sct.ANM(tca, sct.InvariantForceField(13.0), masses=True,
                        device="cpu")),
        "GNM": (sc.GNM(jca, sc.InvariantForceField(7.0)),
                sct.GNM(tca, sct.InvariantForceField(7.0), device="cpu")),
    }


def _rel(got, ref):
    return float(np.abs(np.asarray(got) - ref).max() / np.abs(ref).max())


CALLS = {
    "eigen": lambda m, f: m.eigen(f)[0],
    "frequencies": lambda m, f: m.frequencies(f),
    "mean_square_fluctuation": lambda m, f: m.mean_square_fluctuation(
        f, tem=300, tem_factors=m.K_B * m.N_A),
    "msf_subset": lambda m, f: m.mean_square_fluctuation(
        f, mode_subset=np.arange(7, 15)),
    "bfactor": lambda m, f: m.bfactor(f, tem=300),
    "dcc": lambda m, f: m.dcc(f),
    "dcc_subset": lambda m, f: m.dcc(f, mode_subset=np.arange(7, 15),
                                     norm=False),
    "normal_mode": lambda m, f: m.normal_mode(f, 8, 1.5, 6),
    "linear_response": lambda m, f: m.linear_response(
        f, np.random.RandomState(5).randn(20, 3)),
    "prs": lambda m, f: m.prs(f),
    "prs_absolute": lambda m, f: m.prs(f, norm=False),
}


ANM_ONLY = ("normal_mode", "linear_response", "prs", "prs_absolute")


@pytest.mark.parametrize("model,name", [
    (model, name) for model in ("ANM", "GNM") for name in CALLS
    if model == "ANM" or name not in ANM_ONLY])
def test_functions_match_jax(models, model, name):
    jm, tm = models[model]
    ref = np.asarray(CALLS[name](jnma, jm))
    got = CALLS[name](nma, tm)
    assert isinstance(got, np.ndarray) and got.shape == ref.shape
    if name == "normal_mode":
        got = got * np.sign(np.sum(got * ref))
    tol = 1e-10 if name in ("eigen", "frequencies") else 1e-8
    lo = {"ANM": 6, "GNM": 1}[model] if name in ("eigen",
                                                   "frequencies") else 0
    assert _rel(got[lo:], ref[lo:]) <= tol


@pytest.mark.parametrize("model", ["ANM", "GNM"])
def test_functions_equal_the_methods(models, model):
    tm = models[model][1]
    np.testing.assert_array_equal(nma.eigen(tm)[1], tm.eigen()[1])
    np.testing.assert_array_equal(nma.frequencies(tm), tm.frequencies())
    np.testing.assert_array_equal(nma.mean_square_fluctuation(tm),
                                  tm.mean_square_fluctuation())
    np.testing.assert_array_equal(nma.bfactor(tm), tm.bfactor())
    np.testing.assert_array_equal(nma.dcc(tm), tm.dcc())


def test_effector_sensor_matches_jax(models):
    jm, tm = models["ANM"]
    prs = nma.prs(tm)
    for got, ref in zip(nma.effector_sensor(prs, device="cpu"),
                        jnma.effector_sensor(np.asarray(jnma.prs(jm)))):
        assert _rel(got, ref) <= 1e-8
    eff, sens = nma.effector_sensor(torch.as_tensor(prs))
    assert isinstance(eff, np.ndarray)
    np.testing.assert_array_equal(eff, nma.effector_sensor(
        prs, device="cpu")[0])
    prs_m, eff_m, sens_m = tm.prs_effector_sensor()
    np.testing.assert_array_equal(prs_m, prs)
    np.testing.assert_array_equal(sens_m, sens)


def test_argument_checks(models):
    anm, gnm = models["ANM"][1], models["GNM"][1]
    for fn in (nma.eigen, nma.frequencies, nma.mean_square_fluctuation,
               nma.dcc, nma.bfactor):
        with pytest.raises(ValueError, match="GNM/ANM"):
            fn(object())
    with pytest.raises(ValueError, match="ANM"):
        nma.normal_mode(gnm, 1, 1.0, 4)
    with pytest.raises(ValueError, match="ANM"):
        nma.linear_response(gnm, np.zeros((20, 3)))
    with pytest.raises(ValueError, match="ANM"):
        nma.prs(gnm)
    for subset, model in ((np.arange(3, 10), anm), (np.arange(0, 5), gnm)):
        with pytest.raises(ValueError, match="Trivial"):
            nma.mean_square_fluctuation(model, mode_subset=subset)
        with pytest.raises(ValueError, match="Trivial"):
            nma.dcc(model, mode_subset=subset)
    for force in (np.zeros((19, 3)), np.zeros(59), np.zeros((2, 20, 3))):
        with pytest.raises(ValueError, match="Expected"):
            nma.linear_response(anm, force)
    with pytest.raises(ValueError, match="unknown"):
        nma.normal_mode(anm, 6, 1.0, 4, movement="saw")
    assert nma.K_B == jnma.K_B and nma.N_A == jnma.N_A
