"""
PyTorch port, model and result files (``io.py``): a model saved by one
package and loaded by the other, both directions, for 1l2y's CA trace
under eANM with residue masses (``ANM``) and under the invariant field at
7 A (``GNM``), each with its covariance computed; the refusal of a model
restored without a force field on every route that rebuilds from the
force field; ``save_results`` / ``load_results``.

Tolerances: the restored model's observables against the saving model's,
float64 in both packages, 1e-12 of max|ref| (the two packages' dense
algebra rounds differently; the port against itself bit for bit).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import springcraft_tpu as sc  # noqa: E402
from springcraft_tpu import io as jio  # noqa: E402
import springcraft_tpu_torch as sct  # noqa: E402
from springcraft_tpu_torch import io as tio  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.realpath(__file__)), "data")
TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the solvers run many small products and
    decompositions, and under pytest-xdist every worker's OpenMP pool
    would spin on all cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ca(package):
    atoms = package.structure.load_structure(os.path.join(DATA, "1l2y.pdb"),
                                             model=1)
    return atoms[(atoms.atom_name == "CA") & (atoms.element == "C")]


def _model(package, kind, **device):
    ca = _ca(package)
    if kind == "anm":
        return package.ANM(ca, package.TabulatedForceField.e_anm(ca),
                           masses=True, **device)
    return package.GNM(ca, package.InvariantForceField(7.0), **device)


def _observables(model, kind):
    out = {"msf": model.mean_square_fluctuation(), "dcc": model.dcc(),
           "covariance": model.covariance,
           "frequencies": model.frequencies()[7 if kind == "anm" else 2:]}
    if kind == "anm":
        prs, effector, sensor = model.prs_effector_sensor()
        out.update(prs=prs, effector=effector, sensor=sensor)
    return {k: np.asarray(v, np.float64) for k, v in out.items()}


def _assert_close(got, ref):
    assert sorted(got) == sorted(ref)
    for key in ref:
        assert got[key].shape == ref[key].shape, key
        err = np.max(np.abs(got[key] - ref[key])) / np.max(np.abs(ref[key]))
        assert err <= TOL, (key, err)


@pytest.fixture(scope="module")
def models():
    """Both packages' ANM and GNM of 1l2y with their covariance computed,
    and their observables."""
    out = {}
    for kind in ("anm", "gnm"):
        port, jax = _model(sct, kind, device="cpu"), _model(sc, kind)
        _ = port.covariance, jax.covariance
        out[kind] = (port, jax, _observables(port, kind),
                     _observables(jax, kind))
    return out


@pytest.mark.parametrize("kind", ["anm", "gnm"])
def test_port_file_loads_in_jax(models, tmp_path, kind):
    port, _, port_obs, _ = models[kind]
    path = tmp_path / "model.npz"
    tio.save_model(path, port)
    with np.load(path) as data:
        assert sorted(data.files) == sorted(
            ["kind", "coord", "matrix", "covariance"]
            + (["masses"] if kind == "anm" else []))
        assert str(data["kind"]) == kind
        assert data["matrix"].dtype == np.float64
    restored = jio.load_model(path)
    assert type(restored).__name__ == kind.upper()
    _assert_close(_observables(restored, kind), port_obs)


@pytest.mark.parametrize("kind", ["anm", "gnm"])
def test_jax_file_loads_in_port(models, tmp_path, kind):
    _, jax, _, jax_obs = models[kind]
    path = tmp_path / "model.npz"
    jio.save_model(path, jax)
    restored = tio.load_model(path, device="cpu")
    assert isinstance(restored, sct.ANM if kind == "anm" else sct.GNM)
    assert restored._matrix.device.type == "cpu"
    assert restored._matrix.dtype == torch.float64
    _assert_close(_observables(restored, kind), jax_obs)
    if kind == "anm":
        assert np.array_equal(restored.masses, jax.masses)


@pytest.mark.parametrize("kind", ["anm", "gnm"])
def test_port_round_trip_is_bit_for_bit(models, tmp_path, kind):
    port, _, port_obs, _ = models[kind]
    path = tmp_path / "model.npz"
    tio.save_model(path, port)
    restored = tio.load_model(path, device="cpu")
    got = _observables(restored, kind)
    for key in port_obs:
        assert np.array_equal(got[key], port_obs[key]), key
    assert np.array_equal(restored._coord, port._coord)


@pytest.mark.parametrize("kind", ["anm", "gnm"])
def test_files_of_both_packages_hold_the_same_arrays(models, tmp_path,
                                                     kind):
    """The same keys and arrays.  ``coord`` is the one dtype apart: the
    port's models keep float64 coordinates, the JAX package's the input's
    float32; the values are equal."""
    port, jax, _, _ = models[kind]
    tio.save_model(tmp_path / "t.npz", port)
    jio.save_model(tmp_path / "j.npz", jax)
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert sorted(t.files) == sorted(j.files)
        assert t["coord"].dtype == np.float64
        assert np.array_equal(t["coord"], j["coord"].astype(np.float64))
        for key in sorted(set(t.files) - {"coord"}):
            assert t[key].dtype == j[key].dtype, key
            if t[key].dtype.kind == "f":
                err = np.max(np.abs(t[key] - j[key]))
                assert err <= TOL * np.max(np.abs(j[key])), key
            else:
                assert np.array_equal(t[key], j[key]), key


def test_load_model_defaults_to_the_card(models, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tio.save_model(tmp_path / "m.npz", models["gnm"][0])
    with pytest.raises(RuntimeError, match="cuda"):
        tio.load_model(tmp_path / "m.npz")


def _routes(kind):
    """Every route of a restored model that rebuilds from the force
    field."""
    routes = {
        "lowest_modes": lambda m: m.lowest_modes(2),
        "lowest_modes_matfree": lambda m: m.lowest_modes(
            2, matrix_free=True),
        "msf_matfree": lambda m: m.mean_square_fluctuation(
            matrix_free=True, modes=m.eigen()),
        "dcc_matfree": lambda m: m.dcc(matrix_free=True, sites=[0],
                                       norm=False),
    }
    if kind == "anm":
        routes.update({
            "linear_response_matfree": lambda m: m.linear_response(
                np.ones((20, 3)), matrix_free=True),
            "prs_matfree": lambda m: m.prs_effector_sensor(
                matrix_free=True, sites=[0]),
        })
    return routes


@pytest.mark.parametrize("kind, route", [
    (kind, route) for kind in ("anm", "gnm")
    for route in sorted(_routes(kind))])
def test_restored_model_without_force_field_refuses_to_rebuild(
        models, tmp_path, kind, route):
    """With its matrices the restored model answers; every route that
    rebuilds from the force field (the matrix-free ones too) raises a
    ``RuntimeError`` naming ``force_field=``, as the JAX package's
    ``_NullForceField.force_constant`` does."""
    path = tmp_path / "m.npz"
    tio.save_model(path, models[kind][0])
    restored = tio.load_model(path, device="cpu")
    with pytest.raises(RuntimeError, match="force_field="):
        _routes(kind)[route](restored)


@pytest.mark.parametrize("kind", ["anm", "gnm"])
def test_restored_model_without_matrices_or_force_field_errors(tmp_path,
                                                               kind):
    """``tests/test_io_modes.py::test_restored_model_without_ff_errors``:
    a model saved before any matrix was computed cannot recompute it."""
    path = tmp_path / "empty.npz"
    tio.save_model(path, _model(sct, kind, device="cpu"))
    with np.load(path) as data:
        assert "matrix" not in data.files
    restored = tio.load_model(path, device="cpu")
    with pytest.raises(RuntimeError, match="force_field="):
        restored.hessian if kind == "anm" else restored.kirchhoff  # noqa
    with pytest.raises(RuntimeError, match="force_field="):
        restored.covariance  # noqa: B018


@pytest.mark.parametrize("kind", ["anm", "gnm"])
def test_restored_model_with_force_field_rebuilds(models, tmp_path, kind):
    port = models[kind][0]
    path = tmp_path / "m.npz"
    tio.save_model(path, _model(sct, kind, device="cpu"))
    ca = _ca(sct)
    ff = (sct.TabulatedForceField.e_anm(ca) if kind == "anm"
          else sct.InvariantForceField(7.0))
    restored = tio.load_model(path, force_field=ff, device="cpu")
    matrix = restored.hessian if kind == "anm" else restored.kirchhoff
    ref = port.hessian if kind == "anm" else port.kirchhoff
    assert np.array_equal(matrix, ref)
    vals, _, res = restored.lowest_modes(3, matrix_free=True, degree=16,
                                         n_outer=2)
    assert np.all(np.isfinite(vals)) and vals.shape == (3,)


def test_results_roundtrip(tmp_path):
    """``tests/test_io_modes.py::test_results_roundtrip``, tensors too,
    and across the packages."""
    results = {"msf": np.arange(5.0), "evals": np.ones((3, 3)),
               "modes": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    path = tmp_path / "results.npz"
    tio.save_results(path, results)
    for back in (tio.load_results(path), jio.load_results(path)):
        assert set(back) == {"msf", "evals", "modes"}
        assert np.array_equal(back["msf"], results["msf"])
        assert back["modes"].dtype == np.float32
        assert np.array_equal(back["modes"], results["modes"].numpy())
    jio.save_results(tmp_path / "j.npz", {"msf": np.arange(5.0)})
    assert np.array_equal(tio.load_results(tmp_path / "j.npz")["msf"],
                          np.arange(5.0))
