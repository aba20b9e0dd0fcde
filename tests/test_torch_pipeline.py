"""
PyTorch port, the batched fluctuation-NMA slice as a whole: coordinates
to MSF, B-factors and normalized DCC, held against the JAX package's
``ensemble_anm_fluctuations`` on the same numpy inputs (its Pallas
kernels in interpret mode on the CPU).

Tolerances: the float32 blocked engine is held to 1e-4 of max|x|, the
bound the JAX package holds its own Pallas path to against its XLA path
(tests/test_pallas_linalg.py); the float64 ``cho_solve`` engines agree
to 1e-10, far above float64 rounding of a 300-dimensional solve.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from springcraft_tpu.ops import ffparams as jff  # noqa: E402
from springcraft_tpu.ops import rigid as jrigid  # noqa: E402
from springcraft_tpu.parallel import pipeline as jpipe  # noqa: E402
import springcraft_tpu_torch as sct  # noqa: E402
from springcraft_tpu_torch.ops import assembly  # noqa: E402
from springcraft_tpu_torch.ops import rigid as trigid  # noqa: E402

KEYS = ("msf", "bfactor", "dcc")


def _dense_coords(b, n, seed):
    # connected at a 7 A cutoff (see tests/test_pallas_linalg.py)
    rng = np.random.RandomState(seed)
    base = (rng.rand(n, 3) * 6.0).astype(np.float32)
    return base[None] + 0.05 * rng.randn(b, n, 3).astype(np.float32)


def _spread_coords(b, n, seed):
    # protein-like density, connected at a 13 A cutoff
    rng = np.random.RandomState(seed)
    base = (rng.rand(n, 3) * 34.0 * (n / 300) ** (1 / 3)).astype(np.float32)
    return base[None] + 0.05 * rng.randn(b, n, 3).astype(np.float32)


def _rel(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _jax_blocked(coords, cutoff, masses=None):
    return jpipe.ensemble_anm_fluctuations(
        jnp.asarray(coords), jff.invariant_params(cutoff),
        masses=None if masses is None else jnp.asarray(masses),
        inverse="blocked", use_pallas=True, with_covariance=False,
        with_dcc=True, dtype=jnp.float32)


def _port(coords, cutoff, masses=None, **kwargs):
    kwargs.setdefault("inverse", "blocked")
    kwargs.setdefault("with_covariance", False)
    return sct.ensemble_anm_fluctuations(
        coords, sct.invariant_params(cutoff), masses=masses, with_dcc=True,
        device="cpu", **kwargs)


@pytest.mark.parametrize("n,cutoff,make", [(30, 7.0, _dense_coords),
                                           (100, 13.0, _spread_coords)])
@pytest.mark.parametrize("with_masses", [False, True])
def test_slice_matches_jax_blocked(n, cutoff, make, with_masses):
    coords = make(4, n, seed=n)
    masses = (np.linspace(0.8, 2.5, n).astype(np.float32)
              if with_masses else None)
    ref = _jax_blocked(coords, cutoff, masses)
    got = _port(coords, cutoff, masses)
    assert set(got) == set(KEYS)
    for key in KEYS:
        assert got[key].shape == ref[key].shape
        assert got[key].dtype == torch.float32
        assert torch.isfinite(got[key]).all()
        assert _rel(got[key], ref[key]) <= 1e-4, key


def test_chunked_equals_unchunked():
    coords = _dense_coords(4, 30, seed=9)
    whole = _port(coords, 7.0)
    chunked = _port(coords, 7.0, chunk=2)
    for key in KEYS:
        assert torch.equal(whole[key], chunked[key]), key
    with pytest.raises(ValueError, match="divide"):
        _port(coords, 7.0, chunk=3)


@pytest.mark.parametrize("with_masses", [False, True])
def test_cho_solve_float64_matches_jax(with_masses):
    coords = _spread_coords(3, 100, seed=4).astype(np.float64)
    masses = np.linspace(0.8, 2.5, 100) if with_masses else None
    ref = jpipe.ensemble_anm_fluctuations(
        jnp.asarray(coords), jff.invariant_params(13.0),
        masses=None if masses is None else jnp.asarray(masses),
        inverse="cho_solve", use_pallas=False, with_covariance=False,
        with_dcc=True, dtype=jnp.float64)
    got = _port(coords, 13.0, masses, inverse="cho_solve",
                dtype=torch.float64)
    for key in KEYS:
        assert got[key].dtype == torch.float64
        assert _rel(got[key], ref[key]) <= 1e-10, key


def test_blocked_float32_matches_cho_solve_float64():
    coords = _spread_coords(2, 100, seed=11)
    got = _port(coords, 13.0)
    ref = _port(coords.astype(np.float64), 13.0, inverse="cho_solve",
                dtype=torch.float64)
    for key in KEYS:
        assert _rel(got[key], ref[key]) <= 1e-4, key


@pytest.mark.parametrize("inverse,dtype,tol", [
    ("blocked", np.float32, 1e-5), ("cho_solve", np.float64, 1e-10)])
def test_covariance_plane_traces_match_jax(inverse, dtype, tol):
    """Both engines from a dense xyz Hessian, same inputs in both
    packages."""
    coords = torch.from_numpy(_dense_coords(2, 30, seed=21).astype(dtype))
    h = assembly.hessian_xyz_plain(coords, sct.invariant_params(7.0))
    t = trigid.rigid_modes_anm(coords)
    ref = jrigid.covariance_plane_traces(
        jnp.asarray(h.numpy()), jnp.asarray(t.numpy()), inverse=inverse,
        interpret=True)
    got = trigid.covariance_plane_traces(h, t, inverse=inverse)
    assert got.shape == (2, 30, 30) and got.dtype == h.dtype
    assert _rel(got, ref) <= tol
    with pytest.raises(ValueError, match="engine"):
        trigid.covariance_plane_traces(h, t, inverse="eigh")


@pytest.mark.parametrize("with_masses", [False, True])
def test_rigid_bases_match_jax(with_masses):
    coords = _dense_coords(3, 20, seed=2).astype(np.float64)
    masses = np.linspace(1.0, 3.0, 20) if with_masses else None
    ref = np.asarray(jax.vmap(
        lambda c: jrigid.rigid_modes_anm(c, masses=masses, layout="xyz"))(
            jnp.asarray(coords)))
    got = trigid.rigid_modes_anm(
        torch.from_numpy(coords),
        masses=None if masses is None else torch.from_numpy(masses))
    # QR signs may differ: compare the projector T T^T
    proj = got @ got.transpose(-1, -2)
    np.testing.assert_allclose(proj.numpy(),
                               ref @ ref.transpose(0, 2, 1), atol=1e-12)
    np.testing.assert_allclose((got.transpose(-1, -2) @ got).numpy(),
                               np.broadcast_to(np.eye(6), (3, 6, 6)),
                               atol=1e-12)


def test_null_mode_gnm_matches_jax():
    masses = np.linspace(1.0, 3.0, 7)
    ref = np.asarray(jrigid.null_mode_gnm(7, masses=jnp.asarray(masses),
                                          dtype=jnp.float64))
    got = trigid.null_mode_gnm(7, masses=torch.from_numpy(masses),
                               dtype=torch.float64)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-15)
    with pytest.raises(ValueError, match="device"):
        trigid.null_mode_gnm(7)


def test_disconnected_network_is_not_finite():
    coords = _dense_coords(2, 30, seed=1)
    coords[:, 15:] += 100.0                      # two far-apart halves
    got = _port(coords, 7.0)
    assert not torch.isfinite(got["msf"]).all()


@pytest.mark.parametrize("kwargs", [
    {"prep": "fused"},
    {"prep": "concat", "with_covariance": True},
    {"prep": None, "with_covariance": True, "with_prs": True},
])
def test_prep_takes_planes_or_direct(kwargs):
    """``prep`` takes the JAX package's two values, ``"planes"`` and
    ``"direct"`` (tests/test_torch_direct.py); anything else is
    refused, as there (``pipeline.py:862-864``)."""
    with pytest.raises(ValueError, match="prep must be"):
        _port(_dense_coords(2, 10, seed=0), 7.0, **kwargs)


def test_entry_points_refuse_a_plain_dict():
    """Parameters are the port's ``FFParams`` or a force-field object: the
    fields of a JAX ``FFParams`` as a plain dict go through
    ``from_numpy_params`` first (overlays included:
    tests/test_torch_assembly.py, tests/test_torch_overlays.py)."""
    fields = {"kind": "invariant", "n_bins": 1, "cutoff_sq": 49.0}
    coords = _dense_coords(2, 10, seed=0)
    for entry in (sct.ensemble_gnm_fluctuations,
                  sct.ensemble_anm_fluctuations):
        with pytest.raises(TypeError, match="FFParams"):
            entry(coords, fields, inverse="blocked", device="cpu")
        out = entry(coords, sct.from_numpy_params(fields),
                    inverse="blocked", device="cpu")
        assert torch.isfinite(out["msf"]).all()


def test_device_rules():
    coords = _dense_coords(2, 10, seed=0)
    params = sct.invariant_params(7.0)
    # a numpy input goes to the card by default, and raises without one
    if torch.cuda.is_available():
        out = sct.ensemble_anm_fluctuations(coords, params)
        assert out["msf"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            sct.ensemble_anm_fluctuations(coords, params, inverse="blocked")
    with pytest.raises(ValueError, match="inverse"):
        sct.ensemble_anm_fluctuations(coords, params, inverse="eigh",
                                      device="cpu")
    with pytest.raises(TypeError, match="FFParams"):
        sct.ensemble_anm_fluctuations(coords, jff.invariant_params(7.0),
                                      inverse="blocked", device="cpu")
    # a tensor keeps its own device; naming another one raises
    meta = torch.empty(2, 10, 3, device="meta")
    with pytest.raises(ValueError, match="device"):
        sct.ensemble_anm_fluctuations(meta, params, inverse="blocked",
                                      device="cpu")
    out = sct.ensemble_anm_fluctuations(torch.from_numpy(coords), params,
                                        inverse="blocked")
    assert out["msf"].device.type == "cpu"
