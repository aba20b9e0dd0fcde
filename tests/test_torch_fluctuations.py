"""
PyTorch port, fluctuation NMA with the covariance as a whole: the ANM
ensemble with ``with_covariance=True`` (and PRS), the GNM ensemble and
the single-structure ``anm_fluctuations`` / ``gnm_fluctuations``, held
against the JAX package's pipelines on the same numpy inputs (its Pallas
kernels in interpret mode on the CPU).

Tolerances: the float32 paths are held to 1e-4 of max|x| for every
output, the bound the JAX package holds its own Pallas path to against
its XLA path (tests/test_pallas_linalg.py); the float64 ``cho_solve``
engines agree to 1e-10, far above float64 rounding of a 300-dimensional
solve.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from springcraft_tpu.ops import ffparams as jff  # noqa: E402
from springcraft_tpu.parallel import pipeline as jpipe  # noqa: E402
import springcraft_tpu_torch as sct  # noqa: E402

ANM_KEYS = ("covariance", "msf", "bfactor", "dcc")
PRS_KEYS = ("prs", "effector", "sensor")
GNM_KEYS = ("covariance", "msf", "bfactor", "dcc")


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


#: (n, cutoff, coordinates) of the two ensemble sizes.
SIZES = {30: (7.0, _dense_coords), 100: (13.0, _spread_coords)}


def _inputs(n, with_masses, dtype=np.float32):
    cutoff, make = SIZES[n]
    coords = make(4, n, seed=n).astype(dtype)
    masses = (np.linspace(0.8, 2.5, n).astype(dtype) if with_masses
              else None)
    return coords, cutoff, masses


def _rel(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _jnp(x):
    return None if x is None else jnp.asarray(x)


def _check(got, ref, keys, tol, dtype=torch.float32):
    assert set(got) == set(keys)
    for key in keys:
        assert tuple(got[key].shape) == tuple(ref[key].shape), key
        assert got[key].dtype == dtype, key
        assert torch.isfinite(got[key]).all(), key
        assert _rel(got[key], ref[key]) <= tol, key


@functools.lru_cache(maxsize=None)
def _jax_anm(n, with_masses):
    coords, cutoff, masses = _inputs(n, with_masses)
    out = jpipe.ensemble_anm_fluctuations(
        jnp.asarray(coords), jff.invariant_params(cutoff),
        masses=_jnp(masses), inverse="blocked", use_pallas=True,
        with_covariance=True, with_prs=True, with_dcc=True,
        dtype=jnp.float32)
    return {key: np.asarray(value) for key, value in out.items()}


@pytest.mark.parametrize("n", [30, 100])
@pytest.mark.parametrize("with_masses", [False, True])
@pytest.mark.parametrize("with_prs", [False, True])
def test_anm_covariance_matches_jax_blocked(n, with_masses, with_prs):
    ref = _jax_anm(n, with_masses)
    coords, cutoff, masses = _inputs(n, with_masses)
    got = sct.ensemble_anm_fluctuations(
        coords, sct.invariant_params(cutoff), masses=masses,
        inverse="blocked", with_covariance=True, with_prs=with_prs,
        device="cpu")
    _check(got, ref, ANM_KEYS + (PRS_KEYS if with_prs else ()), 1e-4)


@pytest.mark.parametrize("n", [30, 100])
@pytest.mark.parametrize("with_masses", [False, True])
def test_gnm_ensemble_matches_jax_blocked(n, with_masses):
    coords, cutoff, masses = _inputs(n, with_masses)
    ref = jpipe.ensemble_gnm_fluctuations(
        jnp.asarray(coords), jff.invariant_params(cutoff),
        masses=_jnp(masses), inverse="blocked", use_pallas=True,
        with_dcc=True, dtype=jnp.float32)
    got = sct.ensemble_gnm_fluctuations(
        coords, sct.invariant_params(cutoff), masses=masses,
        inverse="blocked", device="cpu")
    _check(got, ref, GNM_KEYS, 1e-4)


@pytest.mark.parametrize("model,kwargs", [
    ("anm", {"with_covariance": True, "with_prs": True}),
    ("anm", {"with_covariance": False}),
    ("gnm", {}),
])
def test_single_structure_matches_jax(model, kwargs):
    coord = _spread_coords(1, 100, seed=5)[0]
    jfn = getattr(jpipe, f"{model}_fluctuations")
    ref = jfn(jnp.asarray(coord), jff.invariant_params(13.0),
              use_pallas=True, dtype=jnp.float32, **kwargs)
    got = getattr(sct, f"{model}_fluctuations")(
        coord, sct.invariant_params(13.0), device="cpu", **kwargs)
    _check(got, ref, tuple(ref), 1e-4)
    assert got["msf"].shape == (100,)


def _f64_pair(entry, coords, masses):
    """The JAX float64 engine and the port's on the same inputs."""
    params = {"ensemble_anm": dict(with_covariance=True, with_prs=True),
              "ensemble_gnm": {}, "anm": dict(with_prs=True), "gnm": {}}
    kwargs = params[entry]
    name = f"{entry}_fluctuations"
    if entry.startswith("ensemble"):
        ref = getattr(jpipe, name)(
            jnp.asarray(coords), jff.invariant_params(13.0),
            masses=_jnp(masses), inverse="cho_solve", use_pallas=False,
            dtype=jnp.float64, **kwargs)
        got = getattr(sct, name)(
            coords, sct.invariant_params(13.0), masses=masses,
            inverse="cho_solve", dtype=torch.float64, device="cpu",
            **kwargs)
    else:
        ref = getattr(jpipe, name)(
            jnp.asarray(coords[0]), jff.invariant_params(13.0),
            masses=_jnp(masses), use_pallas=False, dtype=jnp.float64,
            **kwargs)
        got = getattr(sct, name)(
            coords[0], sct.invariant_params(13.0), masses=masses,
            dtype=torch.float64, device="cpu", **kwargs)
    return got, ref


@pytest.mark.parametrize("entry", ["ensemble_anm", "ensemble_gnm", "anm",
                                   "gnm"])
def test_cho_solve_float64_matches_jax(entry):
    coords, _, masses = _inputs(100, True, dtype=np.float64)
    got, ref = _f64_pair(entry, coords[:3], masses)
    _check(got, ref, tuple(ref), 1e-10, dtype=torch.float64)


def test_blocked_float32_matches_cho_solve_float64():
    coords, cutoff, masses = _inputs(100, True)
    params = sct.invariant_params(cutoff)
    for fn, kwargs in ((sct.ensemble_anm_fluctuations,
                        dict(with_covariance=True, with_prs=True)),
                       (sct.ensemble_gnm_fluctuations, {})):
        got = fn(coords[:2], params, masses=masses, inverse="blocked",
                 device="cpu", **kwargs)
        ref = fn(coords[:2].astype(np.float64), params,
                 masses=masses.astype(np.float64), inverse="cho_solve",
                 dtype=torch.float64, device="cpu", **kwargs)
        for key in ref:
            assert _rel(got[key], ref[key]) <= 1e-4, key


@pytest.mark.parametrize("fn,kwargs", [
    (sct.ensemble_anm_fluctuations, dict(with_covariance=True,
                                         with_prs=True)),
    (sct.ensemble_gnm_fluctuations, {}),
])
@pytest.mark.parametrize("inverse", ["blocked", "cho_solve"])
def test_chunked_equals_unchunked(fn, kwargs, inverse):
    coords = _dense_coords(4, 30, seed=9)
    params = sct.invariant_params(7.0)
    whole = fn(coords, params, inverse=inverse, device="cpu", **kwargs)
    chunked = fn(coords, params, inverse=inverse, chunk=2, device="cpu",
                 **kwargs)
    assert set(whole) == set(chunked)
    for key in whole:
        assert torch.equal(whole[key], chunked[key]), key
    with pytest.raises(ValueError, match="divide"):
        fn(coords, params, inverse=inverse, chunk=3, device="cpu", **kwargs)


def test_batched_prs_equals_single_structures():
    """The ensemble's PRS, effector and sensor are each conformer's."""
    coords = _spread_coords(3, 40, seed=2).astype(np.float64)
    params = sct.invariant_params(13.0)
    batched = sct.ensemble_anm_fluctuations(
        coords, params, inverse="cho_solve", with_covariance=True,
        with_prs=True, dtype=torch.float64, device="cpu")
    for i in range(3):
        one = sct.anm_fluctuations(coords[i], params, with_prs=True,
                                   dtype=torch.float64, device="cpu")
        assert set(one) == set(batched)
        for key in PRS_KEYS + ("covariance",):
            torch.testing.assert_close(batched[key][i], one[key],
                                       rtol=1e-12, atol=0)


@pytest.mark.parametrize("call", [
    lambda c, p: sct.ensemble_anm_fluctuations(
        c, p, inverse="blocked", with_covariance=False, with_prs=True,
        device="cpu"),
    lambda c, p: sct.ensemble_anm_fluctuations(
        c, p, inverse="cho_solve", with_covariance=False, with_prs=True,
        device="cpu"),
    lambda c, p: sct.anm_fluctuations(c[0], p, with_covariance=False,
                                      with_prs=True, device="cpu"),
])
def test_prs_needs_the_covariance(call):
    with pytest.raises(ValueError, match="with_covariance"):
        call(_dense_coords(2, 10, seed=0), sct.invariant_params(7.0))


@pytest.mark.parametrize("inverse", ["blocked", "cho_solve"])
def test_disconnected_gnm_network_is_not_finite(inverse):
    coords = _dense_coords(2, 30, seed=1)
    coords[:, 15:] += 100.0                      # two far-apart halves
    params = sct.invariant_params(7.0)
    got = sct.ensemble_gnm_fluctuations(coords, params, inverse=inverse,
                                        device="cpu")
    assert not torch.isfinite(got["msf"]).all()
    single = sct.gnm_fluctuations(coords[0], params, device="cpu")
    assert not torch.isfinite(single["msf"]).all()


def test_single_structure_input_rules():
    params = sct.invariant_params(7.0)
    with pytest.raises(ValueError, match=r"\(n, 3\)"):
        sct.anm_fluctuations(_dense_coords(2, 10, seed=0), params,
                             device="cpu")
    if not torch.cuda.is_available():
        # a numpy input goes to the card by default
        with pytest.raises(RuntimeError, match="cuda"):
            sct.gnm_fluctuations(_dense_coords(1, 10, seed=0)[0], params)
    with pytest.raises(TypeError, match="FFParams"):
        sct.gnm_fluctuations(_dense_coords(1, 10, seed=0)[0],
                             jff.invariant_params(7.0), device="cpu")
    with pytest.raises(ValueError, match="inverse"):
        sct.ensemble_gnm_fluctuations(_dense_coords(2, 10, seed=0), params,
                                      inverse="eigh", device="cpu")
