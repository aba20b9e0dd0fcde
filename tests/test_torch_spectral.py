"""
PyTorch port, the spectral pipelines as a whole: every entry point of the
slice against its JAX counterpart on the same numpy inputs — 3 conformers
of 24 residues at an invariant 7 A cutoff, as
``tests/test_pallas_linalg.py:168-200`` — with and without masses, in
float64 (the ``cho_solve`` engine where there is a choice) and in float32
(the ``blocked`` engine, whose Pallas kernels run in interpret mode in
the JAX package).  Also the repaired defaults of the fluctuation entry
points: they return the JAX package's keys.

Tolerances: values within 1e-8 of max|x| in float64 and 5e-4 in float32
(``tests/test_pallas_linalg.py:168-180``), frequencies past the null
modes (theirs are square roots of rounding noise); eigenvectors, free up
to sign and rotations inside degenerate clusters, by their residuals
against the float64 matrices (1e-8 / 5e-4 of the matrix norm) and
orthonormality (1e-8 / 1e-3), and mode shapes by the projector onto
their span (1e-8 / 5e-4) and by their residuals (1e-5 / 5e-4: sixteen
subspace iterations leave the third GNM mode at 5e-7 even in float64).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from springcraft_tpu.ops import ffparams as jff  # noqa: E402
from springcraft_tpu.parallel import pipeline as jpipe  # noqa: E402
import springcraft_tpu_torch as sct  # noqa: E402
from springcraft_tpu_torch.parallel import pipeline as tpipe  # noqa: E402

CUTOFF = 7.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's thousands of tiny ops: under
    pytest-xdist, every worker's OpenMP pool spinning on all cores slows
    them a hundredfold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

#: entry point -> (ensemble, model, keyword arguments of both packages)
ENTRIES = {
    "ensemble_anm_spectral": (True, "anm", {"n_modes": 4}),
    # the GNM modes' subspace iteration converges more slowly (a flatter
    # low spectrum): partly converged iterates differ between packages
    "ensemble_gnm_spectral": (True, "gnm", {"n_modes": 3,
                                            "n_iter_modes": 64}),
    "ensemble_anm_banded": (True, "anm", {"with_dcc": True,
                                          "with_covariance": True}),
    "ensemble_gnm_banded": (True, "gnm", {"with_dcc": True}),
    "anm_spectral": (False, "anm", {"n_modes": 4}),
    "gnm_spectral": (False, "gnm", {}),
    "anm_observables": (False, "anm", {"with_dcc": True,
                                       "with_covariance": True}),
    "gnm_observables": (False, "gnm", {"with_dcc": True, "n_modes": 10}),
    "ensemble_anm": (True, "anm", {"with_dcc": True, "n_modes": 10}),
    "ensemble_gnm": (True, "gnm", {"with_dcc": True}),
}
#: dtype -> (covariance engine, tolerance on values, on eigenvectors,
#: on their orthonormality, on the residuals of mode shapes)
DTYPES = {"float64": ("cho_solve", 1e-8, 1e-8, 1e-8, 1e-5),
          "float32": ("blocked", 5e-4, 5e-4, 1e-3, 5e-4)}


def _coords(n_conf=3):
    rng = np.random.RandomState(10)
    base = (rng.rand(24, 3) * 12.0).astype(np.float32)
    return base[None] + 0.05 * rng.randn(n_conf, 24, 3).astype(np.float32)


def _masses():
    return np.linspace(0.8, 2.5, 24).astype(np.float32)


def _rel(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _kwargs(entry, dtype):
    kwargs = dict(ENTRIES[entry][2])
    if entry.endswith("_spectral") and ENTRIES[entry][0]:
        kwargs["inverse"] = DTYPES[dtype][0]
    return kwargs


@functools.lru_cache(maxsize=None)
def _jax(entry, with_masses, dtype):
    ensemble, _, _ = ENTRIES[entry]
    coords = _coords().astype(dtype)
    masses = _masses().astype(dtype) if with_masses else None
    x = coords if ensemble else coords[0]
    out = getattr(jpipe, entry)(
        jnp.asarray(x), jff.invariant_params(CUTOFF),
        None if masses is None else jnp.asarray(masses),
        dtype=jnp.dtype(dtype), **_kwargs(entry, dtype))
    return {key: np.asarray(value) for key, value in out.items()}


def _matrices(model, with_masses, ensemble):
    """The float64 Hessians or Kirchhoff matrices, mass-weighted."""
    coords = torch.from_numpy(_coords().astype(np.float64))
    masses = (torch.from_numpy(_masses().astype(np.float64)) if with_masses
              else None)
    build = (tpipe._build_hessians_batched if model == "anm"
             else tpipe._build_kirchhoffs_batched)
    mats = build(coords, sct.invariant_params(CUTOFF), masses)
    return mats if ensemble else mats[:1]


def _check_vectors(vals, vecs, mats, tol_res, tol_orth):
    u = vecs.double().transpose(-1, -2)
    norm = torch.linalg.eigvalsh(mats).abs().amax(dim=-1)[:, None]
    res = torch.linalg.vector_norm(mats @ u - u * vals.double()[:, None],
                                   dim=-2) / norm
    assert float(res.max()) <= tol_res
    eye = torch.eye(u.shape[-1], dtype=u.dtype)
    assert float((vecs.double() @ u - eye).abs().max()) <= tol_orth


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("with_masses", [False, True])
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_entry_point_matches_jax(entry, with_masses, dtype):
    ensemble, model, _ = ENTRIES[entry]
    _, tol, tol_vec, tol_orth, tol_modes = DTYPES[dtype]
    n_trivial = 6 if model == "anm" else 1
    ref = _jax(entry, with_masses, dtype)
    coords = _coords().astype(dtype)
    masses = _masses().astype(dtype) if with_masses else None
    got = getattr(sct, entry)(coords if ensemble else coords[0],
                              sct.invariant_params(CUTOFF), masses,
                              dtype=getattr(torch, dtype), device="cpu",
                              **_kwargs(entry, dtype))
    assert set(got) == set(ref)
    if not ensemble:
        got = {key: value[None] for key, value in got.items()}
        ref = {key: value[None] for key, value in ref.items()}
    mats = _matrices(model, with_masses, ensemble)
    for key, value in got.items():
        assert tuple(value.shape) == ref[key].shape, key
        assert value.dtype == getattr(torch, dtype), key
        assert bool(torch.isfinite(value).all()), key
        if key == "eig_vectors":
            _check_vectors(got["eig_values"], value, mats, tol_vec,
                           tol_orth)
        elif key == "mode_vectors":
            _check_vectors(got["mode_values"], value, mats, tol_modes,
                           tol_orth)
            proj = value.double().transpose(-1, -2) @ value.double()
            ref_proj = np.swapaxes(ref[key], -1, -2) @ ref[key]
            assert _rel(proj, ref_proj) <= tol_vec
        elif key == "frequencies":
            assert _rel(value[..., n_trivial:],
                        ref[key][..., n_trivial:]) <= tol, key
        else:
            assert _rel(value, ref[key]) <= tol, key


@pytest.mark.parametrize("entry", ["ensemble_anm_fluctuations",
                                   "ensemble_gnm_fluctuations",
                                   "anm_fluctuations", "gnm_fluctuations"])
def test_default_outputs_match_jax_keys(entry):
    """With default arguments the fluctuation entry points return the JAX
    package's keys (``with_covariance=True``, ``inverse="auto"``)."""
    coords = _coords()
    x = coords if entry.startswith("ensemble") else coords[0]
    ref = getattr(jpipe, entry)(jnp.asarray(x), jff.invariant_params(CUTOFF))
    got = getattr(sct, entry)(x, sct.invariant_params(CUTOFF), device="cpu")
    assert set(got) == set(ref)
    assert "covariance" in got
    for key in got:
        assert tuple(got[key].shape) == tuple(ref[key].shape), key
        assert _rel(got[key], ref[key]) <= 1e-4, key


def test_inverse_auto_resolves_from_dtype_and_device():
    coords = torch.from_numpy(_coords())
    assert tpipe._resolve_inverse("auto", coords) == "cho_solve"
    assert tpipe._resolve_inverse("auto", coords.double()) == "cho_solve"
    assert tpipe._resolve_inverse("blocked", coords) == "blocked"
    meta = torch.empty(2, 3, 3, device="meta")
    assert tpipe._resolve_inverse("auto", meta) == "cho_solve"
    with pytest.raises(ValueError, match="inverse"):
        tpipe._resolve_inverse("eigh", coords)


def test_spectral_chunks_and_single_structures_agree():
    """Chunked ensembles equal the unchunked ones, and the single-structure
    entry points equal the ensemble's rows (float64)."""
    coords = _coords(n_conf=4).astype(np.float64)
    params = sct.invariant_params(CUTOFF)
    kw = dict(dtype=torch.float64, device="cpu")
    for model in ("anm", "gnm"):
        whole = getattr(sct, f"ensemble_{model}_spectral")(
            coords, params, inverse="cho_solve", **kw)
        chunked = getattr(sct, f"ensemble_{model}_spectral")(
            coords, params, inverse="cho_solve", chunk=2, **kw)
        one = getattr(sct, f"{model}_spectral")(coords[3], params, **kw)
        for key in whole:
            assert torch.equal(whole[key], chunked[key]), key
            torch.testing.assert_close(one[key], whole[key][3], rtol=1e-9,
                                       atol=1e-12)
        banded = getattr(sct, f"ensemble_{model}_banded")(
            coords, params, chunk=2, **kw)
        dense = getattr(sct, f"ensemble_{model}")(coords, params, **kw)
        torch.testing.assert_close(banded["eig_values"], dense["eig_values"],
                                   rtol=0, atol=1e-9)
    with pytest.raises(ValueError, match="n_modes"):
        sct.ensemble_anm(coords, params, n_modes=0, **kw)
