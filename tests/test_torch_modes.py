"""
PyTorch port, ``ops/modes.py``: the reflected LOBPCG, shift-invert
subspace iteration (engines ``"chol"`` and ``"invfactor"``, and
``"staged"``, the first in three stages under the elastic loop), the
iteration on a factor in hand, the residuals, the float64 refinement of ANM and GNM modes (pair
list and streamed row panels) and ``lowest_modes_anm``, each held
against the JAX package on the same numpy inputs (x64 on; its Pallas
kernels in interpret mode); the slice as a whole on a 7cal fragment
under eANM (Hessian kernel's plain version, ``"invfactor"`` modes,
float64 refinement); and the solver keywords a call written for the JAX
package passes (``use_pallas=``, ``matvec_precision=``, ``checkpoint=``,
``retries=``).

Tolerances: float64 eigenvalues to 1e-8 relative and eigenvectors by
the distance of the subspace projectors (signs and rotations inside a
subspace are free) to 1e-6; float32 solves to 1e-4 of max|lambda|
(eigenvalues) and 1e-3 (projectors), the float32 bounds of the rest of
the port; the refined float64 eigenvalues of a float32 solve again to
1e-8.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import springcraft_tpu as sc  # noqa: E402
from springcraft_tpu.ops import assembly as jassembly  # noqa: E402
from springcraft_tpu.ops import ffparams as jff  # noqa: E402
from springcraft_tpu.ops import modes as jmodes  # noqa: E402
from springcraft_tpu.ops import pallas_kernels  # noqa: E402
from springcraft_tpu.ops import rigid as jrigid  # noqa: E402
from springcraft_tpu.structure import load_structure as jload  # noqa: E402
import springcraft_tpu_torch as sct  # noqa: E402
from springcraft_tpu_torch.ops import assembly, assembly_kernels  # noqa: E402
from springcraft_tpu_torch.ops import matfree, modes, rigid  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.realpath(__file__)), "data")
CUTOFF = 13.0


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the solvers run many small products and
    decompositions, and under pytest-xdist every worker's OpenMP pool
    would spin on all cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ca(load, n):
    atoms = load(os.path.join(DATA, "7cal.pdb"), model=1)
    ca = atoms[(atoms.atom_name == "CA") & (atoms.element == "C")]
    return ca[:n]


@pytest.fixture(scope="module")
def fragment():
    """The first 100 CA atoms of 7cal in both packages, and their
    float64 xyz-layout Hessian and rigid basis (numpy)."""
    jca, tca = _ca(jload, 100), _ca(sct.load_structure, 100)
    coord = np.asarray(jca.coord, np.float64)
    h = np.asarray(jassembly.hessian_matrix(
        coord, jff.invariant_params(CUTOFF), np, dtype=np.float64,
        layout="xyz"))
    t = np.asarray(jrigid.rigid_modes_anm(coord))
    return jca, tca, coord, h, t


def _t(x):
    return torch.from_numpy(np.array(x))


def _projector_distance(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(torch.as_tensor(b).double())
    return np.max(np.abs(a.T @ a - b.T @ b))


def _rel_vals(got, ref):
    got = np.asarray(torch.as_tensor(got).double())
    ref = np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref) / np.abs(ref))


#: LOBPCG iterations to convergence on the fragment.  Both packages run
#: the same iterates, but the reflected spectrum leaves the last digits to
#: rounding: XLA's fused program and eager products part at about 1e-8
#: relative around 200 iterations (as do JAX's own jitted and eager
#: runs), while both reach 1e-11 of the exact eigenvalues by 300.
LOBPCG_ITER = 300


@pytest.mark.parametrize("k", [4, 8])
def test_lowest_modes_lobpcg_matches_jax(fragment, k):
    *_, h, t = fragment
    ref = jmodes.lowest_modes(h, k, null_basis=t, n_iter=LOBPCG_ITER)
    got = modes.lowest_modes(_t(h), k, null_basis=_t(t),
                             n_iter=LOBPCG_ITER)
    assert got[1].shape == (k, 300)
    assert _rel_vals(got[0], ref[0]) <= 1e-8
    assert _projector_distance(ref[1], got[1]) <= 1e-6
    exact = np.linalg.eigvalsh(h)[6:6 + k]
    assert _rel_vals(got[0], exact) <= 1e-8


@pytest.mark.parametrize("n_iter", [1, 5, 20])
def test_lobpcg_core_follows_jax_iterates(n_iter):
    """The LOBPCG core against ``jax.experimental.sparse.linalg.
    lobpcg_standard`` (tol 0) on a well-conditioned SPD matrix, both
    eager: the same iterates, far from convergence."""
    from jax.experimental.sparse.linalg import lobpcg_standard

    rng = np.random.RandomState(n_iter)
    a = rng.randn(200, 200)
    a = a @ a.T / 200 + np.diag(np.linspace(0.0, 5.0, 200))
    x0 = rng.randn(200, 4)
    ref, _, _ = lobpcg_standard(lambda x: jnp.asarray(a) @ x,
                                jnp.asarray(x0), m=n_iter, tol=0.0)
    got, x = modes._lobpcg_standard(lambda x: _t(a) @ x, _t(x0), n_iter)
    assert x.shape == (200, 4)
    assert _rel_vals(got, ref) <= 1e-10


def test_lowest_modes_small_systems_take_eigh(fragment):
    *_, h, t = fragment
    hs, ts = h[:60, :60], None
    ref = jmodes.lowest_modes(hs, 12, null_basis=ts)
    got = modes.lowest_modes(_t(hs), 12)
    assert _rel_vals(got[0], ref[0]) <= 1e-12
    assert _projector_distance(ref[1], got[1]) <= 1e-10


@pytest.mark.parametrize("engine", ["chol", "invfactor", "staged"])
@pytest.mark.parametrize("k", [4, 10])
def test_shift_invert_matches_jax(fragment, engine, k):
    *_, h, t = fragment
    ref = jmodes.lowest_modes_shift_invert(h, t, k=k, engine=engine)
    got = modes.lowest_modes_shift_invert(_t(h), _t(t), k=k, engine=engine)
    assert got[0].dtype == torch.float64 and got[1].shape == (k, 300)
    assert _rel_vals(got[0], ref[0]) <= 1e-8
    assert _projector_distance(ref[1], got[1]) <= 1e-6
    assert _rel_vals(got[0], np.linalg.eigvalsh(h)[6:6 + k]) <= 1e-8


def test_invfactor_engine_in_float32_matches_jax(fragment):
    """The float32 ``"invfactor"`` engine (the blocked inverse factor,
    K3 on CUDA, its plain version here) against JAX's, Pallas leaves in
    interpret mode."""
    *_, h, t = fragment
    h32, t32 = h.astype(np.float32), t.astype(np.float32)
    ref = jmodes.lowest_modes_shift_invert(jnp.asarray(h32),
                                           jnp.asarray(t32), k=6,
                                           engine="invfactor")
    got = modes.lowest_modes_shift_invert(_t(h32), _t(t32), k=6,
                                          engine="invfactor")
    assert got[0].dtype == torch.float32
    exact = np.linalg.eigvalsh(h)
    norm = np.max(np.abs(exact))
    assert np.max(np.abs(got[0].numpy() - np.asarray(ref[0]))) \
        <= 1e-4 * norm
    assert np.max(np.abs(got[0].numpy() - exact[6:12])) <= 1e-4 * norm
    assert _projector_distance(ref[1], got[1]) <= 1e-3


def test_engine_auto_and_the_staged_options(fragment, tmp_path):
    *_, h, t = fragment
    H, T = _t(h), _t(t)
    assert modes._resolve_engine("auto", H) == "chol"
    assert modes._resolve_engine("auto", H.float()) == "chol"  # CPU
    chol = modes.lowest_modes_shift_invert(H, T, k=4, engine="chol")
    auto = modes.lowest_modes_shift_invert(H, T, k=4)
    staged = modes.lowest_modes_shift_invert_staged(H, T, k=4)
    assert torch.equal(auto[0], chol[0]) and torch.equal(staged[0], chol[0])
    with pytest.raises(TypeError, match="staged"):
        modes.lowest_modes_shift_invert(H, T, k=4, engine="chol",
                                        checkpoint=None)
    with pytest.raises(ValueError, match="engine"):
        modes.lowest_modes_shift_invert(H, T, k=4, engine="eigh")
    path = tmp_path / "state.npz"
    for options in ({"checkpoint": str(path)}, {"retries": 2}):
        got = modes.lowest_modes_shift_invert(H, T, k=4, engine="staged",
                                              **options)
        assert torch.equal(got[0], chol[0]) and torch.equal(got[1], chol[1])
        assert not path.exists()  # removed once the solve returns
    got = modes.lowest_modes_shift_invert(H, T, k=4, engine="staged",
                                          checkpoint=None, retries=0,
                                          wait=1.0)
    assert torch.equal(got[0], chol[0])


def test_shift_invert_from_chol_and_mode_residuals_match_jax(fragment):
    *_, h, t = fragment
    sigma = np.mean(np.diag(h))
    reg = h + sigma * t @ t.T
    scale = 1.0 / np.sqrt(np.diag(reg))
    reg = reg * scale[:, None] * scale[None, :]
    chol = np.linalg.cholesky(reg)
    ref = jmodes.shift_invert_from_chol(h, chol, scale, t, k=5)
    got = modes.shift_invert_from_chol(_t(h), _t(chol), _t(scale), _t(t),
                                       k=5)
    assert _rel_vals(got[0], ref[0]) <= 1e-8
    assert _projector_distance(ref[1], got[1]) <= 1e-6
    res_ref = jmodes.mode_residuals(h, ref[0], ref[1])
    res = modes.mode_residuals(_t(h), got[0], got[1])
    assert res.shape == (5,)
    assert np.max(np.abs(res.numpy() - np.asarray(res_ref))) <= 1e-10


@pytest.mark.parametrize("method", ["shift_invert", "lobpcg"])
@pytest.mark.parametrize("masses", [False, True])
def test_lowest_modes_anm_matches_jax(fragment, method, masses):
    _, _, coord, _, _ = fragment
    m = np.linspace(0.8, 2.5, 100) if masses else None
    h = np.asarray(jassembly.hessian_matrix(
        coord, jff.invariant_params(CUTOFF), np, dtype=np.float64,
        layout="xyz"))
    if masses:
        w = np.repeat(1.0 / np.sqrt(m), 3)
        w = np.concatenate([w[0::3], w[1::3], w[2::3]])
        h = h * w[:, None] * w[None, :]
    n_iter = 24 if method == "shift_invert" else LOBPCG_ITER
    ref = jmodes.lowest_modes_anm(h, coord, 4, masses=m, n_iter=n_iter,
                                  method=method)
    got = modes.lowest_modes_anm(_t(h), _t(coord), 4,
                                 masses=None if m is None else _t(m),
                                 n_iter=n_iter, method=method)
    assert _rel_vals(got[0], ref[0]) <= 1e-8
    assert _projector_distance(ref[1], got[1]) <= 1e-6
    assert _rel_vals(got[0], np.linalg.eigvalsh(h)[6:10]) <= 1e-8


def test_lowest_modes_anm_options(fragment):
    _, _, coord, h, _ = fragment
    with pytest.raises(TypeError, match="shift_invert"):
        modes.lowest_modes_anm(_t(h), _t(coord), 4, method="lobpcg",
                               engine="chol", oversample=4)
    with pytest.raises(ValueError, match="method"):
        modes.lowest_modes_anm(_t(h), _t(coord), 4, method="arnoldi")
    # a system too small to iterate takes a dense eigh, as in JAX
    small = np.asarray(jassembly.hessian_matrix(
        coord[:15], jff.invariant_params(CUTOFF), np, dtype=np.float64,
        layout="xyz"))
    ref = jmodes.lowest_modes_anm(small, coord[:15], 12)
    got = modes.lowest_modes_anm(_t(small), _t(coord[:15]), 12)
    assert _rel_vals(got[0], ref[0]) <= 1e-10
    assert _rel_vals(got[0], np.linalg.eigvalsh(small)[6:18]) <= 1e-10


def _approximate_modes(h, t, k):
    """Float32 shift-invert modes of the JAX package: the input of the
    refinement."""
    vals, vecs = jmodes.lowest_modes_shift_invert(
        jnp.asarray(h, jnp.float32), jnp.asarray(t, jnp.float32), k=k,
        engine="chol")
    return np.asarray(vecs)


@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("layout", ["xyz", "atom"])
@pytest.mark.parametrize("method", ["sparse", "dense"])
def test_refine_modes_f64_matches_jax(fragment, method, layout, augment):
    _, _, coord, h, t = fragment
    vecs = _approximate_modes(h, t, 8)
    if layout == "atom":
        perm = np.asarray(jassembly.atom_to_xyz_permutation(100))
        vecs = vecs[:, np.argsort(perm)]
    params = (jff.invariant_params(CUTOFF), sct.invariant_params(CUTOFF))
    ref = jmodes.refine_modes_f64(coord, params[0], vecs, layout=layout,
                                  block=32, augment=augment, method=method)
    got = modes.refine_modes_f64(_t(coord), params[1], _t(vecs),
                                 layout=layout, block=32, augment=augment,
                                 method=method)
    assert all(x.dtype == torch.float64 for x in got)
    assert _rel_vals(got[0], ref[0]) <= 1e-8
    assert _projector_distance(ref[1], got[1]) <= 1e-6
    assert np.max(np.abs(got[2].numpy() - ref[2])) <= 1e-6
    assert _rel_vals(got[0], np.linalg.eigvalsh(h)[6:14]) <= 1e-8


@pytest.mark.parametrize("method", ["sparse", "dense"])
@pytest.mark.parametrize("family", ["hinsen", "sd_enm"])
def test_refine_modes_f64_with_masses_matches_jax(fragment, method, family):
    jca, tca, coord, _, _ = fragment
    m = np.linspace(0.8, 2.5, 100)
    if family == "hinsen":
        params = (jff.hinsen_params(CUTOFF), sct.hinsen_params(CUTOFF))
    else:
        params = (sc.TabulatedForceField.sd_enm(jca).to_compact_params(),
                  sct.TabulatedForceField.sd_enm(tca).to_compact_params())
    h = np.asarray(jassembly.hessian_matrix(coord, params[0], np,
                                            dtype=np.float64, layout="xyz"))
    w = np.tile(1.0 / np.sqrt(m), 3)
    h = h * w[:, None] * w[None, :]
    t = np.asarray(jrigid.rigid_modes_anm(coord, masses=m))
    vecs = _approximate_modes(h, t, 6)
    ref = jmodes.refine_modes_f64(coord, params[0], vecs, masses=m,
                                  block=40, method=method)
    got = modes.refine_modes_f64(_t(coord), params[1], _t(vecs),
                                 masses=_t(m), block=40, method=method)
    assert _rel_vals(got[0], ref[0]) <= 1e-8
    assert _projector_distance(ref[1], got[1]) <= 1e-6


@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("method", ["sparse", "dense"])
def test_refine_modes_f64_gnm_matches_jax(fragment, method, masses):
    _, _, coord, _, _ = fragment
    m = np.linspace(0.8, 2.5, 100) if masses else None
    k = np.asarray(jassembly.kirchhoff_matrix(
        coord, jff.invariant_params(CUTOFF), np, dtype=np.float64))
    null = np.ones(100) if m is None else np.sqrt(m)
    if m is not None:
        w = 1.0 / np.sqrt(m)
        k = k * w[:, None] * w[None, :]
    t = (null / np.linalg.norm(null))[:, None]
    vecs = np.asarray(jmodes.lowest_modes_shift_invert(
        jnp.asarray(k, jnp.float32), jnp.asarray(t, jnp.float32), k=6)[1])
    ref = jmodes.refine_modes_f64_gnm(coord, jff.invariant_params(CUTOFF),
                                      vecs, masses=m, block=30,
                                      method=method, augment=True)
    got = modes.refine_modes_f64_gnm(
        _t(coord), sct.invariant_params(CUTOFF), _t(vecs),
        masses=None if m is None else _t(m), block=30, method=method,
        augment=True)
    assert got[1].shape == (6, 100)
    assert _rel_vals(got[0], ref[0]) <= 1e-8
    assert _projector_distance(ref[1], got[1]) <= 1e-6
    assert _rel_vals(got[0], np.linalg.eigvalsh(k)[1:7]) <= 1e-8


def test_refinement_refuses_what_it_does_not_take(fragment):
    _, _, coord, _, _ = fragment
    params = sct.invariant_params(CUTOFF)
    vecs = torch.zeros(3, 300, dtype=torch.float64)
    with pytest.raises(ValueError, match="dimension"):
        modes.refine_modes_f64(_t(coord), params, vecs[:, :299])
    with pytest.raises(ValueError, match="layout"):
        modes.refine_modes_f64(_t(coord), params, vecs, layout="planes")
    with pytest.raises(ValueError, match="method"):
        modes.refine_modes_f64(_t(coord), params, vecs, method="cells")
    with pytest.raises(ValueError, match="finite cutoff"):
        modes.refine_modes_f64_gnm(_t(coord), sct.hinsen_params(None),
                                   vecs[:, :100], method="sparse")


def test_the_slice_on_a_7cal_fragment_under_eanm():
    """7cal's first 100 residues under eANM: the float32 Hessian of the
    K5 kernel (its plain version here, Pallas interpret mode in JAX),
    ``lowest_modes_anm(engine="invfactor")`` and the float64
    refinement, in both packages."""
    jca, tca = _ca(jload, 100), _ca(sct.load_structure, 100)
    jparams = sc.TabulatedForceField.e_anm(jca).to_compact_params()
    tparams = sct.TabulatedForceField.e_anm(tca).to_compact_params()
    coord = np.asarray(jca.coord, np.float32)
    jh = pallas_kernels.hessian_pallas(jnp.asarray(coord), jparams,
                                       interpret=True)
    th = assembly_kernels.hessian_xyz_ensemble(_t(coord)[None], tparams)[0]
    assert np.max(np.abs(th.numpy() - np.asarray(jh))) \
        <= 1e-5 * np.max(np.abs(np.asarray(jh)))
    jvals, jvecs = jmodes.lowest_modes_anm(jh, coord, 10,
                                           engine="invfactor")
    tvals, tvecs = modes.lowest_modes_anm(th, _t(coord), 10,
                                          engine="invfactor")
    h64 = np.asarray(jassembly.hessian_matrix(
        coord.astype(np.float64), jparams, np, dtype=np.float64,
        layout="xyz"))
    exact = np.linalg.eigvalsh(h64)
    norm = np.max(np.abs(exact))
    assert np.max(np.abs(tvals.numpy() - np.asarray(jvals))) <= 1e-4 * norm
    assert np.max(np.abs(tvals.numpy() - exact[6:16])) <= 1e-4 * norm
    assert _projector_distance(jvecs, tvecs) <= 1e-3
    ref = jmodes.refine_modes_f64(coord, jparams, np.asarray(jvecs))
    got = modes.refine_modes_f64(_t(coord), tparams, tvecs)
    assert _rel_vals(got[0], ref[0]) <= 1e-8
    assert _rel_vals(got[0], exact[6:16]) <= 1e-8
    assert _projector_distance(ref[1], got[1]) <= 1e-6


# ---------------------------------------------------------------------------
# The solver keywords of a call written for the JAX package
# ---------------------------------------------------------------------------

ENTRY_POINTS = ("ensemble_anm_fluctuations", "ensemble_gnm_fluctuations",
                "anm_fluctuations", "gnm_fluctuations", "anm_observables",
                "gnm_observables", "ensemble_anm", "ensemble_gnm",
                "ensemble_anm_banded", "ensemble_gnm_banded",
                "ensemble_anm_spectral", "ensemble_gnm_spectral",
                "anm_spectral", "gnm_spectral")


def _coords(b, n=20, seed=3):
    rng = np.random.RandomState(seed)
    base = rng.rand(n, 3) * 6.0
    return (base[None] + 0.05 * rng.randn(b, n, 3)).astype(np.float32)


@pytest.mark.parametrize("use_pallas", ["auto", None, True, False])
@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_entry_points_take_use_pallas_on_the_cpu(entry, use_pallas):
    """Every value runs the plain versions on the CPU, as the JAX
    package runs XLA or interpret mode there; the result does not
    depend on it.  (Few bisection halvings: the switch, not the
    eigensolver, is under test.)"""
    x = _coords(1, n=12)
    if not entry.startswith("ensemble"):
        x = x[0]
    fn = getattr(sct, entry)
    options = {"n_iter_bisect": 8} if "spectral" in entry \
        or "banded" in entry else {}
    params = sct.invariant_params(7.0)
    got = fn(x, params, device="cpu", use_pallas=use_pallas, **options)
    ref = fn(x, params, device="cpu", **options)
    assert torch.equal(got["msf"], ref["msf"])


def test_use_pallas_takes_only_the_jax_values():
    with pytest.raises(ValueError, match="use_pallas"):
        sct.anm_fluctuations(_coords(1)[0], sct.invariant_params(7.0),
                             device="cpu", use_pallas="cuda")
    # the check itself: False only on CUDA devices
    from springcraft_tpu_torch.utils import config

    config.check_use_pallas(False, "cpu")
    with pytest.raises(ValueError, match="for the CPU"):
        config.check_use_pallas(False, "cuda")
    for value in ("auto", None, True):
        config.check_use_pallas(value, "cuda")


@pytest.mark.parametrize("use_pallas", [None, "auto", True, False])
def test_matrix_free_solvers_take_the_jax_keywords(use_pallas):
    coord = _coords(1, n=30)[0]
    params = sct.invariant_params(7.0)
    ref = sct.lowest_modes_matfree(coord, params, 3, n_outer=3,
                                   device="cpu")
    got = sct.lowest_modes_matfree(coord, params, 3, n_outer=3,
                                   device="cpu", use_pallas=use_pallas,
                                   matvec_precision="highest",
                                   checkpoint=None, retries=0)
    assert torch.equal(got[0], ref[0])
    got = sct.lowest_modes_matfree_gnm(coord, params, 3, n_outer=3,
                                       device="cpu", use_pallas=use_pallas,
                                       checkpoint=None, retries=0)
    assert got[0].shape == (3,)
    rhs = np.eye(90, 2)
    x, _, _ = sct.covariance_solve_matfree(coord, params, rhs, device="cpu",
                                           use_pallas=use_pallas)
    x_gnm, _, _ = sct.covariance_solve_matfree_gnm(
        coord, params, rhs[:30], device="cpu", use_pallas=use_pallas)
    assert x.shape == (90, 2) and x_gnm.shape == (30, 2)
    rows, _, _ = sct.dcc_rows_matfree(coord, params, [0, 5], norm=False,
                                      device="cpu", use_pallas=use_pallas)
    assert rows.shape == (2, 30)


def test_matrix_free_solvers_refuse_what_is_not_ported(tmp_path):
    coord = _coords(1, n=30)[0]
    params = sct.invariant_params(7.0)
    with pytest.raises(ValueError, match="matvec_precision"):
        sct.lowest_modes_matfree(coord, params, 3, device="cpu",
                                 matvec_precision="high")
    # checkpoint= and retries= run the elastic loop: the plain result
    path = tmp_path / "modes.npz"
    for fn in (sct.lowest_modes_matfree, sct.lowest_modes_matfree_gnm):
        plain = fn(coord, params, 3, n_outer=3, device="cpu")
        for options in ({"checkpoint": str(path)}, {"retries": 2}):
            got = fn(coord, params, 3, n_outer=3, device="cpu", **options)
            for a, b in zip(got, plain):
                assert torch.equal(a, b)
            assert not path.exists()
    assert "use_pallas" in matfree.covariance_solve_matfree.__code__.\
        co_varnames


def test_import_leaves_jax_out():
    code = ("import sys, springcraft_tpu_torch, "
            "springcraft_tpu_torch.ops.modes, springcraft_tpu_torch.ops."
            "pairs; assert 'jax' not in sys.modules; "
            "assert not any(m.startswith('springcraft_tpu.') or "
            "m == 'springcraft_tpu' for m in sys.modules)")
    root = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root,
                   env={**os.environ, "PYTHONPATH": root})
