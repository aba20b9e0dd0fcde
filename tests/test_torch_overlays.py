"""
PyTorch port, patch overlays (``PatchedForceField``): the force-field
object and its dense overlay, the sparse per-pair correction behind the
kernels, and every dense entry point with an overlay, each held against
the JAX package on the same numpy inputs (x64 on, Pallas kernels in
interpret mode).

Tolerances: overlay arrays are carried across exactly.
``overlay_pair_delta`` and the two corrections repeat the JAX
arithmetic: 1e-12 of max in float64, 1e-6 in float32 (scatters add in
another order).  The corrected kernel route (the wrapper on the base
family, then the correction) equals the dense plain route to the same
bounds.  Entry points: 1e-4 of max in float32, 1e-10 in float64, the
bounds of the slices without overlays.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import springcraft_tpu as sc  # noqa: E402
from springcraft_tpu.ops import assembly as jassembly  # noqa: E402
from springcraft_tpu.ops import ffparams as jff  # noqa: E402
from springcraft_tpu.parallel import pipeline as jpipe  # noqa: E402
from springcraft_tpu.structure import load_structure as jload  # noqa: E402
import springcraft_tpu_torch as sct  # noqa: E402
from springcraft_tpu_torch.ops import assembly  # noqa: E402
from springcraft_tpu_torch.ops import assembly_kernels  # noqa: E402
from springcraft_tpu_torch.ops import ffparams as tff  # noqa: E402
from springcraft_tpu_torch.ops import rigid  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.realpath(__file__)), "data")
ARRAY_FIELDS = ("pair_table", "type_idx", "chain_code", "bonded_next",
                "intra_table", "inter_table", "bonded_table")
OVERLAY_FIELDS = ("off_mask", "on_mask", "values", "has_value")
N = 40
CUTOFF = 10.0

#: One patch for both packages: atom 3 shut down and re-attached by
#: switched-on pairs, pairs inside the cutoff switched off, pairs beyond
#: it switched on.
SHUTDOWN = [3]
PAIR_OFF = [[1, 2], [5, 9], [20, 21]]
PAIR_ON = [[3, 2], [3, 4], [3, 5], [3, 22], [0, 30], [10, 39]]
#: Exact in float32: around a tabulated family the JAX package rounds an
#: override to the dtype of its float32 tables, in float64 runs too.
CONSTANTS = [2.5, 0.75, 1.25, 0.875, 1.75, 0.5]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: this module runs many tiny ops, and under
    pytest-xdist every worker's OpenMP pool would spin on all cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ca(load):
    """1l2y's CA trace twice, the copy shifted by 8 A as chain B."""
    atoms = load(os.path.join(DATA, "1l2y.pdb"), model=1)
    ca = atoms[(atoms.atom_name == "CA") & (atoms.element == "C")]
    first, second = ca.copy(), ca.copy()
    first.chain_id[:] = "A"
    second.chain_id[:] = "B"
    second.coord = second.coord + np.float32(8.0)
    return first + second


@pytest.fixture(scope="module")
def jax_ca():
    return _ca(jload)


@pytest.fixture(scope="module")
def torch_ca():
    return _ca(sct.load_structure)


def _inner(module, atoms, family):
    if family == "invariant":
        return module.InvariantForceField(CUTOFF)
    if family == "hinsen":
        return module.HinsenForceField()
    if family == "pfenm_cutoff":
        return module.ParameterFreeForceField(9.0)
    return getattr(module.TabulatedForceField, family)(atoms)


def _patched(module, inner, **changes):
    kwargs = dict(contact_shutdown=SHUTDOWN, contact_pair_off=PAIR_OFF,
                  contact_pair_on=PAIR_ON, force_constants=CONSTANTS)
    kwargs.update(changes)
    return module.PatchedForceField(inner, **kwargs)


def _fields(params):
    """A JAX ``FFParams`` as the plain dict the port carries across."""
    out = {}
    for f in dataclasses.fields(params):
        value = getattr(params, f.name)
        if value is not None and f.name in ARRAY_FIELDS:
            value = np.asarray(value)
        out[f.name] = value
    out["overlays"] = tuple(
        {f: np.asarray(getattr(o, f)) for f in OVERLAY_FIELDS}
        for o in params.overlays)
    return out


def _carry(params):
    return sct.from_numpy_params(_fields(params))


def _jax_params(jax_ca, family):
    """JAX parameters with the patch: the compact form for a tabulated
    family (the kernels' family), ``to_params`` otherwise."""
    inner = _inner(sc, jax_ca, family)
    params = _patched(sc, inner).to_params(natoms=N)
    if hasattr(inner, "to_compact_params"):
        params = dataclasses.replace(inner.to_compact_params(),
                                     overlays=params.overlays)
    return params


def _jiggle(coord, n_conf, scale=0.3, seed=7):
    rng = np.random.RandomState(seed)
    return coord[None] + scale * rng.randn(n_conf, *coord.shape)


def _rel(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _dtypes(name):
    return {"float32": (np.float32, jnp.float32, torch.float32),
            "float64": (np.float64, jnp.float64, torch.float64)}[name]


# ---------------------------------------------------------------------------
# The force-field object and its overlay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["invariant", "hinsen", "e_anm",
                                    "sd_enm"])
def test_patched_force_field_params_match_jax(jax_ca, torch_ca, family):
    ref = _patched(sc, _inner(sc, jax_ca, family)).to_params(natoms=N)
    got = _patched(sct, _inner(sct, torch_ca, family)).to_params(natoms=N)
    assert (got.kind, got.n_bins, got.cutoff_sq, got.edges_sq) == (
        ref.kind, ref.n_bins, ref.cutoff_sq, ref.edges_sq)
    assert len(got.overlays) == len(ref.overlays) == 1
    for f in OVERLAY_FIELDS:
        mine, theirs = getattr(got.overlays[0], f), getattr(ref.overlays[0],
                                                            f)
        assert mine.dtype == np.asarray(theirs).dtype, f
        assert np.array_equal(mine, np.asarray(theirs)), f
    assert got == _carry(ref)
    assert tff.strip_overlays(got) == _carry(jff.strip_overlays(ref))
    assert tff.strip_overlays(got).overlays == ()


def test_nested_patches_concatenate(jax_ca, torch_ca):
    def nested(module, atoms):
        inner = _patched(module, _inner(module, atoms, "e_anm"))
        return module.PatchedForceField(
            inner, contact_shutdown=[7], contact_pair_off=[[11, 12]],
            contact_pair_on=[[7, 8], [7, 6], [7, 9]],
            force_constants=[1.0, 2.0, 3.0])

    ref, got = nested(sc, jax_ca), nested(sct, torch_ca)
    for name in ("contact_shutdown", "contact_pair_off", "contact_pair_on"):
        assert np.array_equal(getattr(got, name), getattr(ref, name)), name
    assert got.natoms == ref.natoms == N
    assert got.cutoff_distance == ref.cutoff_distance == 13.0
    jparams, params = ref.to_params(), got.to_params()
    assert len(params.overlays) == len(jparams.overlays) == 2
    assert params == _carry(jparams)
    # the reference's pair interface: overrides, and zero beyond the cutoff
    i = np.array([3, 0, 7, 1, 0])
    j = np.array([2, 30, 8, 2, 39])
    sq = np.array([16.0, 400.0, 30.0, 25.0, 500.0])
    assert np.array_equal(got.force_constant(i, j, sq),
                          ref.force_constant(i, j, sq))


@pytest.mark.parametrize("kwargs,error", [
    (dict(force_constants=None), TypeError),
    (dict(force_constants=[1.0]), IndexError),
    (dict(contact_pair_on=[[4, 4]], force_constants=[1.0]), ValueError),
    (dict(contact_shutdown=[N]), IndexError),
])
def test_patched_force_field_validation(jax_ca, torch_ca, kwargs, error):
    for module, atoms in ((sc, jax_ca), (sct, torch_ca)):
        with pytest.raises(error):
            _patched(module, _inner(module, atoms, "e_anm"), **kwargs)


def test_patch_around_an_analytic_field_needs_the_atom_count():
    patched = _patched(sct, sct.InvariantForceField(CUTOFF))
    assert patched.to_params() is None
    assert patched.to_params(natoms=N).n_atoms == N
    with pytest.raises(ValueError, match="built for"):
        assembly.hessian_xyz_plain(torch.zeros(1, N + 1, 3),
                                   patched.to_params(natoms=N))


def test_overlay_shapes_are_checked():
    params = sct.invariant_params(CUTOFF)
    square = np.zeros((4, 4), bool)
    with pytest.raises(ValueError, match=r"four \(n, n\) arrays"):
        tff.with_overlay(params, square, square[:3], square, square)
    with pytest.raises(ValueError, match="different atom counts"):
        tff.with_overlay(tff.with_overlay(params, *[square] * 4),
                         *[np.zeros((5, 5), bool)] * 4)
    with pytest.raises(TypeError, match="PatchOverlay"):
        tff.FFParams(kind="invariant", cutoff_sq=49.0, overlays=("x",))


# ---------------------------------------------------------------------------
# The sparse correction
# ---------------------------------------------------------------------------

FAMILIES = ["invariant", "hinsen", "pfenm_cutoff", "sd_enm", "e_anm"]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 1e-6)])
def test_overlay_pair_delta_matches_jax(jax_ca, family, dtype, tol):
    npdt, jdt, tdt = _dtypes(dtype)
    jparams = _jax_params(jax_ca, family)
    params = _carry(jparams)
    coord = _jiggle(jax_ca.coord, 1)[0].astype(npdt)
    ref = jff.overlay_pair_delta(jnp.asarray(coord), jparams, jnp)
    got = tff.overlay_pair_delta(torch.from_numpy(coord), params)
    pairs = jff.overlay_candidate_pairs(jparams)
    assert np.array_equal(tff.overlay_candidate_pairs(params)[0], pairs[0])
    assert np.array_equal(tff.overlay_candidate_pairs(params)[1], pairs[1])
    assert np.array_equal(got[0].numpy(), ref[0])
    assert np.array_equal(got[1].numpy(), ref[1])
    assert got[2].dtype == tdt
    assert np.count_nonzero(np.asarray(ref[2])) >= 8
    for mine, theirs in zip(got[2:], ref[2:]):
        assert _rel(mine, theirs) <= tol


def test_overlay_pair_delta_takes_original_positions(jax_ca):
    """Reordered atoms: codes and masks follow the atoms, the bonded
    test of ``table_compact`` goes by the original positions."""
    jparams = _jax_params(jax_ca, "sd_enm")
    params = _carry(jparams)
    coord = _jiggle(jax_ca.coord, 1)[0]
    perm = np.random.RandomState(2).permutation(N)
    ii, jj, delta, _, _ = tff.overlay_pair_delta(torch.from_numpy(coord),
                                                 params)
    pi, pj, pdelta, _, _ = tff.overlay_pair_delta(
        torch.from_numpy(coord[perm]), params.permuted(perm), pos=perm)
    full = np.zeros((N, N))
    full[ii.numpy(), jj.numpy()] = delta.numpy()
    full = full + full.T
    got = np.zeros((N, N))
    got[perm[pi.numpy()], perm[pj.numpy()]] = pdelta.numpy()
    got = got + got.T
    np.testing.assert_allclose(got, full, rtol=0, atol=1e-12)
    # without the positions a bonded pair is looked up in the wrong table
    _, _, wrong, _, _ = tff.overlay_pair_delta(
        torch.from_numpy(coord[perm]), params.permuted(perm))
    assert not np.allclose(wrong.numpy(), pdelta.numpy())


@pytest.mark.parametrize("family", ["invariant", "sd_enm"])
@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 1e-6)])
def test_overlay_corrections_match_jax(jax_ca, family, dtype, tol):
    npdt, jdt, tdt = _dtypes(dtype)
    jparams = _jax_params(jax_ca, family)
    params = _carry(jparams)
    coord = _jiggle(jax_ca.coord, 1)[0].astype(npdt)
    rng = np.random.RandomState(4)
    hessian = rng.randn(3 * N, 3 * N).astype(npdt)
    kirchhoff = rng.randn(N, N).astype(npdt)
    ref = jassembly.overlay_correction_hessian_xyz(
        jnp.asarray(hessian), jnp.asarray(coord), jparams, jnp)
    got = assembly.overlay_correction_hessian_xyz(
        torch.from_numpy(hessian.copy()), torch.from_numpy(coord), params)
    assert got.dtype == tdt and _rel(got, ref) <= tol
    ref = jassembly.overlay_correction_kirchhoff(
        jnp.asarray(kirchhoff), jnp.asarray(coord), jparams, jnp)
    got = assembly.overlay_correction_kirchhoff(
        torch.from_numpy(kirchhoff.copy()), torch.from_numpy(coord), params)
    assert got.dtype == tdt and _rel(got, ref) <= tol


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 1e-6)])
def test_corrected_kernel_route_equals_dense_plain_route(jax_ca, family,
                                                         dtype, tol):
    """The wrappers assemble the base family and add the correction,
    batched over conformers; the plain versions run the overlays through
    the full adjacency and value pipeline; the JAX dense route agrees."""
    npdt, jdt, tdt = _dtypes(dtype)
    jparams = _jax_params(jax_ca, family)
    params = _carry(jparams)
    coords = _jiggle(jax_ca.coord, 3).astype(npdt)
    c = torch.from_numpy(coords)
    dense = assembly.hessian_xyz_plain(c, params)
    assert _rel(assembly_kernels.hessian_xyz_ensemble(c, params),
                dense) <= tol
    ref = np.stack([np.asarray(jassembly.hessian_matrix(
        jnp.asarray(x), jparams, jnp, layout="xyz")) for x in coords])
    assert _rel(dense, ref) <= max(tol, 2e-6)
    dense = assembly.kirchhoff_plain(c, params)
    assert _rel(assembly_kernels.kirchhoff_ensemble(c, params), dense) <= tol
    ref = np.stack([np.asarray(jassembly.kirchhoff_matrix(
        jnp.asarray(x), jparams, jnp)) for x in coords])
    assert _rel(dense, ref) <= max(tol, 2e-6)
    # the overlay is visible: the base family alone differs
    base = assembly.kirchhoff_plain(c, tff.strip_overlays(params))
    assert _rel(base, dense) > 1e-3


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_switched_on_pair_beyond_the_cutoff_and_pair_on_the_cutoff(dtype):
    """Four atoms on a line at 0, 3, 6 and 13 A, cutoff 3: the pair (0, 1)
    lies exactly on the cutoff and keeps its base constant (in float32
    the squared distance and the cutoff compare as the kernels round
    them); (0, 3) lies far beyond it and is switched on with its own
    constant; (1, 2), on the cutoff too, is switched off."""
    npdt, jdt, tdt = _dtypes(dtype)
    coord = np.array([[0, 0, 0], [3, 0, 0], [6, 0, 0], [13, 0, 0]], npdt)
    n = len(coord)
    off = np.zeros((n, n), bool)
    on = np.zeros((n, n), bool)
    values = np.zeros((n, n))
    off[1, 2] = off[2, 1] = True
    on[0, 3] = on[3, 0] = True
    values[0, 3] = values[3, 0] = 2.5
    params = tff.with_overlay(sct.invariant_params(3.0), off, on, values, on)
    jparams = jff.with_overlay(jff.invariant_params(3.0), off, on, values,
                               on)
    c = torch.from_numpy(coord)[None]
    want = np.array([[3.5, -1, 0, -2.5], [-1, 1, 0, 0], [0, 0, 0, 0],
                     [-2.5, 0, 0, 2.5]])
    for route in (assembly.kirchhoff_plain,
                  assembly_kernels.kirchhoff_ensemble):
        got = route(c, params)[0]
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(np.asarray(jassembly.kirchhoff_matrix(
        jnp.asarray(coord), jparams, jnp)), want)
    _, _, delta, _, _ = tff.overlay_pair_delta(c[0], params)
    np.testing.assert_array_equal(delta.numpy(), [2.5, -1.0])


def test_wrappers_that_refuse_overlays(jax_ca):
    params = _carry(_jax_params(jax_ca, "invariant"))
    coords = torch.from_numpy(_jiggle(jax_ca.coord, 2).astype(np.float32))
    with pytest.raises(ValueError, match="no patch overlays"):
        assembly_kernels.hessian_planes_ensemble(coords, params)
    bases = rigid.rigid_modes_anm(coords)
    scale = torch.ones(2, 3 * N)
    with pytest.raises(ValueError, match="without patch overlays"):
        assembly_kernels.assembly_stitch(coords, params, scale,
                                         bases * 1.0, 128,
                                         torch.zeros(2, N, 9))
    assert not rigid.direct_prep_applies(params, N)
    assert rigid.direct_prep_applies(tff.strip_overlays(params), N)
    # the plain planes take the overlay through the dense pipeline
    planes = assembly.hessian_planes_plain(coords, params)
    assert _rel(assembly.planes_to_xyz(planes),
                assembly.hessian_xyz_plain(coords, params)) == 0.0


# ---------------------------------------------------------------------------
# Every dense entry point with an overlay
# ---------------------------------------------------------------------------

def _check(got, ref, tol, dtype, skip=()):
    assert set(got) == set(ref)
    for key in ref:
        if key in skip:
            continue
        assert tuple(got[key].shape) == tuple(ref[key].shape), key
        assert got[key].dtype == dtype, key
        assert torch.isfinite(got[key]).all(), key
        assert _rel(got[key], ref[key]) <= tol, key


@pytest.mark.parametrize("family", ["invariant", "e_anm"])
@pytest.mark.parametrize("with_covariance", [False, True])
@pytest.mark.parametrize("prep", ["planes", "direct"])
def test_anm_ensemble_blocked_with_overlay_matches_jax(jax_ca, family,
                                                       with_covariance,
                                                       prep):
    """With an overlay both packages' blocked engines take dense
    Hessians, whatever `prep` says (under jit the JAX package's masks
    are tracers, so its ``"auto"`` assembly is the dense route).  eANM,
    not sdENM: on this overlapping two-chain construct two float32
    routes under sdENM sit 3e-4 apart, each that far from float64."""
    jparams = _jax_params(jax_ca, family)
    coords = _jiggle(jax_ca.coord, 4).astype(np.float32)
    masses = np.linspace(0.8, 2.5, N).astype(np.float32)
    ref = jpipe.ensemble_anm_fluctuations(
        jnp.asarray(coords), jparams, masses=masses, inverse="blocked",
        use_pallas="auto", with_covariance=with_covariance,
        with_prs=with_covariance, dtype=jnp.float32, prep=prep)
    got = sct.ensemble_anm_fluctuations(
        coords, _carry(jparams), masses=masses, inverse="blocked",
        with_covariance=with_covariance, with_prs=with_covariance, chunk=2,
        device="cpu", prep=prep)
    _check(got, ref, 1e-4, torch.float32)


@pytest.mark.parametrize("family", ["invariant", "e_anm", "sd_enm"])
def test_gnm_ensemble_blocked_with_overlay_matches_jax(jax_ca, family):
    jparams = _jax_params(jax_ca, family)
    coords = _jiggle(jax_ca.coord, 3).astype(np.float32)
    ref = jpipe.ensemble_gnm_fluctuations(
        jnp.asarray(coords), jparams, inverse="blocked", use_pallas="auto",
        dtype=jnp.float32)
    got = sct.ensemble_gnm_fluctuations(coords, _carry(jparams),
                                        inverse="blocked", device="cpu")
    _check(got, ref, 1e-4, torch.float32)


@pytest.mark.parametrize("family", ["invariant", "sd_enm", "table_pair"])
def test_ensembles_float64_with_overlay_match_jax(jax_ca, family):
    if family == "table_pair":
        jparams = _patched(sc, _inner(sc, jax_ca, "e_anm")).to_params()
        assert jparams.kind == "table_pair"
    else:
        jparams = _jax_params(jax_ca, family)
    params = _carry(jparams)
    coords = _jiggle(jax_ca.coord, 2)
    masses = np.linspace(0.8, 2.5, N)
    ref = jpipe.ensemble_anm_fluctuations(
        jnp.asarray(coords), jparams, masses=masses, inverse="cho_solve",
        use_pallas=False, with_prs=True, dtype=jnp.float64)
    got = sct.ensemble_anm_fluctuations(
        coords, params, masses=masses, inverse="cho_solve", with_prs=True,
        dtype=torch.float64, device="cpu")
    _check(got, ref, 1e-10, torch.float64)
    ref = jpipe.ensemble_gnm_fluctuations(
        jnp.asarray(coords), jparams, masses=masses, inverse="cho_solve",
        use_pallas=False, dtype=jnp.float64)
    got = sct.ensemble_gnm_fluctuations(
        coords, params, masses=masses, inverse="cho_solve",
        dtype=torch.float64, device="cpu")
    _check(got, ref, 1e-10, torch.float64)


@pytest.mark.parametrize("family", ["invariant", "e_anm"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("float64", 1e-10)])
def test_single_structure_with_overlay_matches_jax(jax_ca, family, dtype,
                                                   tol):
    npdt, jdt, tdt = _dtypes(dtype)
    jparams = _jax_params(jax_ca, family)
    params = _carry(jparams)
    coord = jax_ca.coord.astype(npdt)
    # under jit the overlay masks are tracers, which the JAX package's
    # kernel route refuses: "auto" takes its dense route there
    use_pallas = "auto"
    ref = jpipe.anm_fluctuations(jnp.asarray(coord), jparams, with_prs=True,
                                 dtype=jdt, use_pallas=use_pallas)
    got = sct.anm_fluctuations(coord, params, with_prs=True, dtype=tdt,
                               device="cpu")
    _check(got, ref, tol, tdt)
    ref = jpipe.gnm_fluctuations(jnp.asarray(coord), jparams, dtype=jdt,
                                 use_pallas=use_pallas)
    got = sct.gnm_fluctuations(coord, params, dtype=tdt, device="cpu")
    _check(got, ref, tol, tdt)


@pytest.mark.parametrize("entry,vectors", [
    ("anm_observables", "eig_vectors"), ("gnm_observables", "eig_vectors"),
    ("anm_spectral", None), ("gnm_spectral", None),
    ("ensemble_anm_banded", "eig_vectors"),
    ("ensemble_gnm_spectral", None)])
def test_eigen_entry_points_with_overlay_match_jax(jax_ca, entry, vectors):
    """The dense ``eigh``, spectral and banded routes share the assembly:
    float64 eigenvalues and covariance observables with an overlay
    against the JAX package (eigenvectors are free up to sign and are
    held by the observables made from them)."""
    jparams = _jax_params(jax_ca, "sd_enm")
    coord = jax_ca.coord.astype(np.float64)
    x = coord[None] if entry.startswith("ensemble") else coord
    ref = getattr(jpipe, entry)(jnp.asarray(x), jparams, dtype=jnp.float64,
                                use_pallas=False)
    got = getattr(sct, entry)(x, _carry(jparams), dtype=torch.float64,
                              device="cpu")
    _check(got, ref, 1e-8, torch.float64,
           skip=("frequencies", "eig_vectors"))


def test_entry_points_take_a_patched_force_field(torch_ca):
    """A ``PatchedForceField`` goes in as it is: around a tabulated field
    it lowers to ``table_pair`` with the overlay, around an analytic one
    the entry point supplies the atom count."""
    coords = _jiggle(torch_ca.coord, 2)
    for inner in ("invariant", "e_anm"):
        patched = _patched(sct, _inner(sct, torch_ca, inner))
        params = patched.to_params(natoms=N)
        for fn in (sct.ensemble_anm_fluctuations,
                   sct.ensemble_gnm_fluctuations):
            got = fn(coords, patched, dtype=torch.float64, device="cpu")
            ref = fn(coords, params, dtype=torch.float64, device="cpu")
            assert torch.equal(got["msf"], ref["msf"])
            base = fn(coords, tff.strip_overlays(params),
                      dtype=torch.float64, device="cpu")
            assert _rel(got["msf"], base["msf"]) > 1e-3
