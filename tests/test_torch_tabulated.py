"""
PyTorch port, the tabulated force fields (sdENM, eANM and the other
named parameterizations): the host layer (structure reader, force-field
objects, parameters), the plain table-branch assembly and the
fluctuation slice as a whole, each held against the JAX package on the
same numpy inputs.  The JAX Pallas kernels run in interpret mode on the
CPU.

Tolerances: tables and parameters are carried across exactly.  The plain
table lookup picks the same table entry as the JAX kernels pair for
pair, and the assembly then repeats their arithmetic except for the
diagonal's summation order: 1e-5 of max, as for the analytic kinds; in
float64 against the dense ``force_constant_matrix`` route 1e-12.  The
slice is held to 1e-4 of max in float32 (blocked engine) and 1e-10 in
float64 (``cho_solve``), the bounds of the analytic slice
(tests/test_torch_pipeline.py).
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import springcraft_tpu as sc  # noqa: E402
from springcraft_tpu.ops import assembly as jassembly  # noqa: E402
from springcraft_tpu.ops import pallas_kernels  # noqa: E402
from springcraft_tpu.parallel import pipeline as jpipe  # noqa: E402
from springcraft_tpu.structure import load_ensemble  # noqa: E402
from springcraft_tpu.structure import load_structure as jload  # noqa: E402
import springcraft_tpu_torch as sct  # noqa: E402
from springcraft_tpu_torch.models import forcefield as tmodels  # noqa: E402
from springcraft_tpu_torch.ops import assembly  # noqa: E402
from springcraft_tpu_torch.ops import assembly_kernels  # noqa: E402
from springcraft_tpu_torch.ops import ffparams as tff  # noqa: E402
from springcraft_tpu_torch.structure import pdb as tpdb  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.realpath(__file__)), "data")
MAKERS = ("s_enm_10", "s_enm_13", "d_enm", "sd_enm", "e_anm", "e_anm_mj",
          "e_anm_ke")
ARRAY_FIELDS = ("pair_table", "type_idx", "chain_code", "bonded_next",
                "intra_table", "inter_table", "bonded_table")


def _ca(load):
    atoms = load(os.path.join(DATA, "1l2y.pdb"), model=1)
    return atoms[(atoms.atom_name == "CA") & (atoms.element == "C")]


def _two_chains(ca):
    """1l2y's CA trace twice, the copy shifted by 8 A as chain B."""
    first, second = ca.copy(), ca.copy()
    first.chain_id[:] = "A"
    second.chain_id[:] = "B"
    second.coord = second.coord + np.float32(8.0)
    return first + second


@pytest.fixture(scope="module")
def jax_ca():
    return _two_chains(_ca(jload))


@pytest.fixture(scope="module")
def torch_ca():
    return _two_chains(_ca(sct.load_structure))


def _fields(params):
    """A JAX ``FFParams`` as the plain dict the port carries across."""
    out = {}
    for f in dataclasses.fields(params):
        value = getattr(params, f.name)
        if value is not None and f.name in ARRAY_FIELDS:
            value = np.asarray(value)
        out[f.name] = value
    return out


def _carry(params):
    return sct.from_numpy_params(_fields(params))


def _no_cutoff_force_field(module, atoms):
    """One bin, no cutoff: distinct symmetric intra and inter tables."""
    rng = np.random.RandomState(11)
    intra = rng.rand(20, 20) + 0.5
    inter = rng.rand(20, 20) + 0.5
    return module.TabulatedForceField(atoms, 7.5, intra + intra.T,
                                      inter + inter.T, None)


def _force_field(module, atoms, maker):
    if maker == "no_cutoff":
        return _no_cutoff_force_field(module, atoms)
    return getattr(module.TabulatedForceField, maker)(atoms)


def _jiggle(coord, n_conf, scale=0.3, seed=7):
    rng = np.random.RandomState(seed)
    return (coord[None] + scale * rng.randn(n_conf, *coord.shape)
            ).astype(np.float32)


def _rel(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _assert_params_equal(got, ref):
    assert (got.kind, got.n_bins, got.cutoff_sq, got.edges_sq) == (
        ref.kind, ref.n_bins, ref.cutoff_sq, ref.edges_sq)
    assert got.has_cutoff == ref.has_cutoff
    for name in ARRAY_FIELDS:
        mine, theirs = getattr(got, name), getattr(ref, name)
        assert (mine is None) == (theirs is None), name
        if mine is not None:
            assert mine.dtype == np.asarray(theirs).dtype, name
            assert np.array_equal(mine, np.asarray(theirs)), name


# ---------------------------------------------------------------------------
# Host layer
# ---------------------------------------------------------------------------

def test_structure_reader_matches_jax(jax_ca, torch_ca):
    ref = jload(os.path.join(DATA, "1l2y.pdb"), model=1)
    got = sct.load_structure(os.path.join(DATA, "1l2y.pdb"), model=1)
    assert got.array_length() == ref.array_length() == 304
    assert got.coord.dtype == np.float32
    assert np.array_equal(got.coord, ref.coord)
    for name in ("chain_id", "res_id", "res_name", "atom_name", "element",
                 "hetero"):
        assert np.array_equal(getattr(got, name), getattr(ref, name)), name
    assert torch_ca.array_length() == jax_ca.array_length() == 40
    _, models = tpdb.load_ensemble(os.path.join(DATA, "1l2y.pdb"))
    _, ref_models = load_ensemble(os.path.join(DATA, "1l2y.pdb"))
    assert models.shape == ref_models.shape
    assert np.array_equal(models, ref_models)


@pytest.mark.parametrize("name", ["x.cif", "x.cif.gz", "x.bcif"])
def test_structure_reader_reads_cif(tmp_path, torch_ca, name):
    """1l2y's CA trace written as mmCIF / BinaryCIF (``chip_smoke.py``'s
    writers) reads back through ``load_structure`` and ``load_ensemble``
    as the JAX package reads it, with the written annotations."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_under_test", os.path.join(
            os.path.dirname(DATA), os.pardir, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    path = str(tmp_path / name)
    writer = (chip_smoke.write_bcif if name.endswith(".bcif")
              else chip_smoke.write_mmcif)
    writer(path, torch_ca)
    got, ref = sct.load_structure(path), jload(path)
    assert got.array_length() == ref.array_length() == 40
    assert np.array_equal(got.coord, ref.coord)
    assert np.allclose(got.coord, torch_ca.coord, atol=1e-3)
    for annotation in ("chain_id", "res_id", "res_name", "atom_name",
                       "element", "hetero"):
        assert np.array_equal(getattr(got, annotation),
                              getattr(ref, annotation)), annotation
        assert np.array_equal(getattr(got, annotation),
                              getattr(torch_ca, annotation)), annotation
    (atoms, models), (_, ref_models) = (tpdb.load_ensemble(path),
                                        load_ensemble(path))
    assert models.shape == (1, 40, 3)
    assert np.array_equal(models, ref_models)
    assert np.array_equal(models[0], got.coord)


@pytest.mark.parametrize("maker", MAKERS + ("no_cutoff",))
def test_force_field_tables_match_jax(jax_ca, torch_ca, maker):
    ref = _force_field(sc, jax_ca, maker)
    got = _force_field(sct, torch_ca, maker)
    assert got.natoms == ref.natoms == 40
    assert got.cutoff_distance == ref.cutoff_distance
    assert got.interaction_matrix.dtype == ref.interaction_matrix.dtype
    assert np.array_equal(got.interaction_matrix, ref.interaction_matrix)
    _assert_params_equal(got.to_compact_params(), ref.to_compact_params())
    _assert_params_equal(got.to_params(), ref.to_params())
    ii, jj = np.nonzero(~np.eye(40, dtype=bool))
    sq = np.sum((jax_ca.coord[ii].astype(np.float64)
                 - jax_ca.coord[jj]) ** 2, axis=-1)
    if ref.cutoff_distance is not None:
        keep = sq <= ref.cutoff_distance ** 2
        ii, jj, sq = ii[keep], jj[keep], sq[keep]
    assert np.array_equal(got.force_constant(ii, jj, sq),
                          ref.force_constant(ii, jj, sq))


def test_sd_enm_has_26_bins(torch_ca):
    params = sct.TabulatedForceField.sd_enm(torch_ca).to_compact_params()
    assert params.n_bins == 26 and len(params.edges_sq) == 26
    assert params.intra_table.shape == (20, 20, 26)
    assert params.cutoff_sq == 16.5 ** 2


def test_force_field_rejects_what_jax_rejects(torch_ca):
    atoms = sct.load_structure(os.path.join(DATA, "1l2y.pdb"), model=1)
    with pytest.raises(sct.BadStructureError, match="CA atoms"):
        sct.TabulatedForceField.e_anm(atoms)
    bad = torch_ca.copy()
    bad.res_name[3] = "MSE"
    with pytest.raises(sct.BadStructureError, match="non-canonical"):
        sct.TabulatedForceField.e_anm(bad)
    with pytest.raises(ValueError, match="not symmetric"):
        sct.TabulatedForceField(torch_ca, 1.0, np.arange(400.0).reshape(
            20, 20), 1.0, 13.0)
    with pytest.raises(ValueError, match="Cutoff"):
        sct.InvariantForceField(None)


@pytest.mark.parametrize("cls,args,kind", [
    ("InvariantForceField", (13.0,), "invariant"),
    ("HinsenForceField", (), "hinsen"),
    ("HinsenForceField", (12.0,), "hinsen"),
    ("ParameterFreeForceField", (), "pfenm"),
])
def test_analytic_force_fields_lower_like_jax(cls, args, kind):
    ref = getattr(sc, cls)(*args)
    got = getattr(sct, cls)(*args)
    assert got.cutoff_distance == ref.cutoff_distance
    assert got.to_params() == _carry(ref.to_params())
    assert got.to_params().kind == kind
    sq = np.linspace(1.0, 250.0, 60)
    idx = np.arange(60)
    assert np.array_equal(got.force_constant(idx, idx, sq),
                          ref.force_constant(idx, idx, sq))


@pytest.mark.parametrize("maker", ["sd_enm", "e_anm", "no_cutoff"])
@pytest.mark.parametrize("form", ["to_params", "to_compact_params"])
def test_from_numpy_params_round_trip_tabulated(jax_ca, torch_ca, maker,
                                                form):
    ref = getattr(_force_field(sc, jax_ca, maker), form)()
    got = _carry(ref)
    _assert_params_equal(got, ref)
    assert got == getattr(_force_field(sct, torch_ca, maker), form)()
    assert got.kind == ("table_pair" if form == "to_params"
                        else "table_compact")
    assert got.n_atoms == 40


def test_params_refuse_mismatched_fields():
    with pytest.raises(ValueError, match="array fields"):
        tff.FFParams(kind="table_compact", n_bins=3)
    with pytest.raises(ValueError, match="array fields"):
        tff.FFParams(kind="invariant", pair_table=np.zeros((2, 2, 1)))
    with pytest.raises(ValueError, match="unknown"):
        tff.FFParams(kind="go_model")
    pair = tff.table_pair_params(np.zeros((4, 4, 1)), None)
    with pytest.raises(ValueError, match="no kernel"):
        pair.kind_code
    assert [tff.FFParams(kind=k).kind_code
            for k in ("invariant", "hinsen", "pfenm")] == [0, 1, 2]


def test_atom_code_packs_type_bond_and_chain(torch_ca):
    params = sct.TabulatedForceField.e_anm(torch_ca).to_compact_params()
    code = tff.pack_atom_code(params.type_idx, params.chain_code,
                              params.bonded_next)
    assert code.dtype == np.int32
    assert np.array_equal(code & 31, params.type_idx)
    assert np.array_equal((code >> 5) & 1, params.bonded_next)
    assert np.array_equal(code >> 6, params.chain_code)
    # the last residue of chain A is not bonded to the first of chain B
    assert not params.bonded_next[19] and params.bonded_next[18]
    dev = params.device_tables("cpu", torch.float32)
    assert dev["tables"].shape == (1, 3, 20, 20)
    assert dev is params.device_tables("cpu", torch.float32)
    assert torch.equal(dev["tables"][0, 2],
                       torch.from_numpy(params.bonded_table[..., 0]))


# ---------------------------------------------------------------------------
# Plain table-branch assembly against the JAX kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("maker", ["sd_enm", "e_anm", "no_cutoff"])
def test_plain_assembly_matches_jax_kernels(jax_ca, maker):
    jparams = _force_field(sc, jax_ca, maker).to_compact_params()
    params = _carry(jparams)
    coords = _jiggle(jax_ca.coord, 3)
    n = coords.shape[1]
    tcoords = torch.from_numpy(coords)

    ref_planes = np.stack([np.asarray(p)[:, :n, :n] for p in
                           pallas_kernels.hessian_pallas_ensemble(
                               coords, jparams, interpret=True,
                               raw_planes=True)])
    got_planes = assembly.hessian_planes_plain(tcoords, params)
    assert got_planes.shape == (9, 3, n, n)
    assert _rel(got_planes, ref_planes) <= 1e-5

    ref_xyz = np.asarray(pallas_kernels.hessian_pallas(
        coords[0], jparams, tile=16, interpret=True))
    got_xyz = assembly.hessian_xyz_plain(tcoords[:1], params)[0]
    assert _rel(got_xyz, ref_xyz) <= 1e-5

    ref_k = np.asarray(pallas_kernels.kirchhoff_pallas_ensemble(
        coords, jparams, interpret=True))
    got_k = assembly.kirchhoff_plain(tcoords, params)
    assert _rel(got_k, ref_k) <= 1e-5
    ref_k1 = np.asarray(pallas_kernels.kirchhoff_pallas(
        coords[0], jparams, tile=16, interpret=True))
    assert _rel(got_k[0], ref_k1) <= 1e-5

    # on CPU tensors the wrappers run these plain versions, no launch
    before = assembly_kernels.hessian_planes_ensemble.launches
    via = assembly_kernels.hessian_planes_ensemble(tcoords, params)
    assert torch.equal(via, got_planes)
    assert torch.equal(assembly_kernels.kirchhoff_ensemble(tcoords, params),
                       got_k)
    assert assembly_kernels.hessian_planes_ensemble.launches == before


@pytest.mark.parametrize("maker", ["sd_enm", "e_anm", "no_cutoff"])
@pytest.mark.parametrize("form", ["to_params", "to_compact_params"])
def test_plain_assembly_float64_matches_dense_route(jax_ca, maker, form):
    jparams = getattr(_force_field(sc, jax_ca, maker), form)()
    params = _carry(jparams)
    coord = jax_ca.coord.astype(np.float64)
    tcoord = torch.from_numpy(coord)[None]
    ref_h = jassembly.hessian_matrix(coord, jparams, np, layout="xyz")
    ref_k = jassembly.kirchhoff_matrix(coord, jparams, np)
    assert _rel(assembly.hessian_xyz_plain(tcoord, params)[0],
                ref_h) <= 1e-12
    assert _rel(assembly.kirchhoff_plain(tcoord, params)[0], ref_k) <= 1e-12


def _on_edge_pair(dtype):
    """Twenty atoms on a line; atoms 0 and 3 exactly 4.0 apart (sdENM's
    first bin edge, squared 16.0, exact in float32), atoms 1 and 4
    exactly 16.5 apart (its last edge, the cutoff)."""
    x = np.array([0.0, 0.25, 2.0, 4.0, 16.75] + [20.0 + 3.8 * i
                                                  for i in range(15)])
    coord = np.zeros((20, 3), dtype=dtype)
    coord[:, 0] = x
    return coord


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pair_on_a_bin_edge_takes_the_lower_bin(dtype):
    ca = _ca(jload)
    jparams = sc.TabulatedForceField.sd_enm(ca).to_compact_params()
    params = _carry(jparams)
    coord = _on_edge_pair(dtype)
    got = assembly.kirchhoff_plain(torch.from_numpy(coord)[None],
                                   params)[0].numpy()
    t = params.type_idx
    # strict '>': a distance on an edge stays in the bin the edge closes
    assert got[0, 3] == -params.intra_table[t[0], t[3], 0].astype(dtype)
    assert got[1, 4] == -params.intra_table[t[1], t[4], 25].astype(dtype)
    assert got[0, 4] == 0.0                       # 16.75 > cutoff
    # neighbours in the array are bonded, whatever their distance
    assert got[0, 1] == -params.bonded_table[t[0], t[1], 0].astype(dtype)
    if dtype == np.float32:
        ref = np.asarray(pallas_kernels.kirchhoff_pallas(
            coord, jparams, tile=16, interpret=True))
        ref_e = np.asarray(pallas_kernels.kirchhoff_pallas_ensemble(
            coord[None], jparams, interpret=True))[0]
    else:
        ref = ref_e = jassembly.kirchhoff_matrix(coord, jparams, np)
    off = ~np.eye(20, dtype=bool)
    assert np.array_equal(got[off], ref[off])
    assert np.array_equal(got[off], ref_e[off])


def test_table_size_must_match_coordinates(torch_ca):
    ff = sct.TabulatedForceField.e_anm(torch_ca)
    coords = torch.zeros(1, 30, 3)
    for params in (ff.to_params(), ff.to_compact_params()):
        with pytest.raises(ValueError, match="built for 40 atoms"):
            assembly.kirchhoff_plain(coords, params)


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------

def _masses(n, dtype):
    return np.linspace(0.8, 2.5, n).astype(dtype)


def _check(got, ref, tol, dtype):
    assert set(got) == set(ref)
    for key in ref:
        assert tuple(got[key].shape) == tuple(ref[key].shape), key
        assert got[key].dtype == dtype, key
        assert torch.isfinite(got[key]).all(), key
        assert _rel(got[key], ref[key]) <= tol, key


#: sdENM float32 slices held against float64 truth, max|x - ref| /
#: max|ref|: the port's float32 result to its own tolerance (the test's
#: docstring gives the distances), the JAX package's to this one.  On the
#: overlapping two-chain construct the JAX package's float32 answer moves
#: with XLA's compile options (``tests/conftest.py`` sets optimization
#: level 0): its worst key lies 1.422e-04 from float64 under those flags
#: (the covariance slice's sensor profile) and 1.243e-04 under XLA's
#: defaults (the trace slice's MSF), as far as the port's.
JAX_SD_ENM_TOL = 2e-4


def _check_against_float64(got, ref, truth, tol):
    """The port's float32 `got` and the JAX package's float32 `ref`, each
    held against the float64 `truth` (the JAX package's ``cho_solve``,
    which the port matches to 1e-10): the port to `tol`, the JAX package
    to ``JAX_SD_ENM_TOL``."""
    _check(got, truth, tol, torch.float32)
    assert set(ref) == set(truth)
    for key in truth:
        assert _rel(ref[key], truth[key]) <= JAX_SD_ENM_TOL, key


@pytest.mark.parametrize("maker", ["sd_enm", "e_anm"])
@pytest.mark.parametrize("with_masses", [False, True])
def test_anm_ensemble_traces_blocked_match_jax(jax_ca, maker, with_masses):
    """eANM: the port's float32 slice within 1e-4 of max of the JAX
    package's.  sdENM: both packages' float32 slices within 2e-4 of max
    of the JAX package's float64 ``cho_solve`` result (the port's float64
    matches it to 1e-10).  Measured on this construct without / with
    masses, port / JAX from float64: MSF and B-factors 8.60e-05 /
    2.89e-05 (XLA defaults 1.24e-04) and 9.80e-05 / 1.08e-04, DCC
    6.93e-05 / 4.73e-05 and 9.46e-05 / 1.03e-04; port from JAX up to
    8.41e-05 under the suite's XLA flags, so a 1e-4 comparison of the two
    float32 answers measured XLA's compile options."""
    jparams = _force_field(sc, jax_ca, maker).to_compact_params()
    params = _carry(jparams)
    coords = _jiggle(jax_ca.coord, 4)
    masses = _masses(40, np.float32) if with_masses else None
    ref = jpipe.ensemble_anm_fluctuations(
        jnp.asarray(coords), jparams, masses=masses, inverse="blocked",
        use_pallas=True, with_covariance=False, dtype=jnp.float32)
    got = sct.ensemble_anm_fluctuations(
        coords, params, masses=masses, inverse="blocked",
        with_covariance=False, chunk=2, device="cpu")
    if maker == "e_anm":
        _check(got, ref, 1e-4, torch.float32)
        return
    truth = jpipe.ensemble_anm_fluctuations(
        jnp.asarray(coords.astype(np.float64)), jparams,
        masses=None if masses is None else masses.astype(np.float64),
        inverse="cho_solve", use_pallas=False, with_covariance=False,
        dtype=jnp.float64)
    _check_against_float64(got, ref, truth, 2e-4)


@pytest.mark.parametrize("maker", ["sd_enm", "e_anm"])
def test_anm_ensemble_covariance_prs_blocked_match_jax(jax_ca, maker):
    """eANM: the port's float32 slice within 1e-4 of max of the JAX
    package's (measured 3.4e-6).  sdENM: both packages' float32 slices
    within 2e-4 of max of the JAX package's float64 ``cho_solve`` result
    (the port's float64 matches it to 1e-10), about twice the port's
    worst key.
    Measured, port / JAX from float64 (JAX under the suite's XLA flags,
    then XLA's defaults): covariance 8.56e-05 / 3.41e-05, 7.17e-05; MSF
    and B-factors 7.57e-05 / 3.04e-05, 5.07e-05; DCC 3.01e-05 / 4.62e-05,
    3.19e-05; PRS 1.016e-04 / 1.223e-04, 7.49e-05; effector 6.54e-05 /
    5.30e-05, 6.35e-05; sensor 9.24e-05 / 1.422e-04, 4.78e-05.  The two
    float32 answers lie 1.156e-04 (covariance) and 1.551e-04 (PRS) apart
    under the suite's flags, 4.96e-05 and 6.41e-05 under XLA's defaults:
    a 1e-4 comparison of them measured XLA's compile options."""
    jparams = _force_field(sc, jax_ca, maker).to_compact_params()
    params = _carry(jparams)
    coords = _jiggle(jax_ca.coord, 3)
    ref = jpipe.ensemble_anm_fluctuations(
        jnp.asarray(coords), jparams, inverse="blocked", use_pallas=True,
        with_prs=True, dtype=jnp.float32)
    got = sct.ensemble_anm_fluctuations(
        coords, params, inverse="blocked", with_prs=True, device="cpu")
    assert set(got) == {"covariance", "msf", "bfactor", "dcc", "prs",
                        "effector", "sensor"}
    if maker == "e_anm":
        _check(got, ref, 1e-4, torch.float32)
        return
    truth = jpipe.ensemble_anm_fluctuations(
        jnp.asarray(coords.astype(np.float64)), jparams, inverse="cho_solve",
        use_pallas=False, with_prs=True, dtype=jnp.float64)
    _check_against_float64(got, ref, truth, 2e-4)


@pytest.mark.parametrize("maker", ["sd_enm", "e_anm"])
@pytest.mark.parametrize("with_masses", [False, True])
def test_gnm_ensemble_blocked_matches_jax(jax_ca, maker, with_masses):
    jparams = _force_field(sc, jax_ca, maker).to_compact_params()
    coords = _jiggle(jax_ca.coord, 3)
    masses = _masses(40, np.float32) if with_masses else None
    ref = jpipe.ensemble_gnm_fluctuations(
        jnp.asarray(coords), jparams, masses=masses, inverse="blocked",
        use_pallas=True, dtype=jnp.float32)
    got = sct.ensemble_gnm_fluctuations(
        coords, _carry(jparams), masses=masses, inverse="blocked",
        device="cpu")
    _check(got, ref, 1e-4, torch.float32)


@pytest.mark.parametrize("maker", ["sd_enm", "e_anm"])
@pytest.mark.parametrize("form", ["to_params", "to_compact_params"])
def test_ensembles_cho_solve_float64_match_jax(jax_ca, maker, form):
    jparams = getattr(_force_field(sc, jax_ca, maker), form)()
    params = _carry(jparams)
    coords = _jiggle(jax_ca.coord, 2).astype(np.float64)
    masses = _masses(40, np.float64)
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


@pytest.mark.parametrize("maker", ["sd_enm", "e_anm"])
@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-4),
                                       (np.float64, 1e-10)])
def test_single_structure_matches_jax(maker, dtype, tol):
    """Float64, and float32 eANM: the port within `tol` of max of the
    JAX package.  Float32 sdENM ANM: both packages within their
    tolerance of the JAX package's float64 result (the float64 case of
    this test holds the port's to it): the port's float32 entry point factors in
    float64 behind its float32 assembly, 1.55e-05 from float64 at its
    worst key (covariance), the JAX package's float32 route 6.68e-05
    (sensor profile; 4.36e-05 under XLA's defaults); the two lay
    8.15e-05 apart under the suite's XLA flags."""
    # 1l2y's own 20 residues: the overlapping two-chain construct is
    # conditioned badly enough for sdENM that two float32 Cholesky
    # routines differ by 1e-4 in the PRS on it (each is that far from
    # float64)
    ca = _ca(jload)
    jparams = _force_field(sc, ca, maker).to_compact_params()
    params = _carry(jparams)
    coord = ca.coord.astype(dtype)
    jdtype = jnp.float32 if dtype == np.float32 else jnp.float64
    tdtype = torch.float32 if dtype == np.float32 else torch.float64
    use_pallas = dtype == np.float32
    ref = jpipe.anm_fluctuations(jnp.asarray(coord), jparams, with_prs=True,
                                 dtype=jdtype, use_pallas=use_pallas)
    got = sct.anm_fluctuations(coord, params, with_prs=True, dtype=tdtype,
                               device="cpu")
    if maker == "sd_enm" and dtype == np.float32:
        truth = jpipe.anm_fluctuations(jnp.asarray(coord.astype(np.float64)),
                                       jparams, with_prs=True,
                                       dtype=jnp.float64, use_pallas=False)
        _check_against_float64(got, ref, truth, tol)
    else:
        _check(got, ref, tol, tdtype)
    ref = jpipe.gnm_fluctuations(jnp.asarray(coord), jparams, dtype=jdtype,
                                 use_pallas=use_pallas)
    got = sct.gnm_fluctuations(coord, params, dtype=tdtype, device="cpu")
    _check(got, ref, tol, tdtype)


def test_float32_single_structure_keeps_2e_5_of_float64_on_7cal():
    """The float32 single-structure entry point factors and solves in
    float64 behind its float32 assembly: on the CA trace of 7cal (1776
    residues, four chains) under eANM, whose equilibrated Hessian has a
    condition number of 4.9e3, the MSF stays within 2e-5 relative RMSE of
    the float64 call (an all-float32 Cholesky left 1.7e-4 on an H100)."""
    atoms = sct.load_structure(os.path.join(DATA, "7cal.pdb"), model=1)
    ca = atoms[(atoms.atom_name == "CA") & (atoms.element == "C")]
    assert ca.array_length() == 1776
    params = sct.TabulatedForceField.e_anm(ca).to_compact_params()
    ref = sct.anm_fluctuations(ca.coord.astype(np.float64), params,
                               with_dcc=False, with_covariance=False,
                               dtype=torch.float64, device="cpu")["msf"]
    got = sct.anm_fluctuations(ca.coord, params, with_dcc=False,
                               with_covariance=False, device="cpu")["msf"]
    assert got.dtype == torch.float32
    rmse = float(((got.double() - ref) ** 2).mean().sqrt()
                 / (ref ** 2).mean().sqrt())
    assert rmse <= 2e-5, rmse


def test_table_pair_takes_the_plain_assembly_in_float32(jax_ca):
    """``table_pair`` has no kernel in either package: the blocked
    engine runs on its dense plain Hessians and agrees with the compact
    form of the same force field."""
    ff = sc.TabulatedForceField.e_anm(jax_ca)
    coords = _jiggle(jax_ca.coord, 2)
    pair, compact = _carry(ff.to_params()), _carry(ff.to_compact_params())
    ref = jpipe.ensemble_anm_fluctuations(
        jnp.asarray(coords), ff.to_params(), inverse="blocked",
        with_covariance=False, dtype=jnp.float32)
    launches = {name: w.launches
                for name, w in sct.kernel_wrappers().items()}
    got = sct.ensemble_anm_fluctuations(coords, pair, inverse="blocked",
                                        with_covariance=False, device="cpu")
    _check(got, ref, 1e-4, torch.float32)
    same = sct.ensemble_anm_fluctuations(coords, compact, inverse="blocked",
                                         with_covariance=False, device="cpu")
    for key in got:
        assert _rel(got[key], same[key]) <= 1e-4, key
    gnm = sct.ensemble_gnm_fluctuations(coords, pair, inverse="blocked",
                                        device="cpu")
    gnm_c = sct.ensemble_gnm_fluctuations(coords, compact,
                                          inverse="blocked", device="cpu")
    for key in gnm:
        assert _rel(gnm[key], gnm_c[key]) <= 1e-4, key
    assert launches == {name: w.launches
                        for name, w in sct.kernel_wrappers().items()}


def test_entry_points_lower_force_field_objects(torch_ca):
    ff = sct.TabulatedForceField.sd_enm(torch_ca)
    coords = _jiggle(torch_ca.coord, 2)
    by_object = sct.ensemble_anm_fluctuations(
        coords, ff, inverse="blocked", with_covariance=False, device="cpu")
    by_params = sct.ensemble_anm_fluctuations(
        coords, ff.to_compact_params(), inverse="blocked",
        with_covariance=False, device="cpu")
    for key in by_params:
        assert torch.equal(by_object[key], by_params[key]), key
    analytic = sct.gnm_fluctuations(coords[0], sct.InvariantForceField(13.0),
                                    device="cpu")
    direct = sct.gnm_fluctuations(coords[0], sct.invariant_params(13.0),
                                  device="cpu")
    assert torch.equal(analytic["msf"], direct["msf"])

    class HostOnly(tmodels.ForceField):
        def force_constant(self, atom_i, atom_j, sq_distance):
            return np.ones(len(atom_i))

    with pytest.raises(ValueError, match="no device parameterization"):
        sct.gnm_fluctuations(coords[0], HostOnly(), device="cpu")


def test_spectral_pipeline_takes_a_tabulated_family(jax_ca):
    """The spectral entry points share the assembly: eigenvalues of the
    sdENM Hessian against the JAX package's dense ``eigh``."""
    jparams = sc.TabulatedForceField.sd_enm(jax_ca).to_compact_params()
    coord = jax_ca.coord.astype(np.float64)
    ref = jpipe.anm_observables(jnp.asarray(coord), jparams,
                                dtype=jnp.float64, use_pallas=False)
    got = sct.anm_observables(coord, _carry(jparams), dtype=torch.float64,
                              device="cpu")
    scale = np.abs(np.asarray(ref["eig_values"])).max()
    assert np.abs(got["eig_values"].numpy()
                  - np.asarray(ref["eig_values"])).max() <= 1e-10 * scale
    assert _rel(got["msf"], ref["msf"]) <= 1e-8
