"""
PyTorch port, ``ops/pairs.py``: the neighbour search, the per-pair
constants of every family with and without patch overlays, the sparse
interaction set and the float64 pair-list operator applies, held against
the JAX package on the same numpy inputs; and the ``PatchedForceField``
around a tabulated field (it lowers to ``table_pair``), whose dense
assembly agrees in both packages and which both matrix-free paths refuse.

Tolerances: the pair sets are equal exactly (the JAX package's native
cell list orders a row's pairs otherwise, so they are compared as sets,
values keyed by pair); constants and applies to 1e-12 of max in float64.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import springcraft_tpu as sc  # noqa: E402
from springcraft_tpu.ops import assembly as jassembly  # noqa: E402
from springcraft_tpu.ops import ffparams as jff  # noqa: E402
from springcraft_tpu.ops import matfree as jmatfree  # noqa: E402
from springcraft_tpu.ops import pairs as jpairs  # noqa: E402
from springcraft_tpu.structure import load_structure as jload  # noqa: E402
import springcraft_tpu_torch as sct  # noqa: E402
from springcraft_tpu_torch.ops import assembly  # noqa: E402
from springcraft_tpu_torch.ops import pairs  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.realpath(__file__)), "data")
ARRAY_FIELDS = ("pair_table", "type_idx", "chain_code", "bonded_next",
                "intra_table", "inter_table", "bonded_table")
OVERLAY_FIELDS = ("off_mask", "on_mask", "values", "has_value")
N = 40
SHUTDOWN = [3]
PAIR_OFF = [[1, 2], [5, 9], [20, 21]]
PAIR_ON = [[3, 2], [3, 4], [3, 5], [3, 22], [0, 30], [10, 39]]
CONSTANTS = [2.5, 0.75, 1.25, 0.875, 1.75, 0.5]
FAMILIES = ("invariant", "hinsen", "pfenm", "sd_enm", "e_anm", "s_enm_10",
            "table_pair")


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
def atoms():
    return _ca(jload), _ca(sct.load_structure)


def _fields(params):
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


def _params(atoms, family, patched):
    """The same family in both packages (JAX params, port params)."""
    jca, tca = atoms
    out = []
    for module, ca in ((sc, jca), (sct, tca)):
        if family in ("invariant", "hinsen", "pfenm"):
            base = getattr(jff if module is sc else sct,
                           f"{family}_params")(9.0)
            inner = {"invariant": module.InvariantForceField(9.0),
                     "hinsen": module.HinsenForceField(9.0),
                     "pfenm": module.ParameterFreeForceField(9.0)}[family]
        elif family == "table_pair":
            inner = module.TabulatedForceField.e_anm(ca)
            base = inner.to_params()
        else:
            inner = getattr(module.TabulatedForceField, family)(ca)
            base = inner.to_compact_params()
        if patched:
            overlays = module.PatchedForceField(
                inner, contact_shutdown=SHUTDOWN, contact_pair_off=PAIR_OFF,
                contact_pair_on=PAIR_ON, force_constants=CONSTANTS
            ).to_params(natoms=N).overlays
            base = dataclasses.replace(base, overlays=overlays) \
                if module is sc else base.replace(overlays=overlays)
        out.append(base)
    return out


def _keyed(i, j, k):
    i, j, k = (np.asarray(torch.as_tensor(x).cpu()) for x in (i, j, k))
    order = np.lexsort((j, i))
    return i[order], j[order], np.asarray(k, np.float64)[order]


def _rel(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    scale = np.max(np.abs(ref))
    return np.max(np.abs(got - ref)) / (scale if scale else 1.0)


@pytest.mark.parametrize("cutoff", [4.0, 7.0, 13.0])
def test_neighbor_pairs_match_jax(atoms, cutoff):
    coord = np.asarray(atoms[0].coord, np.float64)
    ref = jpairs.neighbor_pairs(coord, cutoff)
    got = pairs.neighbor_pairs(coord, cutoff)
    assert got[0].dtype == np.int64 and np.all(got[0] < got[1])
    assert np.array_equal(_keyed(*got, got[0])[:2], _keyed(*ref, ref[0])[:2])
    # lexicographic, as the JAX package's fallback returns them
    assert np.array_equal(np.lexsort((got[1], got[0])),
                          np.arange(len(got[0])))


def test_neighbor_pairs_of_isolated_atoms_are_empty():
    i, j = pairs.neighbor_pairs(np.array([[0.0, 0, 0], [50.0, 0, 0]]), 5.0)
    assert i.shape == j.shape == (0,) and i.dtype == np.int64


@pytest.mark.parametrize("patched", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_pair_list_matches_jax(atoms, family, patched):
    jparams, tparams = _params(atoms, family, patched)
    coord = np.asarray(atoms[0].coord, np.float64)
    ref = _keyed(*jpairs.pair_list(coord, jparams))
    got = pairs.pair_list(coord, tparams, device="cpu")
    assert got[2].dtype == torch.float64
    got = _keyed(*got)
    assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
    assert _rel(got[2], ref[2]) <= 1e-12
    if patched:
        # switched-on pairs beyond the cutoff are in, switched-off out
        keys = set(zip(got[0].tolist(), got[1].tolist()))
        assert (0, 30) in keys and (10, 39) in keys
        assert (1, 2) not in keys and (5, 9) not in keys


@pytest.mark.parametrize("patched", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_pair_force_constants_match_jax(atoms, family, patched):
    jparams, tparams = _params(atoms, family, patched)
    coord = np.asarray(atoms[0].coord, np.float64)
    i, j = np.triu_indices(N, 1)
    d = coord[i] - coord[j]
    sq = np.sum(d * d, axis=1)
    ref = jpairs.pair_force_constants(i, j, sq, jparams)
    got = pairs.pair_force_constants(torch.from_numpy(i),
                                     torch.from_numpy(j),
                                     torch.from_numpy(sq), tparams)
    assert _rel(got, ref) <= 1e-12


def test_pair_list_takes_precomputed_pairs(atoms):
    jparams, tparams = _params(atoms, "sd_enm", True)
    coord = np.asarray(atoms[0].coord, np.float64)
    cut = pairs.neighbor_pairs(coord, 9.0)
    ref = _keyed(*jpairs.pair_list(coord, jparams, pairs=cut))
    got = _keyed(*pairs.pair_list(coord, tparams, pairs=cut, device="cpu"))
    assert all(np.array_equal(g, r) for g, r in zip(got[:2], ref[:2]))
    assert _rel(got[2], ref[2]) <= 1e-12


def test_pair_list_needs_a_cutoff():
    coord = np.random.RandomState(0).rand(10, 3) * 5
    for module, params in ((jpairs, jff.hinsen_params(None)),
                           (pairs, sct.hinsen_params(None))):
        with pytest.raises(ValueError, match="finite cutoff"):
            module.pair_list(coord, params)


@pytest.mark.parametrize("k", [1, 6])
@pytest.mark.parametrize("family", ["invariant", "sd_enm", "e_anm"])
def test_pair_applies_match_jax_and_the_dense_matrices(atoms, family, k):
    jparams, tparams = _params(atoms, family, True)
    coord = np.asarray(atoms[0].coord, np.float64)
    i, j, kv = jpairs.pair_list(coord, jparams)
    d = coord[i] - coord[j]
    g = kv / np.sum(d * d, axis=1)
    rng = np.random.RandomState(k)
    v = rng.randn(N, 3, k)
    ref = jpairs.hessian_apply_pairs(coord, i, j, g, v)
    ti, tj = torch.from_numpy(i), torch.from_numpy(j)
    got = pairs.hessian_apply_pairs(torch.from_numpy(coord), ti, tj,
                                    torch.from_numpy(g), torch.from_numpy(v))
    assert got.shape == (N, 3, k) and _rel(got, ref) <= 1e-12
    h = assembly.hessian_matrix(torch.from_numpy(coord), tparams)
    dense = (h @ torch.from_numpy(v.reshape(3 * N, k))).reshape(N, 3, k)
    assert _rel(got, dense) <= 1e-12
    w = rng.randn(N, k)
    ref = jpairs.kirchhoff_apply_pairs(i, j, kv, N, w)
    got = pairs.kirchhoff_apply_pairs(ti, tj, torch.from_numpy(kv), N,
                                      torch.from_numpy(w))
    assert _rel(got, ref) <= 1e-12
    dense = assembly.kirchhoff_matrix(torch.from_numpy(coord), tparams) \
        @ torch.from_numpy(w)
    assert _rel(got, dense) <= 1e-12


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("family", ["e_anm", "sd_enm", "s_enm_13"])
def test_patched_tabulated_field_assembles_as_in_jax(atoms, family, dtype):
    """A ``PatchedForceField`` around a tabulated field lowers to
    ``table_pair`` with its overlay in both packages, and the dense
    Hessian and Kirchhoff matrices agree."""
    jca, tca = atoms
    kwargs = dict(contact_shutdown=SHUTDOWN, contact_pair_off=PAIR_OFF,
                  contact_pair_on=PAIR_ON, force_constants=CONSTANTS)
    jparams = sc.PatchedForceField(
        getattr(sc.TabulatedForceField, family)(jca),
        **kwargs).to_params(natoms=N)
    tparams = sct.PatchedForceField(
        getattr(sct.TabulatedForceField, family)(tca),
        **kwargs).to_params(natoms=N)
    assert jparams.kind == tparams.kind == "table_pair"
    assert len(tparams.overlays) == len(jparams.overlays) == 1
    coord = np.asarray(jca.coord, dtype)
    tol = 1e-12 if dtype == np.float64 else 1e-5
    for layout in ("atom", "xyz"):
        ref = jassembly.hessian_matrix(coord, jparams, np, layout=layout)
        got = assembly.hessian_matrix(torch.from_numpy(coord), tparams,
                                      layout=layout)
        assert got.dtype == torch.from_numpy(coord).dtype
        assert _rel(got, ref) <= tol
    ref = jassembly.kirchhoff_matrix(coord, jparams, np)
    got = assembly.kirchhoff_matrix(torch.from_numpy(coord), tparams)
    assert _rel(got, ref) <= tol


def test_matrix_free_paths_refuse_a_patched_tabulated_field(atoms):
    jca, tca = atoms
    jparams = sc.PatchedForceField(sc.TabulatedForceField.e_anm(jca),
                                   contact_shutdown=SHUTDOWN
                                   ).to_params(natoms=N)
    tparams = sct.PatchedForceField(sct.TabulatedForceField.e_anm(tca),
                                    contact_shutdown=SHUTDOWN
                                    ).to_params(natoms=N)
    coord = np.asarray(jca.coord, np.float64)
    with pytest.raises(ValueError, match="table_pair"):
        jmatfree.lowest_modes_matfree(coord, jparams, 3)
    for fn in (sct.lowest_modes_matfree, sct.lowest_modes_matfree_gnm):
        with pytest.raises(ValueError, match="table_pair"):
            fn(coord, tparams, 3, device="cpu")
    with pytest.raises(ValueError, match="table_pair"):
        sct.covariance_solve_matfree(coord, tparams, np.ones(3 * N),
                                     device="cpu")
