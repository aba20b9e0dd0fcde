"""
PyTorch port, the interaction layer of the model API:
``compute_kirchhoff`` / ``compute_hessian`` (dense path on
``device="cpu"`` in float64, and the host path of a custom force field),
the numpy cell list, the network checks and the residue masses, each
held against the JAX package on the same inputs (x64 on) and against
the ProDy, bio3d and BioPhysConnectoR golden files at the tolerances of
``tests/test_interaction.py`` and ``tests/test_anm.py``.

Tolerances: matrices 1e-12 of max|x| against the JAX package (the same
float64 formulas), pair lists exactly, golden files as the JAX tests
hold them.
"""

import itertools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import springcraft_tpu as sc  # noqa: E402
from springcraft_tpu.structure import celllist as jcelllist  # noqa: E402
from springcraft_tpu.structure import info as jinfo  # noqa: E402
from springcraft_tpu.utils import network as jnetwork  # noqa: E402
import springcraft_tpu_torch as sct  # noqa: E402
from springcraft_tpu_torch.structure import info  # noqa: E402
from springcraft_tpu_torch.structure.celllist import CellList  # noqa: E402
from springcraft_tpu_torch.utils import network  # noqa: E402

from .conftest import load_csv  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.realpath(__file__)), "data")


def _ca(module, name):
    atoms = module.load_structure(os.path.join(DATA, f"{name}.pdb"), model=1)
    return atoms[(atoms.atom_name == "CA") & (atoms.element == "C")]


@pytest.fixture(scope="module")
def cas():
    """The 1l2y CA trace read by each package."""
    return _ca(sc.structure, "1l2y"), _ca(sct, "1l2y")


class HostOnly(sct.ForceField):
    """A port force field behind the ``ForceField`` contract alone (no
    ``to_params``): the host path."""

    def __init__(self, inner):
        self._inner = inner

    def force_constant(self, atom_i, atom_j, sq_distance):
        return self._inner.force_constant(atom_i, atom_j, sq_distance)

    @property
    def cutoff_distance(self):
        return self._inner.cutoff_distance

    @property
    def contact_shutdown(self):
        return self._inner.contact_shutdown

    @property
    def contact_pair_off(self):
        return self._inner.contact_pair_off

    @property
    def contact_pair_on(self):
        return self._inner.contact_pair_on

    @property
    def natoms(self):
        return self._inner.natoms


def _patched(module, ff):
    return module.PatchedForceField(
        ff, contact_shutdown=[3], contact_pair_off=[[0, 1], [5, 9]],
        contact_pair_on=[[2, 17]], force_constants=[0.5])


#: (name, maker(package module, CA trace)) of the force fields compared.
FORCE_FIELDS = [
    ("invariant7", lambda m, ca: m.InvariantForceField(7.0)),
    ("invariant13", lambda m, ca: m.InvariantForceField(13.0)),
    ("hinsen", lambda m, ca: m.HinsenForceField()),
    ("pfenm", lambda m, ca: m.ParameterFreeForceField()),
    ("eanm", lambda m, ca: m.TabulatedForceField.e_anm(ca)),
    ("sdenm", lambda m, ca: m.TabulatedForceField.sd_enm(ca)),
    ("patched", lambda m, ca: _patched(m, m.InvariantForceField(9.0))),
]


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("which", ["kirchhoff", "hessian"])
@pytest.mark.parametrize("name,make", FORCE_FIELDS,
                         ids=[f[0] for f in FORCE_FIELDS])
def test_matrices_and_pairs_match_jax(cas, which, name, make):
    jca, tca = cas
    jfn = getattr(sc, f"compute_{which}")
    tfn = getattr(sct, f"compute_{which}")
    ref, ref_pairs = jfn(jca.coord, make(sc, jca))
    got, pairs = tfn(tca.coord, make(sct, tca), device="cpu")
    assert got.dtype == np.float64 and got.flags.writeable
    assert _rel(got, ref) <= 1e-12
    np.testing.assert_array_equal(pairs, ref_pairs)
    assert tfn(tca.coord, make(sct, tca), return_pairs=False,
               device="cpu")[1] is None


@pytest.mark.parametrize(
    "seed, cutoff, host",
    itertools.product([1, 323, 777, 999], [5, 10, 15], [False, True]))
def test_kirchhoff_vs_prody(seed, cutoff, host):
    coord = load_csv(f"random_coord_seed_{seed}.csv.gz")
    ff = sct.InvariantForceField(cutoff)
    kirchhoff, _ = sct.compute_kirchhoff(coord, HostOnly(ff) if host else ff,
                                         device="cpu")
    assert np.allclose(kirchhoff, load_csv(
        f"prody_gnm_{cutoff}_ang_cutoff_kirchhoff_random_coords_seed_"
        f"{seed}.csv.gz"))


@pytest.mark.parametrize("seed, host",
                         itertools.product([1, 323, 777, 999],
                                           [False, True]))
def test_hessian_vs_prody(seed, host):
    coord = load_csv(f"random_coord_seed_{seed}.csv.gz")
    ff = sct.InvariantForceField(10)
    hessian, _ = sct.compute_hessian(coord, HostOnly(ff) if host else ff,
                                     device="cpu")
    assert np.allclose(hessian, load_csv(
        f"prody_anm_10_ang_cutoff_hessian_random_coords_seed_{seed}.csv.gz"),
        atol=1e-6, rtol=1e-3)


@pytest.mark.parametrize("ff_name,make,atol", [
    ("calpha", lambda ca: sct.HinsenForceField(), 1e-4),
    ("sdenm", lambda ca: sct.TabulatedForceField.sd_enm(ca), 0.0),
    ("pfanm", lambda ca: sct.ParameterFreeForceField(), 0.0)])
def test_hessian_vs_bio3d(cas, ff_name, make, atol):
    tca = cas[1]
    hessian, _ = sct.compute_hessian(tca.coord, make(tca), device="cpu")
    ref = load_csv(f"bio3d_anm_{ff_name}_ff_hessian_1l2y.csv.gz")
    assert np.allclose(hessian, ref, atol=atol)


@pytest.mark.parametrize("variant,atol", [("", 1e-8), ("_ke", 1e-4),
                                          ("_mj", 1e-8)])
def test_hessian_vs_biophysconnector(cas, variant, atol):
    tca = cas[1]
    ff = {"": sct.TabulatedForceField.e_anm,
          "_ke": sct.TabulatedForceField.e_anm_ke,
          "_mj": sct.TabulatedForceField.e_anm_mj}[variant](tca)
    hessian, _ = sct.compute_hessian(tca.coord, ff, device="cpu")
    ref = load_csv(f"biophysconnector_anm_eanm{variant}_hessian_1l2y.csv.gz",
                   skip_header=1)
    assert np.allclose(hessian, ref, atol=atol)


@pytest.mark.parametrize("use_cell_list", [False, True])
@pytest.mark.parametrize("name,make", FORCE_FIELDS[:5] + FORCE_FIELDS[6:],
                         ids=[f[0] for f in FORCE_FIELDS[:5]
                              + FORCE_FIELDS[6:]])
def test_host_path_matches_the_dense_path_and_jax(cas, name, make,
                                                  use_cell_list):
    """The host path (``force_constant`` over the pair list, optionally
    through the cell list) equals the dense path and the JAX package's
    host path."""
    jca, tca = cas
    for which in ("kirchhoff", "hessian"):
        tfn = getattr(sct, f"compute_{which}")
        dense, dense_pairs = tfn(tca.coord, make(sct, tca), device="cpu")
        host, host_pairs = tfn(tca.coord, HostOnly(make(sct, tca)),
                               use_cell_list, device="cpu")
        from .util import HostOnlyForceField

        ref, _ = getattr(sc, f"compute_{which}")(
            jca.coord, HostOnlyForceField(make(sc, jca)), use_cell_list)
        np.testing.assert_array_equal(host_pairs, dense_pairs)
        assert np.allclose(host, dense, rtol=1e-12, atol=1e-12)
        assert np.allclose(host, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("use_cell_list", [False, True])
def test_cartesian_index_product(use_cell_list):
    """Without a cutoff, every pair except self-pairs interacts."""

    class AllConnected(sct.ForceField):
        def force_constant(self, atom_i, atom_j, sq_distance):
            return np.ones(len(atom_i))

    coord = np.random.RandomState(0).rand(10, 3) * 50
    _, pairs = sct.compute_hessian(coord, AllConnected(), use_cell_list,
                                   device="cpu")
    matrix = np.zeros((10, 10), dtype=bool)
    matrix[pairs[:, 0], pairs[:, 1]] = True
    assert (matrix == ~np.eye(10, dtype=bool)).all()


def test_interaction_errors(cas):
    with pytest.raises(ValueError):
        sct.compute_kirchhoff(np.zeros((5, 2)), sct.InvariantForceField(7.0),
                              device="cpu")
    with pytest.raises(ValueError):
        sct.compute_kirchhoff(np.zeros((5, 3)),
                              sct.TabulatedForceField.e_anm(cas[1]),
                              device="cpu")
    class SelfContact(HostOnly):
        @property
        def contact_pair_on(self):
            return np.array([[1, 1]])

    with pytest.raises(ValueError, match="itself"):
        sct.compute_kirchhoff(cas[1].coord,
                              SelfContact(sct.InvariantForceField(7.0)),
                              device="cpu")


@pytest.mark.parametrize("n,cutoff", [(300, 7.0), (2100, 6.0)])
def test_cell_list_matches_jax_and_brute_force(n, cutoff):
    """Below 2,049 atoms one distance mask, above it the grid buckets:
    both the brute-force adjacency exactly, as the JAX package's numpy
    path gives it."""
    coord = np.random.RandomState(n).rand(n, 3) * 40.0
    got = CellList(coord, cutoff).create_adjacency_matrix(cutoff)
    diff = coord[:, None, :] - coord[None, :, :]
    np.testing.assert_array_equal(
        got, np.einsum("ijk,ijk->ij", diff, diff) <= cutoff ** 2)
    np.testing.assert_array_equal(
        got, jcelllist.CellList(coord, cutoff)._python_adjacency(cutoff))
    with pytest.raises(ValueError):
        CellList(coord, cutoff).create_adjacency_matrix(cutoff + 1.0)
    with pytest.raises(ValueError):
        CellList(coord, 0.0)


@pytest.mark.parametrize("cutoff", [3.0, 4.0, 7.0])
def test_network_checks_match_jax(cas, cutoff):
    coord = cas[1].coord
    assert network.is_connected(coord, cutoff) == \
        jnetwork.is_connected(coord, cutoff)
    diff = coord[:, None, :] - coord[None, :, :]
    adj = np.einsum("ijk,ijk->ij", diff, diff) <= cutoff ** 2
    labels, count = network.connected_components(adj)
    ref_labels, ref_count = jnetwork.connected_components(adj)
    np.testing.assert_array_equal(labels, ref_labels)
    assert count == ref_count


def test_residue_masses_match_jax(cas):
    names = cas[1].res_name
    np.testing.assert_array_equal(info.residue_masses(names),
                                  jinfo.residue_masses(cas[0].res_name))
    assert info.mass("C", is_residue=False) == jinfo.mass("C", False)
    assert info.mass("gly") == jinfo.mass("GLY", True)
    with pytest.raises(KeyError, match="XYZ"):
        info.residue_masses(np.array(["ALA", "XYZ"]))
    with pytest.raises(KeyError):
        info.mass("XX", is_residue=False)
