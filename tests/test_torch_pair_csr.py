"""
PyTorch port, the pair CSR of the block-sparse matrix-free operators
(``springcraft_tpu_torch.ops.matfree.pair_csr``, ``pair_csr_plain`` and
the plain applies over it) against ``springcraft_tpu`` on the same numpy
inputs, on the CPU: the pair set and constants against
``springcraft_tpu.ops.pairs.pair_list``, the applies over the list
against the Pallas kernels K13 / K14 in interpret mode, the empty row of
an isolated atom, and the CPU routing.  Morton-sorted layouts as in
``tests/test_torch_matfree.py``: n = 90 at tile 16 (a padded last tile of
10 atoms) and n = 333 at tile 32; the invariant, hinsen and sdENM
(``table_compact``, 26 bins, three chains, original ids for the bonded
test) families.

Tolerances: the constants 1e-12 relative (float64); the applies 1e-10 of
max|y| in float64 and 5e-6 in float32 (the pair values are the tile
walk's, only the order of the sums differs).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import springcraft_tpu as sc  # noqa: E402
from springcraft_tpu.ops import matfree as jmf  # noqa: E402
from springcraft_tpu.ops import pairs as jpairs  # noqa: E402
from springcraft_tpu.structure import load_structure as jload  # noqa: E402
import springcraft_tpu_torch as sct  # noqa: E402
from springcraft_tpu_torch.ops import matfree as tmf  # noqa: E402

from .test_torch_matfree import _JDTYPE, _one_thread, _params  # noqa: E402
from .test_torch_matfree_tables import _jax_permuted  # noqa: E402
from .test_torch_tabulated import _ca, _carry  # noqa: E402
from .util import random_coord  # noqa: E402

__all__ = ["_one_thread"]       # the module-scoped thread pin, reused here

#: (n, tile, box): a padded last tile at 90 / 16
LAYOUTS = [(90, 16, 30.0), (333, 32, 45.0)]
FAMILIES = ["invariant", "hinsen", "sd_enm"]


def _sd_enm(n):
    """sdENM's 26-bin tables in both packages for `n` atoms: residue
    types from a seed, three chains, array neighbours bonded within a
    chain."""
    ca = _ca(jload)
    small = sc.TabulatedForceField.sd_enm(ca).to_compact_params()
    chain = (np.arange(n) * 3 // n).astype(np.int32)
    jp = dataclasses.replace(
        small, type_idx=np.random.RandomState(n).randint(0, 20, n),
        chain_code=chain,
        bonded_next=np.concatenate([chain[:-1] == chain[1:], [False]]))
    return jp, _carry(jp)


def _family(name, n):
    if name == "sd_enm":
        return _sd_enm(n)
    return _params(name, 12.0 if name == "invariant" else 14.0)


def _layout(n, tile, box, jp, seed=5):
    """Original coordinates, the sorted ones, the permutation and the
    tile neighbour lists at the family's cutoff."""
    coord = random_coord(seed, n, box=box)
    perm = tmf.spatial_sort_permutation(coord)
    nbr, counts = tmf.tile_neighbor_lists(coord[perm],
                                          float(np.sqrt(jp.cutoff_sq)), tile)
    return coord, coord[perm], perm.astype(np.int32), nbr, counts


def _sorted(tp, perm):
    return tp.permuted(perm) if tp.kind == "table_compact" else tp


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n,tile,box", LAYOUTS)
def test_pair_set_and_constants_match_jax_pair_list(n, tile, box, family):
    """Slots mapped back to original ids give both directions of JAX
    ``pair_list`` and its float64 constants."""
    jp, tp = _family(family, n)
    coord, sorted_c, perm, nbr, counts = _layout(n, tile, box, jp)
    csr = tmf.tile_csr(nbr, counts, perm, n, tile, "cpu")
    pairs = tmf.pair_csr_plain(torch.as_tensor(sorted_c), _sorted(tp, perm),
                               csr, tile)
    assert pairs.row_ptr.dtype == pairs.slots.dtype == torch.int32
    assert pairs.k.dtype == torch.float64
    rows = np.repeat(np.arange(n), np.diff(pairs.row_ptr.numpy()))
    got = dict(zip(zip(perm[rows], perm[pairs.slots.numpy()]),
                   pairs.k.numpy()))
    i, j, k = jpairs.pair_list(coord, jp)
    ref = {**dict(zip(zip(i, j), k)), **dict(zip(zip(j, i), k))}
    assert len(got) == len(pairs.k) == 2 * len(k) > 0
    assert got.keys() == ref.keys()
    ks = np.array([got[p] for p in ref])
    kr = np.array(list(ref.values()))
    assert np.all(np.abs(ks - kr) <= 1e-12 * np.abs(kr))
    if family == "sd_enm":               # all three table contexts occur
        bonded = (np.abs(i - j) == 1) & jp.bonded_next[np.minimum(i, j)]
        same = jp.chain_code[i] == jp.chain_code[j]
        assert bonded.any() and (same & ~bonded).any() and (~same).any()


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n,tile,box,dtype", [
    (*LAYOUTS[0], torch.float64), (*LAYOUTS[0], torch.float32),
    (*LAYOUTS[1], torch.float64)])
def test_pair_csr_applies_match_pallas(n, tile, box, dtype, family):
    """The plain applies over the pair CSR against K13 and K14 in
    interpret mode on the sorted layout (original ids, sorted codes), for
    k = 5 and k = 1 (the first column); float32 on the small layout (the
    interpreted table kernels take seconds a call)."""
    jp, tp = _family(family, n)
    _, sorted_c, perm, nbr, counts = _layout(n, tile, box, jp)
    c = torch.as_tensor(sorted_c, dtype=dtype)
    csr = tmf.tile_csr(nbr, counts, perm, n, tile, "cpu")
    pairs = tmf.pair_csr_plain(c, _sorted(tp, perm), csr, tile)
    assert pairs.k.dtype == dtype
    jsorted = _jax_permuted(jp, perm) if family == "sd_enm" else jp
    rng = np.random.RandomState(n)
    tol = 1e-10 if dtype == torch.float64 else 5e-6
    for jname, plain, rows in (
            ("hessian_apply_pallas_sparse",
             tmf.hessian_apply_pair_csr_plain, 3 * n),
            ("kirchhoff_apply_pallas_sparse",
             tmf.kirchhoff_apply_pair_csr_plain, n)):
        x = rng.randn(rows, 5)
        ref = np.asarray(getattr(jmf, jname)(
            sorted_c, x, jsorted, nbr, counts, orig_ids=perm, tile=tile,
            dtype=_JDTYPE[dtype]))
        xt = torch.as_tensor(x, dtype=dtype)
        got = plain(c, xt, pairs)
        assert got.dtype == dtype and got.shape == (rows, 5)
        assert _rel(got, ref) < tol, jname
        assert _rel(plain(c, xt[:, :1], pairs), ref[:, :1]) < tol, jname


def test_isolated_atom_has_an_empty_row_and_padding_never_appears():
    """An atom beyond every cutoff gets an empty row and appears in no
    other row; no slot of the padded last tile (n = 90, tile 16) is ever
    a pair; the applies give its rows K x = 0 and H x = 0."""
    jp, tp = _params("invariant", 9.0)
    coord = random_coord(3, 90, box=30.0)
    coord[57] = [200.0, 200.0, 200.0]
    perm = tmf.spatial_sort_permutation(coord)
    sorted_c = coord[perm]
    nbr, counts = tmf.tile_neighbor_lists(sorted_c, 9.0, 16)
    csr = tmf.tile_csr(nbr, counts, perm.astype(np.int32), 90, 16, "cpu")
    c = torch.as_tensor(sorted_c)
    pairs = tmf.pair_csr_plain(c, tp, csr, 16)
    lone = int(np.flatnonzero(perm == 57)[0])
    row_ptr = pairs.row_ptr.numpy()
    assert row_ptr[lone + 1] == row_ptr[lone]
    assert lone not in set(pairs.slots.tolist())
    assert int(pairs.slots.max()) < 90 and int(pairs.slots.min()) >= 0
    assert np.all(np.diff(row_ptr[:-1]) >= 0) and row_ptr[-1] == len(
        pairs.slots)
    x = torch.as_tensor(np.random.RandomState(1).randn(90, 2))
    y = tmf.kirchhoff_apply_pair_csr_plain(c, x, pairs)
    assert torch.all(y[lone] == 0)
    y3 = tmf.hessian_apply_pair_csr_plain(c, x.repeat(3, 1), pairs)
    assert torch.all(y3[lone::90] == 0)


def test_cpu_route_of_the_build_and_the_applies():
    """On CPU tensors the build wrapper is its plain version, the gather
    route runs the plain applies over the list, the public sparse
    wrappers keep the tile walk and agree with both, and nothing counts
    as a kernel launch; off the kernel route the solvers build no pair
    CSR."""
    jp, tp = _params("hinsen", 10.0)
    coord, sorted_c, perm, nbr, counts = _layout(90, 16, 30.0, jp)
    c = torch.as_tensor(sorted_c)
    csr = tmf.tile_csr(nbr, counts, perm, 90, 16, "cpu")
    wrappers = sct.kernel_wrappers()
    before = {name: w.launches for name, w in wrappers.items()}
    pairs = tmf.pair_csr(c, tp, csr, 16)
    plain = tmf.pair_csr_plain(c, tp, csr, 16)
    assert all(torch.equal(a, b) for a, b in zip(pairs, plain))
    x = torch.as_tensor(np.random.RandomState(2).randn(270, 3))
    for wrapper, xv in ((tmf.hessian_apply_sparse, x),
                        (tmf.kirchhoff_apply_sparse, x[:90])):
        over_list = tmf._apply_pairs(wrapper, c, xv, pairs)
        walk = wrapper(c, xv, tp, nbr, counts, perm, tile=16,
                       dtype=torch.float64)
        assert _rel(over_list, walk.numpy()) < 1e-12
    assert {name: w.launches for name, w in wrappers.items()} == before
    setup = tmf._sparse_setup(torch.as_tensor(coord), tp, None, 16, False)
    assert setup[-1] is None


def test_pair_csr_refuses_a_tile_csr_of_other_atoms():
    jp, tp = _params("invariant", 9.0)
    _, sorted_c, perm, nbr, counts = _layout(90, 16, 30.0, jp)
    csr = tmf.tile_csr(nbr, counts, perm, 90, 16, "cpu")
    with pytest.raises(ValueError, match="does not describe 80 atoms"):
        tmf.pair_csr(torch.as_tensor(sorted_c[:80]), tp, csr, 16)
    pairs = tmf.pair_csr(torch.as_tensor(sorted_c), tp, csr, 16)
    with pytest.raises(ValueError, match="does not fit 80 atoms"):
        tmf._apply_pairs(tmf.kirchhoff_apply_sparse,
                         torch.as_tensor(sorted_c[:80]),
                         torch.zeros(80, 2, dtype=torch.float64), pairs)
    with pytest.raises(TypeError, match="float32"):
        tmf._apply_pairs(tmf.kirchhoff_apply_sparse,
                         torch.as_tensor(sorted_c),
                         torch.zeros(90, 2, dtype=torch.float32), pairs)
