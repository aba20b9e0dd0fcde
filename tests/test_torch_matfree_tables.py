"""
PyTorch port, the matrix-free slice for a tabulated family and for patch
overlays, against ``springcraft_tpu.ops.matfree`` on the same numpy
inputs, on the CPU: what ``tests/test_torch_matfree.py`` checks for the
analytic families, for ``table_compact`` (three distance bins, two
chains, in Morton order, so that bonded pairs land in different tiles)
and for overlays on both kinds of family — the row-blocked operators,
the plain routes of the three kernel wrappers against the Pallas kernels
in interpret mode, the overlay applies with ``pos=``, the degree and
diagonal passes, Chebyshev modes and the deflated CG solvers.

Tolerances as there: operators 1e-10 (float64) and 5e-6 of max|y|
(float32), overlay applies 1e-12 / 1e-6, degree passes 1e-12, eigenvalues
1e-8 relative and subspace overlap above 1 - 1e-8, CG solutions 1e-8.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from springcraft_tpu.ops import ffparams as jff  # noqa: E402
from springcraft_tpu.ops import matfree as jmf  # noqa: E402
import springcraft_tpu_torch as sct  # noqa: E402
from springcraft_tpu_torch.ops import matfree as tmf  # noqa: E402

from .test_torch_matfree import (_JDTYPE, WRAPPERS, _cg_case,  # noqa: E402
                                 _one_thread, _params, _rel, _sorted_layout)
from .util import random_coord  # noqa: E402

__all__ = ["_one_thread"]       # the module-scoped thread pin, reused here


_TABLE_EDGES = (5.0, 8.0, 11.0)


def _table_params(n, seed=3, overlay=False, connected=False):
    """The same ``table_compact`` family in both packages: float32 type
    tables over three bins (as a force field stores them), random types,
    two chains, every array neighbour inside a chain bonded; with
    `overlay` one patch on top: an atom shut down and (`connected`)
    re-attached by switched-on pairs, pairs off, pairs on."""
    rng = np.random.RandomState(seed)

    def table(scale):
        t = (scale * (0.5 + rng.rand(20, 20, 3))).astype(np.float32)
        return t + t.transpose(1, 0, 2)

    chain = (np.arange(n) >= n // 2).astype(np.int32)
    args = (rng.randint(0, 20, n), chain,
            np.concatenate([chain[:-1] == chain[1:], [False]]),
            table(10.0), table(1.0), table(0.5), np.array(_TABLE_EDGES))
    jp, tp = jff.table_compact_params(*args), sct.table_compact_params(*args)
    if overlay:
        masks = _overlay_masks(n, connected)
        jp = jff.with_overlay(jp, *masks)
        tp = sct.with_overlay(tp, *masks)
    return jp, tp


def _overlay_masks(n, connected):
    off = np.zeros((n, n), bool)
    on = np.zeros((n, n), bool)
    values = np.zeros((n, n))
    off[7, :] = off[:, 7] = True
    pairs_on = [(2, n - 3, 1.5), (10, 40, 0.25)]
    if connected:
        pairs_on += [(7, 6, 2.0), (7, 8, 1.0), (7, 9, 0.5), (7, 20, 0.75)]
    for i, j in ((1, 2), (15, 16), (30, 33)):
        off[i, j] = off[j, i] = True
    for i, j, value in pairs_on:
        on[i, j] = on[j, i] = True
        values[i, j] = values[j, i] = value
    return off, on, values, on.copy()


def _jax_permuted(jp, perm):
    """JAX parameters in the order `perm` (``_sparse_setup``'s rule)."""
    import dataclasses

    changes = {}
    if jp.kind == "table_compact":
        changes = {f: np.asarray(getattr(jp, f))[perm]
                   for f in ("type_idx", "chain_code", "bonded_next")}
    overlays = tuple(jff.PatchOverlay(*(
        np.asarray(getattr(o, f))[perm][:, perm]
        for f in ("off_mask", "on_mask", "values", "has_value")))
        for o in jp.overlays)
    return dataclasses.replace(jp, overlays=overlays, **changes)


def _families(n):
    jp, tp = _params("invariant", 11.0)
    masks = _overlay_masks(n, connected=True)
    return {
        "table": _table_params(n),
        "table-overlay": _table_params(n, overlay=True, connected=True),
        "invariant-overlay": (jff.with_overlay(jp, *masks),
                              sct.with_overlay(tp, *masks)),
    }


FAMILIES = ("table", "table-overlay", "invariant-overlay")


@pytest.mark.parametrize("op", ["hessian_apply", "kirchhoff_apply"])
@pytest.mark.parametrize("family", FAMILIES)
def test_tabulated_and_patched_row_blocked_operators_match_jax(op, family):
    n = 90
    coord = random_coord(3, n, box=30.0)
    jp, tp = _families(n)[family]
    rows = 3 * n if op == "hessian_apply" else n
    x = np.random.RandomState(0).randn(rows, 5)
    ref = getattr(jmf, op)(coord, x, jp, block=32, dtype=jnp.float64)
    got = getattr(tmf, op)(coord, x, tp, block=32, dtype=torch.float64,
                           device="cpu")
    assert _rel(got, ref) < 1e-10
    vec = getattr(tmf, op)(coord, x[:, 0], tp, block=32,
                           dtype=torch.float64, device="cpu")
    assert vec.shape == (rows,) and _rel(vec, np.asarray(ref)[:, 0]) < 1e-10


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
@pytest.mark.parametrize("family", FAMILIES)
def test_tabulated_and_patched_plain_routes_match_pallas(family, wrapper,
                                                         dtype):
    """The three wrappers' CPU routes against the Pallas kernels in
    interpret mode with the parameters in Morton order (codes and masks
    by slot, ``orig_ids=perm`` for the bonded test): array neighbours of
    a chain land in different tiles of 16."""
    jname, _, node = WRAPPERS[wrapper]
    coord, ids, nbr, counts = _sorted_layout(cutoff=11.0)
    n = coord.shape[0]
    jp, tp = _families(n)[family]
    x = np.random.RandomState(9).randn(n if node else 3 * n, 5)
    if wrapper == "hessian_apply_dense":
        # atom order: ids = arange(n), nothing is permuted
        original = coord[np.argsort(ids)]
        ref = jmf.hessian_apply_pallas(original, x, jp, tile=16,
                                       dtype=_JDTYPE[dtype])
        got = tmf.hessian_apply_dense(original, x, tp, tile=16, dtype=dtype,
                                      device="cpu")
    else:
        split = np.abs(np.diff(np.argsort(ids) // 16)) > 0
        assert split.sum() > 10          # bonded pairs across tiles
        ref = getattr(jmf, jname)(coord, x, _jax_permuted(jp, ids), nbr,
                                  counts, orig_ids=ids, tile=16,
                                  dtype=_JDTYPE[dtype])
        got = getattr(tmf, wrapper)(coord, x, tp.permuted(ids), nbr, counts,
                                    ids, tile=16, dtype=dtype, device="cpu")
    assert got.dtype == dtype
    assert _rel(got, ref) < (1e-10 if dtype == torch.float64 else 5e-6)


@pytest.mark.parametrize("family", ["table-overlay", "invariant-overlay"])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-6)])
def test_overlay_apply_matches_jax(family, dtype, tol):
    """``(Delta H) @ x`` and ``(Delta K) @ x`` in atom order and, with
    ``pos=``, on reordered atoms."""
    n = 90
    coord = random_coord(3, n, box=30.0)
    jp, tp = _families(n)[family]
    perm = np.random.RandomState(1).permutation(n)
    rng = np.random.RandomState(0)
    for name, rows in (("overlay_apply_hessian", 3 * n),
                       ("overlay_apply_kirchhoff", n)):
        x = rng.randn(rows, 4)
        ref = getattr(jmf, name)(coord, x, jp, dtype=_JDTYPE[dtype])
        got = getattr(tmf, name)(coord, x, tp, dtype=dtype, device="cpu")
        assert got.dtype == dtype and _rel(got, ref) < tol, name
        assert float(np.abs(np.asarray(ref)).max()) > 0
        ref = getattr(jmf, name)(coord[perm], x, _jax_permuted(jp, perm),
                                 dtype=_JDTYPE[dtype], pos=perm)
        got = getattr(tmf, name)(coord[perm], x, tp.permuted(perm),
                                 dtype=dtype, pos=perm, device="cpu")
        assert _rel(got, ref) < tol, name
        vec = getattr(tmf, name)(coord, x[:, 0], tp, dtype=dtype,
                                 device="cpu")
        assert vec.shape == (rows,)


@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_tabulated_and_patched_degree_passes_match_jax(family, masses):
    n = 100
    coord = random_coord(17, n, box=28.0)
    jp, tp = _families(n)[family]
    m = (50.0 + 100.0 * np.random.RandomState(5).rand(n)) if masses \
        else None
    got = tmf.hessian_degree_bound(coord, tp, masses=m, dtype=torch.float64,
                                   device="cpu", block=32)
    ref = jmf.hessian_degree_bound(coord, jp, masses=m, dtype=jnp.float64,
                                   block=32)
    assert abs(float(got) - float(ref)) <= 1e-12 * abs(float(ref))
    if masses:
        return
    for name in ("hessian_diag_blocks", "kirchhoff_degree"):
        got = getattr(tmf, name)(coord, tp, dtype=torch.float64,
                                 device="cpu", block=32)
        ref = getattr(jmf, name)(coord, jp, dtype=jnp.float64, block=32)
        assert _rel(got, ref) < 1e-12, name


#: family, GNM, block-sparse route
MODE_CASES = [("table", False, False), ("table", False, True),
              ("table", True, True), ("table-overlay", False, False),
              ("table-overlay", False, True), ("table-overlay", True, True),
              ("invariant-overlay", False, True),
              ("invariant-overlay", True, False)]


@pytest.mark.parametrize("family,gnm,sparse", MODE_CASES)
def test_tabulated_and_patched_lowest_modes_match_jax(family, gnm, sparse):
    """n = 120 under the three-bin table (and with overlays), k = 4,
    degree 40, 12 outer iterations; the block-sparse route in Morton order
    on both sides (codes, masks and bonded pairs permuted as
    ``_sparse_setup`` does), results back in atom order."""
    n = 120
    coord = random_coord(13, n, box=26.0)
    jp, tp = _families(n)[family]
    opts = dict(degree=40, n_outer=12, tile=16, block=64, oversample=8,
                sparse=sparse)
    name = "lowest_modes_matfree" + ("_gnm" if gnm else "")
    ref_vals, ref_vecs, _ = getattr(jmf, name)(
        coord, jp, 4, use_pallas=sparse, dtype=jnp.float64, **opts)
    vals, vecs, res = getattr(tmf, name)(coord, tp, 4, dtype=torch.float64,
                                         device="cpu", **opts)
    np.testing.assert_allclose(vals.numpy(), np.asarray(ref_vals),
                               rtol=1e-8)
    overlap = np.linalg.norm(vecs.numpy() @ np.asarray(ref_vecs).T, ord=-2)
    assert overlap > 1 - 1e-8


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("entry", ["covariance_solve_matfree",
                                   "covariance_solve_matfree_gnm",
                                   "dcc_rows_matfree"])
@pytest.mark.parametrize("family", ["table", "table-overlay"])
def test_tabulated_and_patched_cg_solvers_match_jax(family, entry, sparse):
    n = 120
    coord = random_coord(13, n, box=30.0)
    jp, tp = _families(n)[family]
    (x, n_it, res), (jx, jn_it, _) = _cg_case(entry, coord, jp, tp, sparse)
    assert _rel(x, jx) < 1e-8
    assert abs(n_it - int(jn_it)) <= 1
    assert float(res.max()) < 1e-9


def test_sparse_setup_permutes_a_copy_of_the_parameters():
    """The Morton-ordered parameters are a new record with device tensors
    of its own: the caller's codes and masks stay in atom order."""
    n = 90
    coord = random_coord(3, n, box=30.0)
    _, tp = _families(n)["table-overlay"]
    code = tp.device_tables("cpu", torch.float64)["code"].clone()
    masks = tp.device_overlays("cpu", torch.float64)["off_any"].clone()
    c = torch.as_tensor(coord)
    _, sorted_params, _, csr, perm, pairs = tmf._sparse_setup(c, tp, None,
                                                              16, False)
    assert pairs is None                # no kernel route, no pair CSR
    assert np.array_equal(sorted_params.type_idx, tp.type_idx[perm])
    assert torch.equal(tp.device_tables("cpu", torch.float64)["code"], code)
    assert torch.equal(
        sorted_params.device_tables("cpu", torch.float64)["code"],
        code[torch.as_tensor(perm)])
    assert torch.equal(tp.device_overlays("cpu", torch.float64)["off_any"],
                       masks)
    assert np.array_equal(csr.ids.numpy(), perm)
