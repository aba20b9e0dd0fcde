"""
PyTorch port, the matrix-free slice (``springcraft_tpu_torch.ops.matfree``)
against ``springcraft_tpu.ops.matfree`` on the same numpy inputs, on the
CPU: the row-blocked operators, the plain routes of the three kernel
wrappers (K12, K13, K14) against the Pallas kernels in interpret mode,
the host set-up, the degree and diagonal passes, Chebyshev modes on the
plain and the block-sparse route, the deflated CG solvers, and the
refusals.  The same for a tabulated family and for patch overlays is in
``tests/test_torch_matfree_tables.py`` (a file of its own, so that the
two run on different workers).

Tolerances: the operators 1e-10 (float64) and 5e-6 of max|y| (float32,
``tests/test_matfree.py:99-101``); the host set-up exactly; the degree
and diagonal passes 1e-12; eigenvalues 1e-8 relative and subspace
overlap above 1 - 1e-8; CG solutions 1e-8 of max|x| (float64).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from springcraft_tpu.ops import ffparams as jff  # noqa: E402
from springcraft_tpu.ops import matfree as jmf  # noqa: E402
import springcraft_tpu_torch as sct  # noqa: E402
from springcraft_tpu_torch.ops import matfree as tmf  # noqa: E402

from .util import random_coord  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the solvers' many small ops slow down a
    hundredfold under pytest-xdist with every worker's OpenMP pool
    spinning."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_JDTYPE = {torch.float64: jnp.float64, torch.float32: jnp.float32}


def _params(kind, cutoff):
    """The same analytic field in both packages."""
    jp = getattr(jff, f"{kind}_params")(cutoff)
    return jp, sct.from_numpy_params({"kind": jp.kind, "n_bins": jp.n_bins,
                                      "cutoff_sq": jp.cutoff_sq})


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    return float(np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) or 1.0))


# ---------------------------------------------------------------------------
# Operators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["hessian_apply", "kirchhoff_apply"])
@pytest.mark.parametrize("kind,cutoff", [("invariant", 13.0),
                                         ("hinsen", 14.0), ("pfenm", None)])
def test_row_blocked_operators_match_jax(op, kind, cutoff):
    coord = random_coord(3, 90, box=40.0)
    jp, tp = _params(kind, cutoff)
    rows = 3 * 90 if op == "hessian_apply" else 90
    x = np.random.RandomState(0).randn(rows, 5)
    ref = getattr(jmf, op)(coord, x, jp, block=32, dtype=jnp.float64)
    got = getattr(tmf, op)(coord, x, tp, block=32, dtype=torch.float64,
                           device="cpu")
    assert got.shape == (rows, 5) and got.device.type == "cpu"
    assert _rel(got, ref) < 1e-10
    # a vector keeps its shape
    vec = getattr(tmf, op)(coord, x[:, 0], tp, block=32,
                           dtype=torch.float64, device="cpu")
    assert vec.shape == (rows,) and _rel(vec, np.asarray(ref)[:, 0]) < 1e-10


def _sorted_layout(n=90, tile=16, cutoff=9.0, seed=41):
    """Morton-sorted coordinates with original ids and tile neighbour
    lists; n = 90 leaves a padded last tile of 10 atoms at tile 16."""
    coord = random_coord(seed, n, box=30.0)
    perm = jmf.spatial_sort_permutation(coord)
    sorted_c = coord[perm]
    nbr, counts = jmf.tile_neighbor_lists(sorted_c, cutoff, tile)
    return sorted_c, perm.astype(np.int32), nbr, counts


#: wrapper -> (JAX function, family, node (GNM) layout)
WRAPPERS = {
    "hessian_apply_dense": ("hessian_apply_pallas", ("pfenm", None), False),
    "hessian_apply_sparse": ("hessian_apply_pallas_sparse",
                             ("invariant", 9.0), False),
    "kirchhoff_apply_sparse": ("kirchhoff_apply_pallas_sparse",
                               ("hinsen", 9.0), True),
}


@pytest.mark.parametrize("k", [1, 5, 24, 50, 96])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
def test_kernel_plain_routes_match_pallas(wrapper, dtype, k):
    """Each kernel wrapper's CPU route (its plain version: the CSR walk,
    id masking, padded last tile) against the Pallas kernel in interpret
    mode; k = 1 as a vector, 24, 50 and 96 the widths of the kernels'
    other column layouts."""
    jname, (kind, cutoff), node = WRAPPERS[wrapper]
    jp, tp = _params(kind, cutoff)
    coord, ids, nbr, counts = _sorted_layout()
    n = coord.shape[0]
    x = np.random.RandomState(9).randn(n if node else 3 * n, k)
    if k == 1:
        x = x[:, 0]
    if wrapper == "hessian_apply_dense":
        jargs, targs = (), ()
    else:
        jargs, targs = (nbr, counts, ids), (nbr, counts, ids)
    ref = getattr(jmf, jname)(coord, x, jp, *jargs, tile=16,
                              dtype=_JDTYPE[dtype])
    fn = getattr(tmf, wrapper)
    before = fn.launches
    got = fn(coord, x, tp, *targs, tile=16, dtype=dtype, device="cpu")
    assert fn.launches == before                    # no kernel on the CPU
    assert got.dtype == dtype and got.shape == np.shape(ref)
    assert _rel(got, ref) < (1e-10 if dtype == torch.float64 else 5e-6)


@pytest.mark.parametrize("cols", ["dense", "gather"])
def test_kernel_shape_limits_name_the_column_chunks(cols):
    """The matrix-free kernels take X in at most 65535 column chunks of
    64 (K12's blocks, K13/K14's warps) and 3n < 2^31; the message names
    both limits.  Only shapes are read: the tensors are views of one
    float."""
    per = tmf._DENSE_COLS if cols == "dense" else tmf._GATHER_COLS
    assert per == 64
    widest = tmf._MAX_GRID_Y * per
    one = torch.zeros(1)
    coord = one.expand(10, 3)
    tmf._check_kernel_shape("k12", coord, one.expand(30, widest), per)
    with pytest.raises(ValueError, match=r"k <= 4194240: 65535 column "
                       r"chunks of at most 64; 3n < 2\^31"):
        tmf._check_kernel_shape("k12", coord, one.expand(30, widest + 1),
                                per)
    with pytest.raises(ValueError, match=r"\(n, k\) = \(715827883, 4\)"):
        tmf._check_kernel_shape("k12", one.expand(715827883, 3),
                                one.expand(3, 4), per)


def test_wrapper_limits_mirror_the_kernel_sources():
    """The wrappers' column widths and panel limit are the ones the CUDA
    sources instantiate."""
    import pathlib
    import re

    from springcraft_tpu_torch.ops import spd_linalg

    csrc = pathlib.Path(tmf.__file__).resolve().parent.parent / "csrc"

    def constant(source, name):
        text = (csrc / source).read_text()
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    assert tmf._DENSE_COLS == constant("matfree_hessian.cu", "kMaxCols")
    assert tmf._GATHER_COLS == constant("pair_gather.cuh", "kGatherCols")
    assert spd_linalg.MAX_LEAF == constant("panel_inverse.cu", "kMaxPanel")
    narrow = constant("panel_inverse.cu", "kFullNarrowPanel")
    # every panel the wrapper passes fits one block of the full-window
    # kernel: pb^2 / (2 rows) threads of at most 1024, a whole number of
    # thread rows (4 rows a thread up to `narrow`, 8 above)
    for pb in range(8, spd_linalg.MAX_LEAF + 1, 8):
        rows = 4 if pb <= narrow else 8
        assert pb * pb // (2 * rows) <= 1024 and pb % rows == 0


def test_dense_plain_equals_the_row_blocked_operator():
    coord, _, _, _ = _sorted_layout()
    _, tp = _params("invariant", 9.0)
    x = torch.as_tensor(np.random.RandomState(2).randn(270, 3))
    c = torch.as_tensor(coord)
    ref = tmf.hessian_apply(c, x, tp, block=32, dtype=torch.float64)
    got = tmf.hessian_apply_dense_plain(c, x, tp, tile=16)
    assert _rel(got, ref) < 1e-10


@pytest.mark.parametrize("n,tile,cutoff", [(90, 16, 9.0), (333, 32, 11.0),
                                           (200, 256, 13.0)])
def test_host_setup_matches_jax(n, tile, cutoff):
    coord = random_coord(31, n, box=50.0)
    perm = tmf.spatial_sort_permutation(coord)
    np.testing.assert_array_equal(perm, jmf.spatial_sort_permutation(coord))
    sorted_c = coord[perm]
    nbr, counts = tmf.tile_neighbor_lists(sorted_c, cutoff, tile)
    jnbr, jcounts = jmf.tile_neighbor_lists(sorted_c, cutoff, tile)
    np.testing.assert_array_equal(nbr, jnbr)
    np.testing.assert_array_equal(counts, jcounts)
    csr = tmf.tile_csr(nbr, counts, perm, n, tile, "cpu")
    rows, cols = jmf._flatten_pairs(jnbr, jcounts, nbr.shape[0])
    np.testing.assert_array_equal(csr.cols.numpy(), cols)
    np.testing.assert_array_equal(
        np.repeat(np.arange(nbr.shape[0]), np.diff(csr.row_ptr.numpy())),
        rows)
    np.testing.assert_array_equal(csr.ids.numpy(), perm)
    assert csr.row_ptr.dtype == csr.cols.dtype == torch.int32


@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("kind,cutoff", [("invariant", 12.0),
                                         ("hinsen", 14.0), ("pfenm", None)])
def test_degree_and_diagonal_passes_match_jax(kind, cutoff, masses):
    coord = random_coord(17, 100, box=28.0)
    jp, tp = _params(kind, cutoff)
    m = (50.0 + 100.0 * np.random.RandomState(5).rand(100)) if masses \
        else None
    opts = dict(block=32)
    got = tmf.hessian_degree_bound(coord, tp, masses=m, dtype=torch.float64,
                                   device="cpu", **opts)
    ref = jmf.hessian_degree_bound(coord, jp, masses=m, dtype=jnp.float64,
                                   **opts)
    assert abs(float(got) - float(ref)) <= 1e-12 * abs(float(ref))
    if masses:
        return
    for name in ("hessian_diag_blocks", "kirchhoff_degree"):
        got = getattr(tmf, name)(coord, tp, dtype=torch.float64,
                                 device="cpu", **opts)
        ref = getattr(jmf, name)(coord, jp, dtype=jnp.float64, **opts)
        assert got.shape == np.shape(ref)
        assert _rel(got, ref) < 1e-12, name


# ---------------------------------------------------------------------------
# Chebyshev modes
# ---------------------------------------------------------------------------

#: case -> (GNM, sparse, masses)
MODE_CASES = {
    "anm-plain": (False, False, False),
    "anm-sparse": (False, True, False),
    "anm-plain-masses": (False, False, True),
    "anm-sparse-masses": (False, True, True),
    "gnm-plain": (True, False, False),
    "gnm-sparse": (True, True, False),
}


@pytest.mark.parametrize("case", sorted(MODE_CASES))
def test_lowest_modes_match_jax(case):
    """n = 120, k = 4, degree 40, 12 outer iterations
    (``tests/test_matfree.py:170-232``); the block-sparse route forced on
    the CPU (the port's plain CSR walk, the JAX package's Pallas kernel
    in interpret mode) with the same oversampling on both sides."""
    gnm, sparse, masses = MODE_CASES[case]
    coord = random_coord(13, 120, box=30.0)
    jp, tp = _params("invariant", 12.0)
    m = (50.0 + 100.0 * np.random.RandomState(5).rand(120)) if masses \
        else None
    opts = dict(masses=m, degree=40, n_outer=12, tile=16, block=64,
                oversample=8, sparse=sparse)
    name = "lowest_modes_matfree" + ("_gnm" if gnm else "")
    ref_vals, ref_vecs, ref_res = getattr(jmf, name)(
        coord, jp, 4, use_pallas=sparse, dtype=jnp.float64, **opts)
    vals, vecs, res = getattr(tmf, name)(coord, tp, 4, dtype=torch.float64,
                                         device="cpu", **opts)
    assert vals.shape == (4,) and vecs.shape == (4, 120 if gnm else 360)
    np.testing.assert_allclose(vals.numpy(), np.asarray(ref_vals),
                               rtol=1e-8)
    assert float(res.max()) < 1e-6
    overlap = np.linalg.norm(vecs.numpy() @ np.asarray(ref_vecs).T, ord=-2)
    assert overlap > 1 - 1e-8


# ---------------------------------------------------------------------------
# Deflated CG
# ---------------------------------------------------------------------------

def _cg_case(entry, coord, jp, tp, sparse):
    n = coord.shape[0]
    rng = np.random.RandomState(8)
    m = 50.0 + 100.0 * rng.rand(n)
    sites = [3, 40, 77]
    if entry == "covariance_solve_matfree":
        args, opts = (rng.randn(3 * n, 3),), dict(masses=m)
    elif entry == "covariance_solve_matfree_gnm":
        args, opts = (rng.randn(n, 3),), dict(masses=m)
    elif entry == "linear_response_matfree":
        args, opts = (rng.randn(n, 3, 2),), {}
    elif entry == "prs_rows_matfree":
        args, opts = (sites,), {}
    else:
        args, opts = (sites,), dict(norm=False)
    ref = getattr(jmf, entry)(coord, jp, *args, tol=1e-10, block=64,
                              tile=16, use_pallas=sparse, sparse=sparse,
                              dtype=jnp.float64, **opts)
    got = getattr(tmf, entry)(coord, tp, *args, tol=1e-10, block=64,
                              tile=16, sparse=sparse, dtype=torch.float64,
                              device="cpu", **opts)
    return got, ref


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("entry", [
    "covariance_solve_matfree", "covariance_solve_matfree_gnm",
    "linear_response_matfree", "prs_rows_matfree", "dcc_rows_matfree",
    "dcc_rows_matfree_gnm"])
def test_cg_solvers_match_jax(entry, sparse):
    coord = random_coord(13, 120, box=30.0)
    jp, tp = _params("invariant", 12.0)
    (x, n_it, res), (jx, jn_it, jres) = _cg_case(entry, coord, jp, tp,
                                                 sparse)
    assert x.shape == np.shape(jx) and x.device.type == "cpu"
    assert _rel(x, jx) < 1e-8
    assert n_it == int(jn_it)
    assert float(res.max()) < 1e-9
    np.testing.assert_allclose(res.numpy(), np.asarray(jres), rtol=1e-3,
                               atol=1e-14)


def test_dcc_rows_normalized_match_jax():
    coord = random_coord(13, 120, box=30.0)
    jp, tp = _params("invariant", 12.0)
    msf = 1.0 + np.random.RandomState(3).rand(120)
    for entry in ("dcc_rows_matfree", "dcc_rows_matfree_gnm"):
        ref, _, _ = getattr(jmf, entry)(coord, jp, [5, 60], msf=msf,
                                        dtype=jnp.float64, use_pallas=False,
                                        block=64)
        got, _, _ = getattr(tmf, entry)(coord, tp, [5, 60], msf=msf,
                                        dtype=torch.float64, device="cpu",
                                        block=64)
        assert _rel(got, ref) < 1e-8, entry


def test_mode_residuals_match_jax():
    coord = random_coord(17, 100, box=28.0)
    jp, tp = _params("invariant", 12.0)
    rng = np.random.RandomState(4)
    vals, vecs = 1.0 + rng.rand(3), rng.randn(3, 300)
    m = 50.0 + 100.0 * rng.rand(100)
    for masses in (None, m):
        ref = jmf.matfree_mode_residuals(coord, jp, vals, vecs, masses=masses,
                                         block=32, dtype=jnp.float64)
        got = tmf.matfree_mode_residuals(coord, tp, vals, vecs,
                                         masses=masses, block=32,
                                         dtype=torch.float64, device="cpu")
        assert _rel(got, ref) < 1e-12


def test_estimate_lambda_max_matches_jax():
    coord = random_coord(17, 100, box=28.0)
    jp, tp = _params("invariant", 12.0)

    def jop(v):
        return jmf.hessian_apply(coord, v, jp, block=32, dtype=jnp.float64)

    def top(v):
        return tmf.hessian_apply(coord, v, tp, block=32, dtype=torch.float64,
                                 device="cpu")

    ref = jmf.estimate_lambda_max(jop, 300, n_iter=20, dtype=jnp.float64)
    got = sct.estimate_lambda_max(top, 300, n_iter=20, dtype=torch.float64,
                                  device="cpu")
    assert abs(float(got) - float(ref)) <= 1e-10 * float(ref)


# ---------------------------------------------------------------------------
# Refusals and routing
# ---------------------------------------------------------------------------

def _refusals():
    coord = random_coord(3, 30, box=20.0)
    _, tp = _params("invariant", 9.0)
    nbr, counts = tmf.tile_neighbor_lists(coord, 9.0, 16)
    # O(n^2) parameters: the one family the matrix-free path refuses
    table = sct.table_pair_params(np.zeros((30, 30, 1)), None)
    return {
        "tabulated-apply": (ValueError, "matrix-free",
                            lambda: tmf.hessian_apply(
                                coord, np.zeros(90), table, device="cpu")),
        "tabulated-modes": (ValueError, "matrix-free",
                            lambda: sct.lowest_modes_matfree(
                                coord, table, 2, device="cpu")),
        "tabulated-kernel": (ValueError, "matrix-free",
                             lambda: tmf.kirchhoff_apply_sparse(
                                 coord, np.zeros(30), table, nbr, counts,
                                 tile=16, device="cpu")),
        "jax-params": (TypeError, "FFParams",
                       lambda: sct.covariance_solve_matfree(
                           coord, jff.invariant_params(9.0), np.zeros(90),
                           device="cpu")),
        "x-rows": (ValueError, "rows", lambda: tmf.hessian_apply(
            coord, np.zeros((30, 2)), tp, device="cpu")),
        "kirchhoff-rows": (ValueError, "rows",
                           lambda: tmf.kirchhoff_apply_sparse(
                               coord, np.zeros(90), tp, nbr, counts,
                               tile=16, device="cpu")),
        "coord-shape": (ValueError, r"\(n, 3\)", lambda: tmf.hessian_apply(
            coord[:, :2], np.zeros(60), tp, device="cpu")),
        "nbr-tile": (ValueError, "tile_neighbor_lists",
                     lambda: tmf.hessian_apply_sparse(
                         coord, np.zeros(90), tp, nbr, counts, tile=8,
                         device="cpu")),
        "nbr-range": (ValueError, "neighbour tiles",
                      lambda: tmf.hessian_apply_sparse(
                          coord, np.zeros(90), tp, nbr + 5, counts, tile=16,
                          device="cpu")),
        "orig-ids": (ValueError, "orig_ids",
                     lambda: tmf.hessian_apply_sparse(
                         coord, np.zeros(90), tp, nbr, counts,
                         orig_ids=np.arange(29), tile=16, device="cpu")),
        "force-shape": (ValueError, "force",
                        lambda: sct.linear_response_matfree(
                            coord, tp, np.zeros(89), device="cpu")),
        "force-batch": (ValueError, "force",
                        lambda: sct.linear_response_matfree(
                            coord, tp, np.zeros((30, 2)), device="cpu")),
        "rhs-rows": (ValueError, "rows",
                     lambda: sct.covariance_solve_matfree_gnm(
                         coord, tp, np.zeros(90), device="cpu")),
        "sites": (IndexError, "sites", lambda: sct.prs_rows_matfree(
            coord, tp, [0, 30], device="cpu")),
        "dcc-msf": (ValueError, "msf", lambda: sct.dcc_rows_matfree(
            coord, tp, [0], device="cpu")),
        "gnm-dcc-msf": (ValueError, "msf", lambda: sct.dcc_rows_matfree_gnm(
            coord, tp, [0], device="cpu")),
        "n-outer": (ValueError, "n_outer", lambda: sct.lowest_modes_matfree(
            coord, tp, 2, n_outer=0, device="cpu")),
        "tile": (ValueError, "tile", lambda: sct.lowest_modes_matfree_gnm(
            coord, tp, 2, tile=0, device="cpu")),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_refusals(case):
    error, match, call = _refusals()[case]
    with pytest.raises(error, match=match):
        call()


def test_matfree_entry_points_default_to_the_card():
    """A numpy input without `device` goes to the card, and raises
    naming cuda where there is none; the CPU route never launches a
    kernel."""
    coord = random_coord(13, 60, box=22.0)
    _, tp = _params("invariant", 12.0)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        sct.lowest_modes_matfree(coord, tp, 2)
    wrappers = sct.kernel_wrappers()
    before = {name: w.launches for name, w in wrappers.items()}
    for sparse in (False, True):
        sct.lowest_modes_matfree(coord, tp, 2, degree=8, n_outer=1,
                                 sparse=sparse, tile=16, device="cpu")
    assert {name: w.launches for name, w in wrappers.items()} == before
