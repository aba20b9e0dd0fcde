"""
PyTorch port, the two-stage banded eigensolver (``ops/spectrum.py``) and
``ops/modes.py``, held against the JAX package's ``ops/spectrum.py`` and
``ops/modes.py`` and against ``numpy.linalg.eigh`` on the same numpy
inputs (the JAX Pallas kernels in interpret mode on the CPU).

Tolerances: float64 band diagonals agree with the JAX package's to 1e-10
(the same Householder transforms, other summation orders); float64
eigensystems meet the JAX package's own bounds against ``numpy`` (1e-9
eigenvalues, residuals 1e-8, orthonormality 1e-9, ``tests/test_ops.py``);
float32 eigenvalues agree to 1e-5 of max|lambda|, and inverse-iteration
vectors are held by their band-space residuals (median 1e-3 of the
band's norm, ``tests/test_ops.py:577-604``) since they are free up to
sign.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from springcraft_tpu.ops import modes as jmodes  # noqa: E402
from springcraft_tpu.ops import spectrum as jspec  # noqa: E402
import springcraft_tpu_torch as sct  # noqa: E402
from springcraft_tpu_torch.ops import assembly, modes, rigid  # noqa: E402
from springcraft_tpu_torch.ops import spectrum  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's thousands of tiny ops: under
    pytest-xdist, every worker's OpenMP pool spinning on all cores slows
    them a hundredfold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _symmetric(b, n, seed, dtype=np.float64):
    a = np.random.RandomState(seed).randn(b, n, n)
    return ((a + a.transpose(0, 2, 1)) / 2).astype(dtype)


def _band(diags):
    """Dense symmetric matrices ``(B, n, n)`` of band diagonals."""
    diags = np.asarray(diags, dtype=np.float64)
    b, w, n = diags.shape
    out = np.zeros((b, n, n))
    for d in range(w):
        idx = np.arange(n - d)
        out[:, idx, idx + d] = diags[:, d, :n - d]
        out[:, idx + d, idx] = diags[:, d, :n - d]
    return out


def _rel(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


@pytest.mark.parametrize("bandwidth", [1, 4, 8])
def test_band_reduce_matches_jax(bandwidth):
    a = _symmetric(1, 90, seed=7)[0]
    ref = np.asarray(jspec.band_reduce(jnp.asarray(a), bandwidth))
    got = spectrum.band_reduce(torch.from_numpy(a), bandwidth)
    assert got.shape == (bandwidth + 1, 90)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-10)
    batched = spectrum.band_reduce(torch.from_numpy(np.stack([a, 2 * a])),
                                   bandwidth)
    np.testing.assert_allclose(batched[1].numpy(), 2 * ref, atol=1e-10)


@pytest.mark.parametrize("bandwidth,bucket,group", [
    (8, "auto", 8), (4, None, 1), (3, 32, 2)])
def test_reflectors_rebuild_the_matrix(bandwidth, bucket, group):
    """``Q band Q^T`` with ``Q = back_transform(I)`` is the input, and the
    diagonals equal :func:`band_reduce`'s."""
    a = _symmetric(2, 70, seed=3)
    t = torch.from_numpy(a)
    diags, v_all, t_all = spectrum.band_reduce_with_reflectors(
        t, bandwidth, bucket=bucket, group=group)
    np.testing.assert_allclose(
        diags.numpy(),
        spectrum.band_reduce(t, bandwidth, bucket=bucket,
                             group=group).numpy(), atol=1e-12)
    q = spectrum.back_transform(v_all, t_all,
                                torch.eye(70, dtype=t.dtype).expand(2, 70,
                                                                    70))
    rebuilt = q @ torch.from_numpy(_band(diags)) @ q.transpose(1, 2)
    np.testing.assert_allclose(rebuilt.numpy(), a, atol=1e-12)
    np.testing.assert_allclose((q.transpose(1, 2) @ q).numpy(),
                               np.broadcast_to(np.eye(70), (2, 70, 70)),
                               atol=1e-12)


def test_banded_eigenvalues_match_jax_and_pallas():
    """The routed bisection and the kernel wrapper on the CPU (both the
    plain version there) against the JAX package's XLA and Pallas
    (interpret) bisections: (2, 5, 60) float32 bands."""
    a = _symmetric(2, 60, seed=5, dtype=np.float32)
    diags = np.asarray(jax.vmap(lambda m: jspec.band_reduce(m, 4))(
        jnp.asarray(a)))
    ref = np.asarray(jspec.banded_eigenvalues(jnp.asarray(diags)))
    ref_pallas = np.asarray(jspec.banded_eigenvalues_pallas(
        jnp.asarray(diags), interpret=True))
    exact = np.linalg.eigvalsh(_band(diags))
    d = torch.from_numpy(diags)
    before = spectrum.banded_bisect.launches
    got = spectrum.banded_eigenvalues(d)
    wrapped = spectrum.banded_bisect(*spectrum.bisect_inputs(d), 40)
    assert spectrum.banded_bisect.launches == before      # plain on the CPU
    assert got.dtype == torch.float32 and got.shape == (2, 60)
    torch.testing.assert_close(wrapped, got, rtol=0, atol=0)
    for r in (ref, ref_pallas, exact):
        assert _rel(got, r) <= 1e-5
    one = spectrum.banded_eigenvalues(d[1])
    torch.testing.assert_close(one, got[1], rtol=0, atol=0)


def test_bisection_counts_in_float64():
    """Float32 ANM Hessian bands: the float64 Sturm count keeps every
    eigenvalue within 1e-6 of max|lambda| of float64 eigh (a float32
    count flips pivot signs under the unpivoted elimination's growth)."""
    rng = np.random.RandomState(3)
    base = rng.rand(100, 3) * 34.0 / 3 ** (1 / 3)
    coords = torch.from_numpy(base[None] + 0.05 * rng.randn(2, 100, 3))
    h = assembly.hessian_xyz_plain(coords, sct.invariant_params(13.0))
    got = spectrum.eigvalsh_banded(h.float(), n_iter=40)
    assert _rel(got, torch.linalg.eigvalsh(h)) <= 1e-6


def test_banded_eigenvectors_match_jax_and_pallas():
    """Inverse-iteration vectors of (2, 5, 150) float32 bands from the
    port and from the JAX package's XLA and Pallas (interpret) routes,
    each held by its band-space residuals."""
    a = _symmetric(2, 150, seed=13, dtype=np.float32)
    diags = jax.vmap(lambda m: jspec.band_reduce(m, 4))(jnp.asarray(a))
    vals = jspec.banded_eigenvalues(diags, n_iter=40)
    band = _band(diags)
    d, v = torch.from_numpy(np.asarray(diags)), torch.from_numpy(
        np.asarray(vals))
    results = {"port": spectrum.banded_eigenvectors(d, v).numpy()}
    for use_pallas in (False, True):
        results[f"jax pallas={use_pallas}"] = np.asarray(
            jspec.banded_eigenvectors(diags, vals, use_pallas=use_pallas))
    norm = np.abs(np.asarray(vals)).max(axis=1)[:, None]
    for label, u in results.items():
        res = np.linalg.norm(band @ u - u * np.asarray(vals)[:, None, :],
                             axis=1) / norm
        assert np.median(res) < 1e-3, label
    gram = results["port"].transpose(0, 2, 1) @ results["port"]
    assert np.abs(gram - np.eye(150)).max() < 1e-3


def test_banded_eigvec_plain_is_its_wrapper_on_the_cpu():
    diags = spectrum.band_reduce(torch.from_numpy(
        _symmetric(2, 40, seed=2, dtype=np.float32)), 8)
    vals = spectrum.banded_eigenvalues(diags)
    feed, shifts, floor, _ = spectrum.eigvec_inputs(diags, vals)
    before = spectrum.banded_eigvec.launches
    got = spectrum.banded_eigvec(feed, shifts[:, 8:24].contiguous(), 8,
                                 floor, 2, 1.0)
    assert spectrum.banded_eigvec.launches == before
    ref = spectrum.banded_eigvec_plain(feed, shifts[:, 8:24].contiguous(),
                                       8, floor, 2, 1.0)
    assert got.shape == (2, 40, 16)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    torch.testing.assert_close(torch.linalg.vector_norm(got, dim=1),
                               torch.ones(2, 16), rtol=0, atol=1e-6)


def test_separate_shifts_match_jax():
    vals = np.sort(np.random.RandomState(1).rand(3, 20), axis=1)
    vals[:, 5:9] = vals[:, 5:6]                     # a degenerate cluster
    sep = np.array([[1e-3], [1e-2], [0.0]])
    ref = np.asarray(jspec._separate_shifts(jnp.asarray(vals),
                                            jnp.asarray(sep)))
    got = spectrum._separate_shifts(torch.from_numpy(vals),
                                    torch.from_numpy(sep))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-15)
    assert (np.diff(got.numpy()[:2], axis=1) > 0).all()


def test_start_vectors_span_a_cluster():
    """Six consecutive shifts (a rigid-body cluster) get independent
    start vectors; the JAX package's family spans only three dimensions."""
    n = 300
    idx = torch.arange(6, 12, dtype=torch.float64)
    starts = spectrum._start_vector(n, idx, 1.0, torch.float64, "cpu")
    s = torch.linalg.svdvals(starts)
    assert float(s[-1] / s[0]) > 1e-3
    i = torch.arange(n, dtype=torch.float64)[:, None]
    jax_family = torch.cos(0.7 * i + 1.0 + 2.347 * idx) + 1e-3
    s = torch.linalg.svdvals(jax_family)
    assert float(s[3] / s[0]) < 1e-12


def _eigh_checks(a, vals, vecs, atol_res, atol_orth):
    vals, vecs = vals.numpy(), vecs.numpy()
    assert np.all(np.diff(vals) >= -atol_res)
    res = np.linalg.norm(a @ vecs.T - vecs.T * vals[None, :], axis=0)
    assert res.max() < atol_res, res.max()
    assert np.abs(vecs @ vecs.T - np.eye(a.shape[-1])).max() < atol_orth


@pytest.mark.parametrize("bandwidth", [1, 4, 8])
def test_eigh_banded_matches_eigh(bandwidth):
    a = _symmetric(1, 90, seed=7)[0]
    t = torch.from_numpy(a)
    np.testing.assert_allclose(
        spectrum.eigvalsh_banded(t, bandwidth=bandwidth).numpy(),
        np.linalg.eigvalsh(a), atol=1e-9)
    vals, vecs = spectrum.eigh_banded(t, bandwidth=bandwidth)
    np.testing.assert_allclose(vals.numpy(), np.linalg.eigvalsh(a),
                               atol=1e-9)
    _eigh_checks(a, vals, vecs, 1e-8, 1e-9)


def test_eigh_banded_degenerate_clusters():
    rng = np.random.RandomState(9)
    q, _ = np.linalg.qr(rng.randn(80, 80))
    lam = np.sort(np.concatenate(
        [np.full(10, 2.0), np.full(5, 2.0 + 1e-9), rng.rand(65) * 10]))
    a = (q * lam) @ q.T
    a = (a + a.T) / 2
    vals, vecs = spectrum.eigh_banded(torch.from_numpy(a), bandwidth=4,
                                      window=16)
    np.testing.assert_allclose(vals.numpy(), lam, atol=1e-9)
    _eigh_checks(a, vals, vecs, 1e-7, 1e-7)


def test_eigh_banded_anm_hessian_zero_cluster():
    coord = np.random.RandomState(13).rand(50, 3) * 22.0
    h = assembly.hessian_xyz_plain(torch.from_numpy(coord)[None],
                                   sct.invariant_params(12.0))[0]
    vals, vecs = spectrum.eigh_banded(h, bandwidth=4)
    np.testing.assert_allclose(vals.numpy(), np.linalg.eigvalsh(h.numpy()),
                               atol=1e-9)
    _eigh_checks(h.numpy(), vals, vecs, 1e-8, 1e-9)


def test_eigh_banded_float32_batched_and_small():
    a = _symmetric(3, 96, seed=11, dtype=np.float32)
    vals, vecs = spectrum.eigh_banded(torch.from_numpy(a), bandwidth=4)
    assert vals.shape == (3, 96) and vecs.dtype == torch.float32
    for i in range(3):
        scale = np.linalg.norm(a[i], 2)
        res = np.linalg.norm(a[i] @ vecs[i].numpy().T
                             - vecs[i].numpy().T * vals[i].numpy()[None],
                             axis=0)
        assert res.max() / scale < 5e-4
        gram = vecs[i].numpy() @ vecs[i].numpy().T
        assert np.abs(gram - np.eye(96)).max() < 1e-3
    # n <= bandwidth + 1: a dense eigh
    small = torch.from_numpy(_symmetric(1, 6, seed=1)[0])
    vals, vecs = spectrum.eigh_banded(small, bandwidth=8)
    _eigh_checks(small.numpy(), vals, vecs, 1e-12, 1e-12)
    np.testing.assert_allclose(
        spectrum.eigvalsh_banded(small, bandwidth=8).numpy(),
        np.linalg.eigvalsh(small.numpy()), atol=1e-12)


@pytest.mark.parametrize("model", ["anm", "gnm"])
def test_modes_from_covariance_match_jax(model):
    """Both packages converge to the same modes.  Their start block,
    ``cos(0.7 (i p + j) + seed) + 1e-3``, has rank three, so QR rounding
    fills the rest of the subspace and partly converged iterates differ
    between implementations: compare after 64 iterations."""
    rng = np.random.RandomState(4)
    base = rng.rand(30, 3) * 12.0
    coords = torch.from_numpy(base[None] + 0.05 * rng.randn(2, 30, 3))
    params = sct.invariant_params(9.0)
    if model == "anm":
        mats = assembly.hessian_xyz_plain(coords, params)
        basis = rigid.rigid_modes_anm(coords)
    else:
        mats = assembly.kirchhoff_plain(coords, params)
        basis = rigid.null_mode_gnm(30, dtype=torch.float64, device="cpu")
    cov = rigid.covariance_cholesky(mats, basis)
    vals, vecs = modes.modes_from_covariance(cov, mats, basis, k=4,
                                             n_iter=64)
    assert vals.shape == (2, 4) and vecs.shape == (2, 4, mats.shape[-1])
    exact = torch.linalg.eigvalsh(mats)
    n_null = basis.shape[-1]
    np.testing.assert_allclose(vals.numpy(),
                               exact[:, n_null:n_null + 4].numpy(),
                               rtol=1e-10)
    for i in range(2):
        t = basis if model == "gnm" else basis[i]
        ref_vals, ref_vecs = jmodes.modes_from_covariance(
            jnp.asarray(cov[i].numpy()), jnp.asarray(mats[i].numpy()),
            jnp.asarray(t.numpy()), k=4, n_iter=64)
        np.testing.assert_allclose(vals[i].numpy(), np.asarray(ref_vals),
                                   rtol=1e-10)
        # the same subspace: equal projectors
        proj = vecs[i].T @ vecs[i]
        ref = np.asarray(ref_vecs).T @ np.asarray(ref_vecs)
        np.testing.assert_allclose(proj.numpy(), ref, atol=1e-8)


def test_rescue_solves_non_finite_columns_again():
    """From n >= 2048 a non-finite inverse-iteration column is solved again
    with its shift moved by 5 sep; one still non-finite becomes its
    normalized start vector."""
    x = torch.ones(1, 6, 3, dtype=torch.float64)
    x[0, 2, 1] = float("nan")
    x[0, :, 2] = float("inf")
    shifts = torch.tensor([[1.0, 2.0, 3.0]], dtype=torch.float64)
    sep = torch.tensor([[0.5]], dtype=torch.float64)
    moved = []

    def solve(feed, sh, idx0, floor, n_solves, seed):
        moved.append(sh)
        out = torch.full_like(x, 2.0)
        out[0, 0, 2] = float("nan")
        return out

    got = spectrum._rescue(solve, x, None, shifts, 4, None, 2, 1.0, sep)
    torch.testing.assert_close(moved[0], shifts + 2.5)
    torch.testing.assert_close(got[..., 0], x[..., 0])
    torch.testing.assert_close(got[..., 1], torch.full((1, 6), 2.0,
                                                      dtype=torch.float64))
    start = spectrum._start_vector(6, torch.tensor([6.0], dtype=torch.float64),
                                   1.0, torch.float64, "cpu")[:, 0]
    torch.testing.assert_close(got[0, :, 2], start / start.norm())


# ---------------------------------------------------------------------------
# Invariants the bisection and inverse-iteration kernels rely on, on the
# plain versions
# ---------------------------------------------------------------------------


def _small_bands(b, n, w, seed):
    """Float32 band diagonals ``(b, w, n)`` of random symmetric matrices."""
    return spectrum.band_reduce(torch.from_numpy(
        _symmetric(b, n, seed=seed, dtype=np.float32)), w - 1)


def _sturm_counts(feed64, mids):
    """Negative pivots of ``B - mid I`` for float32 `mids` ``(B, S)``, the
    count of :func:`spectrum.banded_bisect_plain`."""
    w = feed64.shape[1]
    n = feed64.shape[-1] - w
    win = spectrum._Window(feed64, mids.double())
    counts = torch.zeros(mids.shape, dtype=torch.int32)
    for i in range(n):
        pivot = win.pivot()
        counts += pivot < 0
        win.eliminate(1.0 / spectrum._clamp_pivot(pivot, spectrum._TINY),
                      i + w)
    return counts


def _halve(feed64, lo, hi, targets):
    """One halving of every eigenvalue's float32 interval, as
    :func:`spectrum.banded_bisect_plain` takes it."""
    mid = 0.5 * (lo + hi)
    go_up = _sturm_counts(feed64, mid) <= targets
    return torch.where(go_up, mid, lo), torch.where(go_up, hi, mid)


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_bisection_halvings_repeat_once_the_interval_stops_moving():
    """(i) Halvings one at a time on (2, 9, 60) float32 bands to 56: once a
    halving leaves an eigenvalue's (lo, hi) unchanged, every later one
    does, so ``banded_bisect_plain`` returns the same bits at 40 and 56
    halvings for it (the kernel's exact early stop)."""
    diags = _small_bands(2, 60, 9, seed=21)
    feed, lo0, hi0 = spectrum.bisect_inputs(diags)
    feed64 = feed.double()
    n = diags.shape[-1]
    targets = torch.arange(n)
    lo, hi = lo0[:, None].expand(2, n), hi0[:, None].expand(2, n)
    fixed = torch.zeros((2, n), dtype=torch.bool)
    fixed_at_40 = None
    for it in range(56):
        new_lo, new_hi = _halve(feed64, lo, hi, targets)
        same = (_bits(new_lo) == _bits(lo)) & (_bits(new_hi) == _bits(hi))
        assert bool(same[fixed].all()), f"halving {it} moved a fixed pair"
        fixed |= same
        lo, hi = new_lo, new_hi
        if it + 1 == 40:
            fixed_at_40 = fixed.clone()
    assert float(fixed_at_40.float().mean()) > 0.5
    at_40 = spectrum.banded_bisect_plain(feed, lo0, hi0, 40)
    at_56 = spectrum.banded_bisect_plain(feed, lo0, hi0, 56)
    assert torch.equal(_bits(at_56), _bits(0.5 * (lo + hi)))
    assert torch.equal(_bits(at_40)[fixed_at_40], _bits(at_56)[fixed_at_40])


def _node_mid(lo, hi, node):
    """The kernel's mid of heap node `node` of the tree of the next
    halvings of float32 ``[lo, hi]``: the digits of ``node + 1`` after its
    leading one are the path, 1 above a mid."""
    path = node + 1
    for bit in reversed(range(path.bit_length() - 1)):
        mid = 0.5 * (lo + hi)
        if (path >> bit) & 1:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _multisect(feed64, lo, hi, targets, n_iter, levels):
    """The kernel's multisection: each round counts at the mids of all
    ``2**levels - 1`` nodes at once, then walks the tree with the counts;
    returns the float32 pairs after each round and the mids each round's
    walk passed through."""
    rounds, passed = [], []
    for it in range(0, n_iter, levels):
        depth = min(levels, n_iter - it)
        nodes = 2 ** levels - 1
        mids = [_node_mid(lo, hi, m) for m in range(nodes)]
        counts = _sturm_counts(feed64, torch.stack(mids, -1).flatten(-2))
        counts = counts.view(lo.shape + (nodes,))
        m = torch.zeros(lo.shape, dtype=torch.long)
        a, c = lo, hi
        walk = []
        for _ in range(depth):
            mid = 0.5 * (a + c)
            assert torch.equal(_bits(mid), _bits(torch.gather(
                torch.stack(mids, -1), -1, m[..., None])[..., 0]))
            up = torch.gather(counts, -1, m[..., None])[..., 0] <= targets
            a = torch.where(up, mid, a)
            c = torch.where(up, c, mid)
            m = torch.where(up, 2 * m + 2, 2 * m + 1)
            walk.append(mid)
        lo, hi = a, c
        rounds.append((lo, hi))
        passed.append(walk)
    return rounds, passed


@pytest.mark.parametrize("levels,n_iter", [(2, 12), (3, 12), (3, 13)])
def test_multisection_takes_the_sequential_halvings(levels, n_iter):
    """(ii) The mids of two and three halvings taken at once (the kernel's
    node mids) are the sequential mids bit for bit, and so are the
    intervals after each round and the result, also where `n_iter` is not
    a multiple of the depth."""
    diags = _small_bands(2, 40, 9, seed=22)
    feed, lo0, hi0 = spectrum.bisect_inputs(diags)
    feed64 = feed.double()
    n = diags.shape[-1]
    targets = torch.arange(n)
    lo, hi = lo0[:, None].expand(2, n), hi0[:, None].expand(2, n)
    rounds, passed = _multisect(feed64, lo, hi, targets, n_iter, levels)
    seq_lo, seq_hi = lo, hi
    for (r_lo, r_hi), walk in zip(rounds, passed):
        for mid in walk:
            assert torch.equal(_bits(mid), _bits(0.5 * (seq_lo + seq_hi)))
            seq_lo, seq_hi = _halve(feed64, seq_lo, seq_hi, targets)
        assert torch.equal(_bits(r_lo), _bits(seq_lo))
        assert torch.equal(_bits(r_hi), _bits(seq_hi))
    final = 0.5 * (rounds[-1][0] + rounds[-1][1])
    ref = spectrum.banded_bisect_plain(feed, lo0, hi0, n_iter)
    assert torch.equal(_bits(final), _bits(ref))


def test_shared_tree_walk_takes_the_first_halvings():
    """The kernel's shared tree: Sturm counts at the nodes of the first
    floor(log2 n) levels of the halving tree of each matrix's [lo, hi],
    taken once a matrix and walked by every eigenvalue, give its first
    halvings bit for bit."""
    n = 40
    diags = _small_bands(2, n, 9, seed=23)
    feed, lo0, hi0 = spectrum.bisect_inputs(diags)
    feed64 = feed.double()
    targets = torch.arange(n)
    tree = n.bit_length() - 1
    counts = _sturm_counts(feed64, torch.stack(
        [_node_mid(lo0, hi0, m) for m in range(2 ** tree - 1)], -1))
    lo, hi = lo0[:, None].expand(2, n), hi0[:, None].expand(2, n)
    seq_lo, seq_hi = lo, hi
    m = torch.zeros((2, n), dtype=torch.long)
    for _ in range(tree):
        mid = 0.5 * (lo + hi)
        up = torch.gather(counts, 1, m) <= targets
        lo, hi = torch.where(up, mid, lo), torch.where(up, hi, mid)
        m = torch.where(up, 2 * m + 2, 2 * m + 1)
        seq_lo, seq_hi = _halve(feed64, seq_lo, seq_hi, targets)
        assert torch.equal(_bits(lo), _bits(seq_lo))
        assert torch.equal(_bits(hi), _bits(seq_hi))


def test_bisect_levels_fill_the_card():
    """One lane an eigenvalue for batches, multisection for single
    structures, on the H100's 132 SMs."""
    assert spectrum._bisect_levels(128, 900, 132) == 1
    assert spectrum._bisect_levels(128, 300, 132) == 1
    assert spectrum._bisect_levels(1, 5328, 132) == 3
    assert spectrum._bisect_levels(1, 1776, 132) == 3
    assert spectrum._bisect_levels(1, 40, 132) == 3
    assert spectrum._bisect_levels(1, 10560, 132) == 2
    assert spectrum._bisect_levels(1, 33792, 132) == 1


def _checkpointed_eigvec(feed, shifts, idx0, pivot_floor, n_solves, seed,
                         segment):
    """The kernel's inverse iteration: each forward sweep runs the
    factorization alongside it (the first saving the window's eliminated
    entries, all but its last column, every `segment` rows), each backward
    sweep refactors every segment from its saved entries and the band's
    column, last segment first; returns the factors of the last backward
    sweep and the normalized iterate."""
    w = feed.shape[1]
    n = feed.shape[-1] - w
    floor = pivot_floor[:, None]
    idx = torch.arange(idx0, idx0 + shifts.shape[-1], dtype=torch.float64)
    rhs = spectrum._start_vector(n, idx, seed, torch.float64, "cpu")[:, None]
    rhs = rhs.expand((n,) + shifts.shape)
    saved = {}
    d, l = [None] * n, [None] * n
    for _ in range(n_solves):
        win = spectrum._Window(feed, shifts)
        acc = rhs.new_zeros(shifts.shape + (w - 1,))
        z = []
        for i in range(n):
            if i % segment == 0:                   # the first sweep's
                saved.setdefault(i // segment, win.tri[..., :-w].clone())
            safe = spectrum._clamp_pivot(win.pivot(), floor)
            l_i = win.eliminate(1.0 / safe, i + w).contiguous()
            z_i = rhs[i] - acc[..., 0]
            acc = torch.cat([acc[..., 1:], torch.zeros_like(acc[..., :1])],
                            -1)
            acc = acc + l_i * z_i[..., None]
            z.append(z_i)
        xwin = torch.zeros_like(acc)
        sumsq = torch.zeros_like(rhs[0])
        x = [None] * n
        for sg in reversed(range(-(-n // segment))):
            rows = range(sg * segment, min(n, (sg + 1) * segment))
            col = win.feed[:, None, :, sg * segment + w - 1] - win.col_shift
            win.tri = torch.cat([saved[sg], col], -1)
            for i in rows:
                d[i] = spectrum._clamp_pivot(win.pivot(), floor)
                l[i] = win.eliminate(1.0 / d[i], i + w).contiguous()
            for i in reversed(rows):
                x[i] = z[i] / d[i] - (l[i] * xwin).sum(-1)
                xwin = torch.cat([x[i][..., None], xwin[..., :-1]], -1)
                sumsq = sumsq + x[i] * x[i]
        rhs = torch.stack(x) / torch.sqrt(torch.clamp(sumsq, min=1e-30))
    return torch.stack(d), torch.stack(l), rhs.permute(1, 0, 2)


@pytest.mark.parametrize("n,segment", [(45, 8), (48, 8), (45, 7)])
def test_checkpointed_backward_sweep_is_the_plain_solve(n, segment):
    """(iii) Refactoring each segment from a window saved by the forward
    sweep (its last column read again from the band) gives the plain
    factorization's L and D and the plain inverse iteration's vectors bit
    for bit in float64, also where n is not a multiple of the segment."""
    diags = _small_bands(2, n, 9, seed=n + segment).double()
    vals = torch.linalg.eigvalsh(torch.from_numpy(_band(diags.numpy())))
    feed, shifts, floor, _ = spectrum.eigvec_inputs(diags, vals)
    pick = shifts[:, 3:11].contiguous()
    d, l, x = _checkpointed_eigvec(feed, pick, 3, floor, 2, 1.0, segment)
    ref_d, ref_l = spectrum._banded_factorize(feed, pick, floor)
    assert torch.equal(d, ref_d) and torch.equal(l, ref_l)
    ref = spectrum.banded_eigvec_plain(feed, pick, 3, floor, 2, 1.0)
    assert torch.equal(x, ref)
