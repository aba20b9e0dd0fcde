"""
Partial-spectrum solvers: the lowest non-trivial normal modes without a
full eigendecomposition, and their float64 refinement.

Counterpart of ``springcraft_tpu/ops/modes.py``:

* :func:`lowest_modes` — reflected-spectrum LOBPCG (``c I - H``, the
  known null space shifted out of the way), a port of the JAX package's
  ``lobpcg_standard`` run for a fixed number of iterations;
* :func:`lowest_modes_shift_invert` — Cholesky-preconditioned subspace
  iteration on ``H + sigma T T^t``, with a final Rayleigh-Ritz on ``H``.
  Engine ``"chol"`` solves with ``torch.linalg`` Cholesky factors
  through the solve pair :func:`.spd_linalg.chol_solve` (on CUDA the
  kernel ``csrc/chol_solve.cu``);
  ``"invfactor"`` builds the explicit inverse factor once
  (:func:`.spd_linalg.spd_inverse_factor`, kernel K3 at its leaves), so
  that every iteration's solve is two products; ``"auto"`` takes
  ``"invfactor"`` for float32 on CUDA up to ``m = 8192`` (the JAX
  package's rule on the TPU, read as CUDA) and ``"chol"`` otherwise;
  ``"staged"`` (:func:`lowest_modes_shift_invert_staged`) is the
  Cholesky engine in three stages — the factor, one step an iteration,
  the Rayleigh-Ritz finish — under :mod:`..utils.elastic`, so that a
  long solve can be snapshotted, retried and resumed;
* :func:`shift_invert_from_chol` — the iteration on a factor in hand;
* :func:`modes_from_covariance` — subspace iteration on a covariance in
  hand;
* :func:`mode_residuals`;
* :func:`refine_modes_f64` / :func:`refine_modes_f64_gnm` — float64
  Rayleigh-Ritz of approximate modes on the device of the input, the
  operator applied from the pair list of :mod:`.pairs` (``"sparse"``,
  families with a cutoff) or from streamed row panels of
  :func:`.assembly.hessian_rows` / :func:`.assembly.kirchhoff_rows`
  (``"dense"``), never a resident float64 matrix, on the network that
  the modes' matrix was assembled on (:func:`_network_dtype`);
* :func:`lowest_modes_anm` — the six rigid-body modes deflated
  analytically, by shift-invert or LOBPCG.

Modes come back in rows, ``(k, m)``, as in the JAX package.

Spans (:func:`..utils.profiling.span`): ``lowest_modes_anm`` around
that call; ``prep`` (the regularization), ``cholesky`` (the factor) and
``sweeps`` (the iterations and their Rayleigh-Ritz) inside the
shift-invert solvers; ``refine`` around each refinement, whose host pair
search is ``pair_search`` (:func:`.pairs.pair_list`).  Counters:
``lowest_modes_shift_invert.sweeps``, the shift-invert iterations run
(by every solver here), and
``refine_modes_f64.listed_pairs`` / ``refine_modes_f64_gnm.listed_pairs``,
the pairs of the refinements' pair lists.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import elastic
from ..utils.config import as_tensor
from ..utils.profiling import span
from . import assembly, pairs, rigid, spd_linalg
from .ffparams import squared_norm

__all__ = [
    "lowest_modes",
    "lowest_modes_anm",
    "lowest_modes_shift_invert",
    "lowest_modes_shift_invert_staged",
    "shift_invert_from_chol",
    "modes_from_covariance",
    "mode_residuals",
    "refine_modes_f64",
    "refine_modes_f64_gnm",
]

#: Largest dimension at which ``engine="auto"`` builds the explicit
#: inverse factor (the JAX package's TPU threshold).
INVFACTOR_MAX_DIM = 8192


def _start_block(m, p, seed, like):
    """The deterministic start ``cos(0.7 j + seed) + 1e-3`` ``(m, p)``."""
    key = torch.arange(m * p, dtype=like.dtype, device=like.device)
    return torch.cos(key.reshape(m, p) * 0.7 + seed) + 1e-3


def _project_out_of(t):
    """``x -> x - T T^t x`` (identity for ``t is None``)."""
    if t is None:
        return lambda x: x
    return lambda x: x - t @ (t.T @ x)


def _dense_lowest(matrix, k, null_basis):
    n_null = 0 if null_basis is None else null_basis.shape[1]
    vals, vecs = torch.linalg.eigh(matrix)
    return vals[n_null:n_null + k], vecs[:, n_null:n_null + k].T


# ---------------------------------------------------------------------------
# LOBPCG (the JAX package's lobpcg_standard, tol=0)
# ---------------------------------------------------------------------------

def _eigh_symmetrized(a):
    """``eigh`` of ``(a + a^T) / 2``, as ``jnp.linalg.eigh`` symmetrizes
    its input: the rounding of a product's two triangles differs."""
    return torch.linalg.eigh((a + a.T) / 2)


def _svqb(x):
    """Orthonormal basis of the columns of `x`, degenerate directions
    zeroed (SVQB on the Gram matrix)."""
    norms = torch.linalg.vector_norm(x, dim=0, keepdim=True)
    x = x / torch.where(norms == 0, torch.ones_like(norms), norms)
    inner = x.T @ x
    w, v = _eigh_symmetrized(inner)
    w, v = w.flip(0), v.flip(1)
    tau = torch.finfo(x.dtype).eps * w[0]
    padded = torch.maximum(w, tau)
    sqrted = torch.where(tau > 0, padded, torch.ones_like(padded)) ** -0.5
    ortho = x @ (v * sqrted[None, :])
    keep = ((w > tau) & (torch.diagonal(inner) > 0))[None, :]
    ortho = ortho * keep
    norms = torch.linalg.vector_norm(ortho, dim=0, keepdim=True)
    keep = keep & (norms > 0)
    return ortho / torch.where(keep, norms, torch.ones_like(norms))


def _orthonormalize(x):
    return _svqb(_svqb(x))


def _project_out(basis, u):
    """The part of `u` orthogonal to the orthonormal `basis`, its nonzero
    columns orthonormal, suspicious ones zeroed."""
    for _ in range(2):
        u = _orthonormalize(u - basis @ (basis.T @ u))
    for _ in range(2):
        u = u - basis @ (basis.T @ u)
    norms = torch.linalg.vector_norm(u, dim=0, keepdim=True)
    return u * (norms >= 0.99)


def _extend_basis(x, extra):
    """`extra` orthonormal directions orthogonal to the orthonormal `x`,
    by a block Householder reflector."""
    n, k = x.shape
    upper, lower = x[:k], x[k:]
    u, s, vt = torch.linalg.svd(upper)
    y = torch.cat([upper + u @ vt, lower], dim=0)
    other = torch.cat([torch.eye(extra, dtype=x.dtype, device=x.device),
                       x.new_zeros((n - k - extra, extra))], dim=0)
    w = y @ (vt.T * ((2 * (1 + s)) ** -0.5)[None, :])
    h = -2 * (w @ (w[k:].T @ other))
    h[k:] += other
    return h


def _lobpcg_standard(matvec, x, n_iter):
    """Largest eigenpairs of the operator `matvec` from the start block
    `x` ``(n, k)``, all `n_iter` iterations (no stopping test)."""
    k = x.shape[1]
    x = _orthonormalize(x)
    p = _extend_basis(x, k)
    ax = matvec(x)
    theta = (x * ax).sum(dim=0, keepdim=True)
    r = ax - theta * x
    for _ in range(n_iter):
        r = _project_out(torch.cat([x, p], dim=1), r)
        xpr = torch.cat([x, p, r], dim=1)
        theta, q = _eigh_symmetrized(xpr.T @ matvec(xpr))
        theta, q = theta.flip(0), q.flip(1)
        b = q[:, :k]
        b = b / torch.linalg.vector_norm(b, dim=0, keepdim=True)
        x = xpr @ b
        x = x / torch.linalg.vector_norm(x, dim=0, keepdim=True)
        qq, _ = torch.linalg.qr(q[:k, k:].T)
        p = xpr @ (q[:, k:] @ qq)
        norms = torch.linalg.vector_norm(p, dim=0, keepdim=True)
        p = p / torch.where(norms == 0, torch.ones_like(norms), norms)
        r = matvec(x) - theta[None, :k] * x
    return theta[:k], x


def lowest_modes(matrix, k, null_basis=None, n_iter=200, seed=0):
    """
    The `k` smallest non-trivial eigenpairs of a PSD interaction matrix
    ``(m, m)`` by LOBPCG on the reflected spectrum ``c I - H`` (``c``
    twice the Gershgorin bound), the null space `null_basis` ``(m, t)``
    shifted up by the bound.  Runs all `n_iter` iterations: the reflected
    eigenvalues make any relative stopping test meaningless, so check
    :func:`mode_residuals`.  Below ``m = 5 k`` a dense ``eigh``.

    Returns ``(eig_values (k,), eig_vectors (k, m))``, ascending.
    """
    m = matrix.shape[0]
    if 5 * k >= m:
        return _dense_lowest(matrix, k, null_basis)
    return _lobpcg_lowest(lambda x: matrix @ x, matrix.abs().sum(dim=1).max(),
                          m, k, null_basis, n_iter, seed)


def _lobpcg_lowest(matvec, upper, m, k, null_basis, n_iter, seed):
    """The LOBPCG core of :func:`lowest_modes` over an operator:
    `matvec` ``x -> H @ x`` for x ``(m, p)``, `upper` the Gershgorin
    bound of ``H`` (a 0-d tensor of its dtype on its device) — so that a
    row-sharded matrix need not be gathered
    (:func:`..parallel.sharded.sharded_lowest_modes`)."""
    t = None if null_basis is None else null_basis.to(upper.dtype)
    c = 2.0 * upper
    deflate = _project_out_of(t)

    def reflected(x):
        y = c * x - matvec(x)
        return y if t is None else y - upper * (t @ (t.T @ x))

    x0, _ = torch.linalg.qr(deflate(_start_block(m, k, seed, upper)))
    mu, vecs = _lobpcg_standard(reflected, x0, n_iter)
    vals = c - mu
    order = torch.argsort(vals)
    return vals[order], vecs[:, order].T


# ---------------------------------------------------------------------------
# Shift-invert subspace iteration
# ---------------------------------------------------------------------------

def _shift_invert_start(matrix, t, p, seed):
    """The orthonormal, deflated start block ``(m, p)``."""
    x = _start_block(matrix.shape[0], p, seed, matrix)
    return torch.linalg.qr(_project_out_of(t)(x))[0]


def _shift_invert_finish(matrix, x, k):
    """Rayleigh-Ritz of the block `x` on `matrix`: ``(values (k,),
    vectors (k, m))``."""
    s = x.T @ (matrix @ x)
    vals, w = torch.linalg.eigh((s + s.T) / 2)
    return vals[:k], (x @ w[:, :k]).T


def _shift_invert_step(inv_apply, t, x):
    """One step: ``qr(deflate(inv_apply(x)))``'s orthonormal factor."""
    return torch.linalg.qr(_project_out_of(t)(inv_apply(x)))[0]


def _shift_invert_iterate(matrix, inv_apply, t, *, k, n_iter, oversample,
                          seed, checkpoint=None, retries=0, wait=5.0):
    """Deflated subspace iteration through `inv_apply`, one
    :func:`~..utils.elastic.resumable_loop` step an iteration (a snapshot
    to `checkpoint` after each, `retries` device failures retried), then
    Rayleigh-Ritz on `matrix` under
    :func:`~..utils.elastic.retry_on_failure`."""
    m = matrix.shape[0]
    p = k + (max(k, 8) if oversample is None else oversample)
    retry = dict(retries=retries, wait=wait, probe=matrix.device)

    def step(_, state):
        x = elastic._restore(state["x"], (m, p), matrix.dtype,
                             matrix.device)
        lowest_modes_shift_invert.sweeps += 1
        return {"x": _shift_invert_step(inv_apply, t, x)}

    with span("sweeps"):
        state, _ = elastic.resumable_loop(
            step, {"x": _shift_invert_start(matrix, t, p, seed)}, n_iter,
            checkpoint=checkpoint, **retry)
        return elastic.retry_on_failure(_shift_invert_finish, matrix,
                                        state["x"], k, **retry)


def _resolve_engine(engine, matrix):
    if engine == "auto":
        return ("invfactor" if matrix.dtype == torch.float32
                and matrix.device.type == "cuda"
                and matrix.shape[0] <= INVFACTOR_MAX_DIM else "chol")
    if engine not in ("chol", "invfactor"):
        raise ValueError(f"unknown engine {engine!r}")
    return engine


def lowest_modes_shift_invert(matrix, t, *, k, n_iter=24, oversample=None,
                              seed=0, engine="auto", **staged_options):
    """
    The `k` smallest non-null eigenpairs of a PSD `matrix` ``(m, m)``
    with orthonormal null basis `t` ``(m, n_null)`` by shift-invert
    subspace iteration: ``H + sigma T T^t`` (sigma the mean diagonal)
    is Jacobi-equilibrated and factored once, then an oversampled block
    (``oversample``, default ``max(k, 8)``) goes through its inverse
    `n_iter` times with the null space projected out, and a final
    Rayleigh-Ritz on `matrix` gives the pairs.

    `engine`: ``"chol"`` (``torch.linalg.cholesky`` and two triangular
    solves a step, :func:`.spd_linalg.chol_solve`), ``"invfactor"`` (the
    explicit inverse factor of
    :func:`.spd_linalg.spd_inverse_factor`, float32 on CUDA through
    kernel K3, then two products a step), ``"auto"`` (``"invfactor"``
    for float32 on CUDA up to ``m = 8192``, else ``"chol"``) or
    ``"staged"`` (:func:`lowest_modes_shift_invert_staged`, which alone
    takes `staged_options`).

    Returns ``(eig_values (k,), eig_vectors (k, m))``, ascending.
    """
    if engine == "staged":
        return lowest_modes_shift_invert_staged(
            matrix, t, k=k, n_iter=n_iter, oversample=oversample, seed=seed,
            **staged_options)
    if staged_options:
        raise TypeError(f"options {sorted(staged_options)} are only valid "
                        f"with engine='staged'")
    engine = _resolve_engine(engine, matrix)
    t = t.to(matrix.dtype)
    m = matrix.shape[0]
    with span("prep"):
        reg, scale, _ = rigid._regularize_equilibrated(matrix, t)
    if engine == "chol":
        with span("cholesky"):
            chol = rigid._cholesky_factor(reg)
        return shift_invert_from_chol(
            matrix, chol, scale, t, k=k, n_iter=n_iter,
            oversample=oversample, seed=seed)
    g = spd_linalg.spd_inverse_factor(reg[None])[0]
    mp = g.shape[-1]
    # the equilibration folded into the factor's columns (zero past m):
    # inv(reg_unscaled) = W^T W with W = G S
    w = g * rigid._padded_scale(scale, mp)[None, :]

    def inv_apply(x):
        return (w.T @ (w @ F.pad(x, (0, 0, 0, mp - m))))[:m]

    return _shift_invert_iterate(matrix, inv_apply, t, k=k, n_iter=n_iter,
                                 oversample=oversample, seed=seed)


#: Shift-invert iterations run, by every solver of this module.
lowest_modes_shift_invert.sweeps = 0


def _chol_inverse(chol, scale):
    """``x -> S (S A S)^-1 S x`` through the equilibrated Cholesky factor
    ``chol`` of ``S A S``, ``S = diag(scale)``: the solve pair of
    :func:`.spd_linalg.chol_solve`, which reads the factor in place
    (column-major, as ``torch.linalg.cholesky_ex`` returns it; a factor
    in another layout, or with a leading dimension that is no multiple of
    16 bytes, is copied to it once here)."""
    chol = spd_linalg.chol_solve_factor(chol)

    def inv_apply(x):
        return spd_linalg.chol_solve(x, chol, scale)

    return inv_apply


def shift_invert_from_chol(matrix, chol, scale, t, *, k, n_iter=24,
                           oversample=None, seed=0):
    """Shift-invert subspace iteration on an existing equilibrated
    Cholesky factor `chol` of ``S (H + sigma T T^t) S`` with ``S =
    diag(scale)``, so that one factor serves the covariance and the
    modes."""
    return _shift_invert_iterate(matrix, _chol_inverse(chol, scale),
                                 t.to(matrix.dtype), k=k, n_iter=n_iter,
                                 oversample=oversample, seed=seed)


def lowest_modes_shift_invert_staged(matrix, t, *, k, n_iter=24,
                                     oversample=None, seed=0,
                                     checkpoint=None, retries=2, wait=5.0):
    """
    :func:`lowest_modes_shift_invert` with ``engine="chol"``, in the JAX
    package's three stages, each a recovery point of
    :mod:`..utils.elastic`: the regularized factor under
    :func:`~..utils.elastic.retry_on_failure`, one
    :func:`~..utils.elastic.resumable_loop` step an iteration (solve,
    deflate, QR), the Rayleigh-Ritz finish under ``retry_on_failure``.

    ``checkpoint=path`` snapshots the subspace after every iteration, so
    a process killed mid-solve resumes where it stopped (the same
    contract as :func:`..ops.matfree.lowest_modes_matfree`); `retries`
    device failures are retried per stage and per step, after `wait`
    seconds and a probe of the matrix's device.  The iteration is the
    ``"chol"`` engine's, start block included, so the result equals
    ``lowest_modes_shift_invert(engine="chol")`` bit for bit.
    """
    t = t.to(matrix.dtype)

    def factor():
        with span("prep"):
            reg, scale, _ = rigid._regularize_equilibrated(matrix, t)
        with span("cholesky"):
            return rigid._cholesky_factor(reg), scale

    chol, scale = elastic.retry_on_failure(factor, retries=retries,
                                           wait=wait, probe=matrix.device)
    return _shift_invert_iterate(matrix, _chol_inverse(chol, scale), t, k=k,
                                 n_iter=n_iter, oversample=oversample,
                                 seed=seed, checkpoint=checkpoint,
                                 retries=retries, wait=wait)


def modes_from_covariance(cov, matrix, t, *, k, n_iter=16, oversample=None,
                          seed=0):
    """
    The `k` smallest non-null eigenpairs of `matrix` by subspace iteration
    on its pseudo-inverse covariance `cov`: the dominant eigenvectors of
    ``cov`` are the lowest non-trivial modes, so they cost `n_iter`
    products, a QR every fourth step and one final Rayleigh-Ritz on
    `matrix`.

    Parameters
    ----------
    cov, matrix : Tensor, shape=(..., m, m)
    t : Tensor, shape=(..., m, n_null)
        Orthonormal null-space basis, deflated from every iterate.
    k : int
    n_iter : int
    oversample : int, optional
        Extra subspace columns, ``max(k, 8)`` by default.
    seed : float
        Phase of the deterministic start ``cos(0.7 j + seed) + 1e-3``.

    Returns
    -------
    vals : Tensor, shape=(..., k), ascending
    vecs : Tensor, shape=(..., k, m), modes in rows
    """
    m = cov.shape[-1]
    p = k + (max(k, 8) if oversample is None else oversample)
    t = t.to(cov.dtype)

    def deflate(x):
        return x - t @ (t.transpose(-1, -2) @ x)

    x = _start_block(m, p, seed, cov)
    x, _ = torch.linalg.qr(deflate(x.expand(cov.shape[:-2] + (m, p))))
    for i in range(n_iter):
        y = deflate(cov @ x)
        # column renormalization each step, a full QR every fourth
        y = y / torch.linalg.vector_norm(y, dim=-2, keepdim=True)
        x = torch.linalg.qr(y)[0] if i % 4 == 3 else y
    x, _ = torch.linalg.qr(x)
    s = x.transpose(-1, -2) @ (matrix @ x)
    vals, w = torch.linalg.eigh((s + s.transpose(-1, -2)) / 2)
    vecs = x @ w[..., :k]
    return vals[..., :k], vecs.transpose(-1, -2)


def mode_residuals(matrix, eig_values, eig_vectors):
    """Relative eigenpair residuals ``|H u - lambda u| / |lambda|`` of
    modes in rows."""
    u = eig_vectors.T
    r = matrix @ u - u * eig_values[None, :]
    return torch.linalg.vector_norm(r, dim=0) / eig_values.abs()


# ---------------------------------------------------------------------------
# Float64 refinement
# ---------------------------------------------------------------------------

def _is_float32(x):
    if isinstance(x, torch.Tensor):
        return x.dtype == torch.float32
    return np.asarray(x).dtype == np.float32


def _network_dtype(coord, eig_vectors):
    """The dtype whose squared distances decide which pairs the
    refinement couples and in which distance bin: float32 where both the
    coordinates and the modes are float32, the one case in which the
    modes come from a float32 assembly of float32 coordinates (the
    assembly kernels decide on the float32 squared distances), so that
    the refinement applies the network its modes were solved on; float64
    otherwise (a float64 assembly, or float64 coordinates)."""
    if _is_float32(coord) and _is_float32(eig_vectors):
        return torch.float32
    return torch.float64


def _refine_inputs(coord, eig_vectors, masses, dim_per_atom):
    """``(coord, u, masses, weights)`` in float64 on the device of the
    modes: `u` the modes as columns, `weights` the per-row ``1 /
    sqrt(m)`` (or ``None``)."""
    device = (eig_vectors.device if isinstance(eig_vectors, torch.Tensor)
              else None)
    coord = as_tensor(coord, torch.float64, device)
    u = as_tensor(eig_vectors, torch.float64, coord.device).T
    n = coord.shape[0]
    if u.shape[0] != dim_per_atom * n:
        raise ValueError(f"eig_vectors have dimension {u.shape[0]}, "
                         f"expected {dim_per_atom * n}")
    w = None
    if masses is not None:
        masses = as_tensor(masses, torch.float64, coord.device)
        w = (1.0 / torch.sqrt(masses)).repeat_interleave(dim_per_atom)
    return coord, u, masses, w


def _weighted(apply, w):
    """``x -> w * apply(w * x)`` row-wise, or `apply`."""
    if w is None:
        return apply
    return lambda x: w[:, None] * apply(w[:, None] * x)


def _rayleigh_ritz_f64(stream_apply, t, u, *, augment=False):
    """Orthonormalize `u` against the null basis `t`, project the
    operator, optionally augment with the residual block; returns
    ``(theta, vectors as columns, residuals)``."""
    m, k = u.shape
    q, _ = torch.linalg.qr(u - t @ (t.T @ u))
    hq = stream_apply(q)
    if augment and 2 * k + t.shape[1] < m:
        w = hq - q @ (q.T @ hq)
        w = w - t @ (t.T @ w)
        q2, _ = torch.linalg.qr(w)
        basis = torch.cat([q, q2], dim=1)
        hb = torch.cat([hq, stream_apply(q2)], dim=1)
    else:
        basis, hb = q, hq
    s = basis.T @ hb
    theta_all, y = torch.linalg.eigh((s + s.T) / 2)
    theta = theta_all[:k]
    vecs = basis @ y[:, :k]
    r = hb @ y[:, :k] - vecs * theta[None, :]
    return theta, vecs, torch.linalg.vector_norm(r, dim=0) / theta.abs()


def _resolve_method(method, params):
    if method == "auto":
        return "sparse" if params.has_cutoff else "dense"
    if method not in ("sparse", "dense"):
        raise ValueError(f"Unknown method '{method}'")
    return method


def refine_modes_f64(coord, params, eig_vectors, *, masses=None,
                     layout="xyz", block=256, augment=False,
                     method="auto"):
    """
    Float64 Rayleigh-Ritz refinement of approximate ANM modes, on the
    device of `eig_vectors` without a resident float64 Hessian: the
    operator is applied from the pair list of :func:`.pairs.pair_list`
    (``method="sparse"``, a family with a cutoff, O(pairs k)) or from
    atom-layout row panels of `block` atoms
    (:func:`.assembly.hessian_rows`, ``"dense"``, O(k n^2)); ``"auto"``
    takes the sparse route whenever the family has a cutoff.  ``H V``
    feeds a k-dimensional Rayleigh-Ritz problem on the float64
    orthonormalized subspace (the rigid modes deflated): its values lie
    O(eps_f32^2) from the true eigenvalues.  `augment` adds the residual
    block to the basis (one more sweep); a few buffer modes beyond the
    ones needed do more for the last mode.

    The operator is that of the network the modes were solved on: with
    float32 coordinates and float32 modes (a float32 assembly), which
    pairs interact and in which distance bin is decided on the float32
    squared distances, as the assembly kernels decide it; otherwise on
    the float64 ones.  Spring constants, distances and all that follows
    are float64 either way.

    Parameters
    ----------
    coord : Tensor or ndarray, shape=(n, 3)
    params : FFParams
        An analytic family or a table; overlays only on the sparse route.
    eig_vectors : Tensor, shape=(k, 3n)
        Approximate modes in rows, any precision, in `layout`.
    masses : Tensor or ndarray, shape=(n,), optional
        Mass weighting (``W H W``), the null space weighted to match.
    layout : {"xyz", "atom"}

    Returns
    -------
    eig_values : Tensor, shape=(k,), float64, ascending
    eig_vectors : Tensor, shape=(k, 3n), float64, in `layout`
    residuals : Tensor, shape=(k,), float64
        ``|H v - theta v| / theta``.
    """
    if layout not in ("xyz", "atom"):
        raise ValueError(f"Unknown layout '{layout}'")
    with span("refine"):
        network = _network_dtype(coord, eig_vectors)
        coord, u, masses, w3 = _refine_inputs(coord, eig_vectors, masses, 3)
        n = coord.shape[0]
        m = 3 * n
        perm = None
        if layout == "xyz":
            # xyz plane layout -> atom-interleaved
            perm = (torch.arange(n, device=coord.device)[:, None]
                    + n * torch.arange(3, device=coord.device)[None, :]
                    ).reshape(-1)
            u = u[perm]
        method = _resolve_method(method, params)
        if method == "sparse":
            pi, pj, kvals = pairs.pair_list(coord, params, network=network)
            refine_modes_f64.listed_pairs += pi.numel()
            sq = squared_norm(coord[pi] - coord[pj])
            g = kvals / torch.where(sq == 0, torch.ones_like(sq), sq)

            def apply(x):
                return pairs.hessian_apply_pairs(
                    coord, pi, pj, g, x.reshape(n, 3, -1)).reshape(m, -1)
        else:
            def apply(x):
                hx = torch.empty((m, x.shape[1]), dtype=x.dtype,
                                 device=x.device)
                for rs in range(0, n, block):
                    b = min(block, n - rs)
                    hx[3 * rs:3 * (rs + b)] = assembly.hessian_rows(
                        coord, params, rs, b, network=network) @ x
                return hx

        t = rigid.rigid_modes_anm(coord, masses=masses, layout="atom")
        theta, vecs, res = _rayleigh_ritz_f64(_weighted(apply, w3), t, u,
                                              augment=augment)
        if perm is not None:
            vecs = vecs[torch.argsort(perm)]
        return theta, vecs.T, res



def refine_modes_f64_gnm(coord, params, eig_vectors, *, masses=None,
                         block=2048, augment=False, method="auto"):
    """
    Float64 Rayleigh-Ritz refinement of approximate GNM modes
    ``(k, n)``: :func:`refine_modes_f64` over the Kirchhoff operator
    (pair list through :func:`.pairs.kirchhoff_apply_pairs`, or
    :func:`.assembly.kirchhoff_rows` panels of `block` rows), the
    (``sqrt(m)``-scaled) constant mode deflated.

    Returns ``(eig_values (k,), eig_vectors (k, n), residuals (k,))``,
    float64 on the device of `eig_vectors`; the network as in
    :func:`refine_modes_f64`.
    """
    with span("refine"):
        network = _network_dtype(coord, eig_vectors)
        coord, u, _, w = _refine_inputs(coord, eig_vectors, masses, 1)
        n = coord.shape[0]
        method = _resolve_method(method, params)
        if method == "sparse":
            pi, pj, kvals = pairs.pair_list(coord, params, network=network)
            refine_modes_f64_gnm.listed_pairs += pi.numel()

            def apply(x):
                return pairs.kirchhoff_apply_pairs(pi, pj, kvals, n, x)
        else:
            def apply(x):
                kx = torch.empty((n, x.shape[1]), dtype=x.dtype,
                                 device=x.device)
                for rs in range(0, n, block):
                    b = min(block, n - rs)
                    kx[rs:rs + b] = assembly.kirchhoff_rows(
                        coord, params, rs, b, network=network) @ x
                return kx

        null = torch.ones(n, dtype=torch.float64, device=coord.device) \
            if w is None else 1.0 / w
        t = (null / torch.linalg.vector_norm(null))[:, None]
        theta, vecs, res = _rayleigh_ritz_f64(_weighted(apply, w), t, u,
                                              augment=augment)
        return theta, vecs.T, res


refine_modes_f64.listed_pairs = 0
refine_modes_f64_gnm.listed_pairs = 0


def lowest_modes_anm(hessian_xyz, coord, k, masses=None, n_iter=24,
                     method="shift_invert", engine="auto",
                     **solver_options):
    """
    The `k` lowest non-trivial ANM modes of an xyz-layout Hessian ``(3n,
    3n)``, the six rigid-body modes of `coord` deflated analytically.
    `method` ``"shift_invert"`` (`engine` and `solver_options` as in
    :func:`lowest_modes_shift_invert`; `n_iter` about 24) or
    ``"lobpcg"`` (:func:`lowest_modes`, `n_iter` about 200; check the
    residuals).  Small systems take a dense ``eigh``.

    Returns ``(eig_values (k,), eig_vectors (k, 3n))``, xyz layout.
    """
    with span("lowest_modes_anm"):
        matrix = hessian_xyz
        coord = as_tensor(coord, matrix.dtype, matrix.device)
        if masses is not None:
            masses = as_tensor(masses, matrix.dtype, matrix.device)
        basis = rigid.rigid_modes_anm(coord, masses=masses, layout="xyz")
        if method == "shift_invert":
            if 2 * max(k, 8) + 2 * k >= matrix.shape[0]:
                return _dense_lowest(matrix, k, basis)
            return lowest_modes_shift_invert(matrix, basis, k=k,
                                             n_iter=n_iter, engine=engine,
                                             **solver_options)
        if method != "lobpcg":
            raise ValueError(f"Unknown method '{method}'")
        if solver_options:
            raise TypeError(f"options {sorted(solver_options)} are only "
                            f"valid with method='shift_invert'")
        return lowest_modes(matrix, k, null_basis=basis, n_iter=n_iter)
