"""
Lowest normal modes from a covariance already in hand.

Counterpart of ``springcraft_tpu/ops/modes.py:395-450``
(:func:`modes_from_covariance`).  The rest of that module (shift-invert
and LOBPCG solvers, ``refine_modes_f64``) is not ported yet.
"""

from __future__ import annotations

import torch

__all__ = ["modes_from_covariance"]


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

    key = torch.arange(m * p, dtype=cov.dtype, device=cov.device)
    x = torch.cos(key.reshape(m, p) * 0.7 + seed) + 1e-3
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
