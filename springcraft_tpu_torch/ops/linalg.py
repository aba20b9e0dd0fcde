"""
Symmetric eigensolves and the Hermitian pseudo-inverse.

Counterpart of ``springcraft_tpu/ops/linalg.py``.  The reference's NMA
hot spots are LAPACK calls: ``np.linalg.eigh`` (reference ``nma.py:61``)
and ``np.linalg.pinv(..., hermitian=True, rcond=1e-6)`` (``anm.py:135``,
``gnm.py:128``).  Here both run through ``torch.linalg.eigh`` on the
device, leading batch dimensions allowed, with the pseudo-inverse built
from the eigendecomposition and an eigenvalue threshold that reproduces
NumPy's ``rcond`` rule exactly::

    cutoff = rcond * max|lambda|
    pinv   = U diag(1/lambda where |lambda| > cutoff else 0) U^T

A tensor keeps its device and dtype; anything else becomes a float64
tensor on `device`, by default the current CUDA device.
"""

from __future__ import annotations

import torch

from ..utils.config import as_tensor

__all__ = ["eigh", "pinvh", "pinvh_from_eigh", "eigensystem"]


def _as_matrix(matrix, device):
    if isinstance(matrix, torch.Tensor):
        return as_tensor(matrix, matrix.dtype, device)
    return as_tensor(matrix, torch.float64, device)


def eigh(matrix, device=None):
    """Eigenvalues (ascending) and eigenvectors (columns) of a symmetric
    matrix ``(..., m, m)``."""
    return torch.linalg.eigh(_as_matrix(matrix, device))


def eigensystem(matrix, device=None):
    """
    Eigen decomposition in the reference's convention: eigenvalues in
    ascending order and **modes in rows** — ``eig_vectors[i]`` belongs to
    ``eig_values[i]`` (reference ``nma.py:61-63``).
    """
    vals, vecs = eigh(matrix, device)
    return vals, vecs.transpose(-1, -2)


def pinvh(matrix, rcond=1e-6, device=None):
    """
    Moore-Penrose pseudo-inverse of a symmetric matrix ``(..., m, m)``,
    matching ``np.linalg.pinv(matrix, hermitian=True, rcond=rcond)``.
    """
    return pinvh_from_eigh(*eigh(matrix, device), rcond=rcond)


def pinvh_from_eigh(vals, vecs, rcond=1e-6):
    """:func:`pinvh` from a decomposition already at hand: `vals` ``(...,
    m)`` and `vecs` ``(..., m, m)`` in columns, as :func:`eigh` returns
    them."""
    abs_vals = vals.abs()
    cutoff = rcond * abs_vals.amax(dim=-1, keepdim=True)
    inv_vals = torch.where(abs_vals > cutoff, 1.0 / vals,
                           torch.zeros_like(vals))
    return (vecs * inv_vals[..., None, :]) @ vecs.transpose(-1, -2)
