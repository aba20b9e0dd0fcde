"""
Normal-mode-analysis observables as plain tensor functions.

Counterpart of ``springcraft_tpu/ops/nma_core.py``: the same formulas
(reference ``nma.py``, citations inline there) without the array-module
argument.  Functions that take a matrix accept leading batch dimensions
where noted, which replaces the JAX package's ``vmap``.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "K_B",
    "N_A",
    "fold_modes",
    "frequencies_from_eigenvalues",
    "mean_square_fluctuation",
    "bfactor_from_msf",
    "dcc_from_modes",
    "dcc_from_covariance_anm",
    "normalize_dcc",
    "normal_mode_displacements",
    "linear_response_displacement",
    "prs_matrix",
    "effector_sensor_profiles",
]

K_B = 1.380649e-23
N_A = 6.02214076e23


def fold_modes(sq_vectors, num_dim=3, layout="atom"):
    """Fold squared mode vectors ``(..., m, 3n)`` to ``(..., m, n)``
    (reference ``nma.py:148-150``; identity for GNM, ``num_dim=1``)."""
    if num_dim == 1:
        return sq_vectors
    lead = sq_vectors.shape[:-1]
    if layout == "atom":
        return sq_vectors.reshape(lead + (-1, num_dim)).sum(dim=-1)
    return sq_vectors.reshape(lead + (num_dim, -1)).sum(dim=-2)


def frequencies_from_eigenvalues(eig_values, n_trivial):
    """``nu = sqrt(lambda) / (2 pi)``, trivial modes taken by absolute
    value (reference ``nma.py:97-103``)."""
    n = eig_values.shape[-1]
    idx = torch.arange(n, device=eig_values.device)
    vals = torch.where(idx < n_trivial, eig_values.abs(), eig_values)
    return torch.sqrt(vals) / (2 * math.pi)


def temperature_scaling(tem, tem_factors):
    """Reference ``nma.py:177-182``."""
    return 1.0 if tem is None else tem * tem_factors


def mean_square_fluctuation(eig_values, eig_vectors, mode_indices,
                            num_dim=3, layout="atom", tem=None,
                            tem_factors=K_B):
    """MSF per node over the selected modes (reference
    ``nma.py:108-184``); leading batch dimensions allowed."""
    vals = eig_values[..., mode_indices]
    vecs = eig_vectors[..., mode_indices, :]
    folded = fold_modes(vecs.square(), num_dim=num_dim, layout=layout)
    msf = (folded / vals[..., None]).sum(dim=-2)
    return msf * temperature_scaling(tem, tem_factors)


def bfactor_from_msf(msf):
    """``B = 8 pi^2 MSF / 3`` (reference ``nma.py:228``); any shape."""
    return (8 * math.pi**2) * msf / 3


def dcc_from_modes(eig_values, eig_vectors, mode_indices, num_dim=3,
                   layout="atom"):
    """Unnormalized DCC ``sum_k u_k u_k^T / lambda_k`` over a mode
    subset (reference ``nma.py:337-347``); leading batch dimensions
    allowed."""
    vals = eig_values[..., mode_indices]
    vecs = eig_vectors[..., mode_indices, :]
    lead = vecs.shape[:-1]
    if layout == "atom":
        modes = vecs.reshape(lead + (-1, num_dim))
    else:
        modes = vecs.reshape(lead + (num_dim, -1)).transpose(-1, -2)
    return torch.einsum("...kid,...kjd,...k->...ij", modes, modes,
                        1.0 / vals)


def dcc_from_covariance_anm(covariance):
    """All-modes ANM DCC: trace of each 3x3 superelement of an
    atom-layout covariance (reference ``nma.py:326-336``)."""
    n = covariance.shape[-1] // 3
    reshaped = covariance.reshape(covariance.shape[:-2] + (n, 3, n, 3))
    return sum(reshaped[..., :, a, :, a] for a in range(3))


def normalize_dcc(dcc):
    """``nDCC_ij = DCC_ij / sqrt(DCC_ii DCC_jj)`` (``nma.py:350-353``);
    leading batch dimensions allowed."""
    diag = torch.diagonal(dcc, dim1=-2, dim2=-1)
    return dcc / torch.sqrt(diag[..., None, :] * diag[..., :, None])


def normal_mode_displacements(mode_vector, amplitude, frames,
                              movement="sine"):
    """Displacement trajectory of one ANM normal mode (reference
    ``nma.py:363-419``)."""
    mode = mode_vector.reshape(-1, 3)
    lengths = torch.sqrt((mode**2).sum(dim=-1))
    mode = mode * (amplitude / lengths.max())
    time = torch.arange(frames, dtype=mode.dtype,
                        device=mode.device) / frames
    if movement == "sine":
        modulation = torch.sin(time * 2 * math.pi)
    elif movement == "triangle":
        modulation = 2 * torch.abs(2 * (time - torch.floor(time + 0.5))) - 1
    else:
        raise ValueError(f"Movement '{movement}' is unknown")
    return modulation[:, None, None] * mode


def linear_response_displacement(covariance, force):
    """LRT displacement ``C @ f`` reshaped to ``(n, 3)`` (reference
    ``nma.py:457-473``)."""
    return (covariance @ force.reshape(-1)).reshape(-1, 3)


def prs_matrix(covariance, norm=True, layout="atom"):
    """Perturbation-response scanning matrix ``(..., n, n)`` of ANM
    covariances ``(..., 3n, 3n)``, leading batch dimensions allowed
    (reference ``nma.py:511-523``).  ``layout="xyz"`` folds an xyz-layout
    covariance, as ``springcraft_tpu/parallel/pipeline.py:668-669``
    does."""
    n = covariance.shape[-1] // 3
    batch = covariance.shape[:-2]
    sq = covariance.square()
    if layout == "atom":
        prs = sq.reshape(batch + (n, 3, n, 3)).sum(dim=(-3, -1))
    elif layout == "xyz":
        prs = sq.reshape(batch + (3, n, 3, n)).sum(dim=(-4, -2))
    else:
        raise ValueError(f"unknown layout {layout!r}")
    if norm:
        prs = prs / torch.diagonal(prs, dim1=-2, dim2=-1)[..., :, None]
    return prs


def effector_sensor_profiles(prs):
    """Row/column means of PRS matrices ``(..., n, n)`` without their
    diagonal, leading batch dimensions allowed (reference
    ``nma.py:562-568``)."""
    n = prs.shape[-1]
    diag = torch.diagonal(prs, dim1=-2, dim2=-1)
    effector = (prs.sum(dim=-1) - diag) / (n - 1)
    sensor = (prs.sum(dim=-2) - diag) / (n - 1)
    return effector, sensor
