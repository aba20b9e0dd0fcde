"""
Extended normal-mode analysis as standalone functions.

Counterpart of ``springcraft_tpu/models/nma.py``: the reference-compatible
functional API (reference ``nma.py``).  Each function takes a
:class:`GNM` / :class:`ANM` model object and computes from the model's
cached float64 eigensystem or covariance, tensors on the model's device,
with the formulas of :mod:`..ops.nma_core`; results come back as
writable NumPy arrays.  Unlike the reference — which re-runs the
eigensolve inside every observable (``nma.py:145``) — the eigensystem is
computed once and cached on the model.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import nma_core
from ..ops.nma_core import K_B, N_A  # re-export
from ..utils.config import as_tensor
from .base import _numpy

__all__ = [
    "eigen",
    "frequencies",
    "mean_square_fluctuation",
    "bfactor",
    "dcc",
    "normal_mode",
    "linear_response",
    "prs",
    "effector_sensor",
    "K_B",
    "N_A",
]


def _model_info(enm):
    """(is_anm, n_trivial_modes, num_dim) for a model instance."""
    from .anm import ANM
    from .gnm import GNM

    if isinstance(enm, ANM):
        return True, 6, 3
    if isinstance(enm, GNM):
        return False, 1, 1
    raise ValueError("Instance of GNM/ANM class expected.")


def _check_anm(anm):
    from .anm import ANM

    if not isinstance(anm, ANM):
        raise ValueError("Instance of ANM class expected.")


def eigen(enm):
    """
    Eigenvalues (ascending) and eigenvectors (modes in rows) of the
    model's Kirchhoff/Hessian matrix (reference ``nma.py:29-63``).
    """
    _model_info(enm)
    return enm.eigen()


def frequencies(enm):
    """
    Mode frequencies ``sqrt(lambda) / 2 pi``; trivial-mode eigenvalues
    are taken as absolute values (reference ``nma.py:66-105``).
    """
    _, n_trivial, _ = _model_info(enm)
    eig_values, _ = enm._eigen()
    return _numpy(nma_core.frequencies_from_eigenvalues(eig_values,
                                                        n_trivial))


def _resolve_mode_subset(mode_subset, n_modes, n_trivial, device):
    """Default to all non-trivial modes; reject subsets containing
    trivial modes (reference ``nma.py:159-165``).  Returns the indices
    as a tensor on `device` and whether they are all modes."""
    if mode_subset is None:
        return torch.arange(n_trivial, n_modes, device=device), True
    mode_subset = np.asarray(mode_subset)
    if (mode_subset <= n_trivial - 1).any():
        raise ValueError(
            "Trivial modes are included in the current selection."
            " Please check your input."
        )
    return torch.as_tensor(mode_subset, device=device), False


def mean_square_fluctuation(enm, mode_subset=None, tem=None,
                            tem_factors=K_B):
    """
    Mean square fluctuation per node over the selected modes
    (reference ``nma.py:108-184``).
    """
    _, n_trivial, num_dim = _model_info(enm)
    eig_values, eig_vectors = enm._eigen()
    modes, _ = _resolve_mode_subset(mode_subset, len(eig_values), n_trivial,
                                    eig_values.device)
    return _numpy(nma_core.mean_square_fluctuation(
        eig_values, eig_vectors, modes, num_dim=num_dim, tem=tem,
        tem_factors=tem_factors))


def bfactor(enm, mode_subset=None, tem=None, tem_factors=K_B):
    """Isotropic B-factors ``8 pi^2 MSF / 3``
    (reference ``nma.py:187-230``)."""
    msf = mean_square_fluctuation(enm, mode_subset, tem, tem_factors)
    return nma_core.bfactor_from_msf(msf)


def dcc(enm, mode_subset=None, norm=True, tem=None, tem_factors=K_B):
    """
    Dynamic cross-correlation between nodes
    (reference ``nma.py:233-359``).  With all (non-trivial) modes the DCC
    is taken from the covariance (GNM: covariance itself; ANM: traces of
    its 3x3 superelements); for a mode subset it is accumulated from the
    selected modes.
    """
    is_anm, n_trivial, num_dim = _model_info(enm)
    eig_values, eig_vectors = enm._eigen()
    modes, all_modes = _resolve_mode_subset(
        mode_subset, len(eig_values), n_trivial, eig_values.device)

    if all_modes:
        cov = enm._get_covariance()
        result = nma_core.dcc_from_covariance_anm(cov) if is_anm else cov
    else:
        result = nma_core.dcc_from_modes(eig_values, eig_vectors, modes,
                                         num_dim=num_dim)

    if norm:
        result = nma_core.normalize_dcc(result)
    if tem is not None:
        result = result * tem * tem_factors
    return _numpy(result)


def normal_mode(anm, index, amplitude, frames, movement="sine"):
    """
    Displacement trajectory depicting one ANM normal mode
    (reference ``nma.py:363-419``).
    """
    _check_anm(anm)
    _, eig_vectors = anm._eigen()
    return _numpy(nma_core.normal_mode_displacements(
        eig_vectors[index], amplitude, frames, movement=movement))


def linear_response(anm, force):
    """
    Atom displacements induced by `force` via linear response theory
    (reference ``nma.py:422-473``).
    """
    _check_anm(anm)
    force = np.asarray(force)
    n = len(anm._coord)
    if force.ndim == 2:
        if force.shape != (n, 3):
            raise ValueError(
                f"Expected force with shape {(n, 3)}, got {force.shape}"
            )
    elif force.ndim == 1:
        if len(force) != n * 3:
            raise ValueError(
                f"Expected force with length {n * 3}, got {len(force)}"
            )
    else:
        raise ValueError(
            f"Expected 1D or 2D array, got {force.ndim} dimensions"
        )
    cov = anm._get_covariance()
    return _numpy(nma_core.linear_response_displacement(
        cov, torch.as_tensor(force, dtype=cov.dtype, device=cov.device)))


def prs(anm, norm=True):
    """
    Perturbation-response-scanning matrix
    (reference ``nma.py:476-524``).
    """
    _check_anm(anm)
    return _numpy(nma_core.prs_matrix(anm._get_covariance(), norm=norm))


def effector_sensor(prs_matrix, device=None):
    """
    Effector/sensor profiles from a (normalized) PRS matrix
    (reference ``nma.py:527-569``).  A tensor is computed on its own
    device; anything else in float64 on `device`, by default the current
    CUDA device.
    """
    if not isinstance(prs_matrix, torch.Tensor):
        prs_matrix = as_tensor(prs_matrix, torch.float64, device)
    eff, sens = nma_core.effector_sensor_profiles(prs_matrix)
    return _numpy(eff), _numpy(sens)
