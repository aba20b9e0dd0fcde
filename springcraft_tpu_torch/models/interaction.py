"""
Public Kirchhoff / Hessian computation.

Counterpart of ``springcraft_tpu/models/interaction.py``: drop-in
equivalents of reference ``interaction.py:14-111``
(``compute_kirchhoff`` / ``compute_hessian``), returning float64 NumPy
matrices plus the interacting pair list.

Two execution paths:

* **dense** (every built-in force field): the force field is lowered to
  an :class:`~..ops.ffparams.FFParams` and the matrix is assembled in
  float64 on `device` (by default the current CUDA device) by the dense
  masked algebra of :mod:`..ops.assembly`, as the JAX package assembles
  it; the pair list comes from the same adjacency.
* **host** (custom ``ForceField`` subclasses without ``to_params``):
  adjacency from the cutoff (optionally through the cell list), pairs
  extracted, and the user's polymorphic ``force_constant`` called once
  over all pairs — the reference's extension contract
  (``forcefield.py:67-94``), in numpy as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import assembly, ffparams
from ..structure.atoms import coord as as_coord
from ..structure.celllist import CellList
from ..utils.config import as_tensor

__all__ = ["compute_kirchhoff", "compute_hessian"]


def compute_kirchhoff(coord, force_field, use_cell_list=True,
                      return_pairs=True, device=None):
    """
    Kirchhoff matrix for the given coordinates and force field.

    Parameters
    ----------
    return_pairs : bool, optional
        If ``False``, skip building the O(n^2) interacting-pair list and
        return ``None`` in its place (the model classes do this — they
        only need the matrix).
    device : str or torch.device, optional
        Where the dense path assembles; the current CUDA device by
        default.

    Returns
    -------
    kirchhoff : ndarray, shape=(n, n), dtype=float64
    pairs : ndarray, shape=(k, 2), dtype=int, or None
        Indices of interacting atom pairs.
    """
    matrix, pairs = _kirchhoff(coord, force_field, use_cell_list,
                               return_pairs, device)
    return matrix.cpu().numpy(), pairs


def compute_hessian(coord, force_field, use_cell_list=True,
                    return_pairs=True, device=None):
    """
    Hessian matrix (atom-interleaved layout
    ``[x1, y1, z1, ..., xn, yn, zn]``) for the given coordinates and
    force field.

    Parameters
    ----------
    return_pairs : bool, optional
        If ``False``, skip building the O(n^2) interacting-pair list and
        return ``None`` in its place.
    device : str or torch.device, optional
        Where the dense path assembles; the current CUDA device by
        default.

    Returns
    -------
    hessian : ndarray, shape=(3n, 3n), dtype=float64
    pairs : ndarray, shape=(k, 2), dtype=int, or None
    """
    matrix, pairs = _hessian(coord, force_field, use_cell_list,
                             return_pairs, device)
    return matrix.cpu().numpy(), pairs


# ---------------------------------------------------------------------------
# The float64 matrix as a tensor on `device` (what the model classes keep)
# ---------------------------------------------------------------------------

def _kirchhoff(coord, force_field, use_cell_list, return_pairs, device):
    coord = _check_coord(coord, force_field)
    params = force_field.to_params(natoms=len(coord))
    if params is None:
        matrix, pairs = _host_kirchhoff(coord, force_field, use_cell_list)
        return as_tensor(matrix, torch.float64, device), pairs
    coord_t = as_tensor(coord, torch.float64, device)
    pairs = _pairs_from_params(coord_t, params) if return_pairs else None
    return assembly.kirchhoff_matrix(coord_t, params), pairs


def _hessian(coord, force_field, use_cell_list, return_pairs, device):
    coord = _check_coord(coord, force_field)
    params = force_field.to_params(natoms=len(coord))
    if params is None:
        matrix, pairs = _host_hessian(coord, force_field, use_cell_list)
        return as_tensor(matrix, torch.float64, device), pairs
    coord_t = as_tensor(coord, torch.float64, device)
    pairs = _pairs_from_params(coord_t, params) if return_pairs else None
    return assembly.hessian_matrix(coord_t, params, layout="atom"), pairs


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------

def _check_coord(coord, force_field):
    coord = np.asarray(as_coord(coord), dtype=np.float64)
    if coord.ndim != 2 or coord.shape[1] != 3:
        raise ValueError(
            f"Expected coordinates with shape (n,3), got {coord.shape}"
        )
    if force_field.natoms is not None and len(coord) != force_field.natoms:
        raise ValueError(
            f"Got coordinates for {len(coord)} atoms, "
            f"but forcefield was built for {force_field.natoms} atoms"
        )
    return coord


def _pairs_from_params(coord, params):
    """Interacting-pair index list of the dense path (row-major order,
    matching the reference's ``np.where`` over the adjacency matrix),
    from the adjacency the assembly composes, overlays included."""
    _, sq = ffparams.pairwise_sq_distance(coord)
    mask = ffparams.effective_adjacency(sq, params)
    return torch.nonzero(mask).cpu().numpy()


# ---------------------------------------------------------------------------
# Host path (custom force fields)
# ---------------------------------------------------------------------------

def _host_adjacency(coord, force_field, use_cell_list):
    cutoff = force_field.cutoff_distance
    if cutoff is None:
        adj = ~np.eye(len(coord), dtype=bool)
    else:
        if use_cell_list:
            adj = CellList(coord, cutoff).create_adjacency_matrix(cutoff)
        else:
            disp = coord[:, None, :] - coord[None, :, :]
            sq_dist = np.einsum("ijk,ijk->ij", disp, disp)
            adj = sq_dist <= cutoff**2
        np.fill_diagonal(adj, False)

    # Artificial contact switching (reference interaction.py:193-213)
    shutdown = force_field.contact_shutdown
    if shutdown is not None:
        adj[shutdown, :] = False
        adj[:, shutdown] = False
    pair_off = force_field.contact_pair_off
    if pair_off is not None:
        i, j = np.asarray(pair_off).T
        adj[i, j] = False
        adj[j, i] = False
    pair_on = force_field.contact_pair_on
    if pair_on is not None:
        i, j = np.asarray(pair_on).T
        if (i == j).any():
            raise ValueError(
                "Cannot turn on interaction of an atom with itself"
            )
        adj[i, j] = True
        adj[j, i] = True
    return adj


def _host_pairs(coord, force_field, use_cell_list):
    adj = _host_adjacency(coord, force_field, use_cell_list)
    atom_i, atom_j = np.where(adj)
    pairs = np.stack([atom_i, atom_j], axis=1)
    disp = coord[atom_j] - coord[atom_i]
    sq_dist = np.einsum("ij,ij->i", disp, disp)
    return pairs, disp, sq_dist


def _host_kirchhoff(coord, force_field, use_cell_list):
    pairs, _, sq_dist = _host_pairs(coord, force_field, use_cell_list)
    constants = force_field.force_constant(pairs[:, 0], pairs[:, 1], sq_dist)
    kirchhoff = np.zeros((len(coord), len(coord)))
    kirchhoff[pairs[:, 0], pairs[:, 1]] = -np.asarray(constants)
    np.fill_diagonal(kirchhoff, -np.sum(kirchhoff, axis=0))
    return kirchhoff, pairs


def _host_hessian(coord, force_field, use_cell_list):
    pairs, disp, sq_dist = _host_pairs(coord, force_field, use_cell_list)
    constants = np.asarray(
        force_field.force_constant(pairs[:, 0], pairs[:, 1], sq_dist)
    )
    n = len(coord)
    blocks = np.zeros((n, n, 3, 3))
    blocks[pairs[:, 0], pairs[:, 1]] = (
        -(constants / sq_dist)[:, None, None]
        * np.einsum("ka,kb->kab", disp, disp)
    )
    idx = np.arange(n)
    blocks[idx, idx] = -blocks.sum(axis=0)
    return blocks.transpose(0, 2, 1, 3).reshape(3 * n, 3 * n), pairs
