"""
Sparse pair lists and float64 pair-list operator applies.

Counterpart of ``springcraft_tpu/ops/pairs.py:43-169``: the float64
refinement of :mod:`.modes` applies the Hessian or Kirchhoff operator of
a force field with a cutoff from its pair list, at O(pairs * k) work
instead of streaming dense row panels.

* :func:`neighbor_pairs` — every pair ``i < j`` within the cutoff, by a
  ``scipy.spatial.cKDTree`` search on the host (the JAX package's
  fallback; its native C++ cell list is not carried over);
* :func:`pair_force_constants` — final per-pair constants, the patch
  overlays' value pipeline included;
* :func:`pair_list` — the cutoff pairs with the overlays' switched-on
  pairs added and switched-off pairs removed, and their constants;
* :func:`hessian_apply_pairs` / :func:`kirchhoff_apply_pairs` — ``H @ V``
  and ``K @ V`` as ``index_add_`` scatters over the pairs, on the device
  of their tensors.

The pair search and the overlays' masks are host numpy; the constants
and the applies are tensors on the coordinates' device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.config import as_tensor
from .ffparams import (_within_cutoff, pair_base_constants, squared_norm,
                       strip_overlays)

__all__ = [
    "neighbor_pairs",
    "pair_force_constants",
    "pair_list",
    "hessian_apply_pairs",
    "kirchhoff_apply_pairs",
]


def neighbor_pairs(coord, cutoff):
    """All atom pairs ``(i, j)`` with ``i < j`` and ``d(i, j) <=
    cutoff``, as two int64 numpy arrays in lexicographic order (``d^2 <=
    cutoff^2`` inclusive, as the dense adjacency)."""
    from scipy.spatial import cKDTree

    coord = np.ascontiguousarray(
        coord.detach().cpu().numpy() if isinstance(coord, torch.Tensor)
        else coord, dtype=np.float64)
    pairs = cKDTree(coord).query_pairs(float(cutoff), output_type="ndarray")
    if pairs.size == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    i = np.minimum(pairs[:, 0], pairs[:, 1]).astype(np.int64)
    j = np.maximum(pairs[:, 0], pairs[:, 1]).astype(np.int64)
    order = np.lexsort((j, i))
    return i[order], j[order]


def pair_force_constants(i, j, sq, params):
    """Final constants of the pairs `i`, `j` (int64 tensors ``(P,)``) at
    squared distances `sq` ``(P,)``: the base family, then each overlay's
    value pipeline (reference ``forcefield.py:188-223``).  The caller
    owns the pair set (see :func:`pair_list`)."""
    k = pair_base_constants(i, j, sq, strip_overlays(params))
    if params.overlays:
        dev = params.device_overlays(sq.device, sq.dtype)
        for has_value, values in dev["layers"]:
            k = torch.where(_within_cutoff(sq, params), k,
                            torch.zeros_like(k))
            k = torch.where(has_value[i, j], values[i, j], k)
    return k


def pair_list(coord, params, pairs=None, device=None):
    """The sparse interaction set of a force field with a cutoff: pair
    indices ``(i, j)``, ``i < j``, and their float64 constants, as
    tensors on the device of `coord` (a numpy `coord` goes to `device`,
    by default the current CUDA device).  The overlays apply in the
    reference order: all switched-off pairs out, then all switched-on
    pairs in, even beyond the cutoff (``interaction.py:193-213``).
    `pairs` injects a precomputed cutoff pair set."""
    if not params.has_cutoff:
        raise ValueError(
            "pair_list needs a force field with a finite cutoff; "
            "no-cutoff families interact densely")
    coord = as_tensor(coord, torch.float64, device)
    n = coord.shape[0]
    params._check_atoms(n)
    if pairs is None:
        i, j = neighbor_pairs(coord, float(np.sqrt(params.cutoff_sq)))
    else:
        i, j = (np.asarray(torch.as_tensor(p).cpu(), np.int64)
                for p in pairs)
    if params.overlays:
        on_any = np.logical_or.reduce([o.on_mask for o in params.overlays])
        off_any = np.logical_or.reduce([o.off_mask
                                        for o in params.overlays])
        extra_i, extra_j = np.nonzero(np.triu(on_any, 1))
        if len(extra_i):
            cat_i = np.concatenate([i, extra_i.astype(np.int64)])
            cat_j = np.concatenate([j, extra_j.astype(np.int64)])
            _, first = np.unique(cat_i * n + cat_j, return_index=True)
            i, j = cat_i[np.sort(first)], cat_j[np.sort(first)]
        keep = ~off_any[i, j] | on_any[i, j]
        i, j = i[keep], j[keep]
    i = torch.as_tensor(i, device=coord.device)
    j = torch.as_tensor(j, device=coord.device)
    sq = squared_norm(coord[i] - coord[j])
    return i, j, pair_force_constants(i, j, sq, params)


def hessian_apply_pairs(coord, i, j, g, v):
    """ANM Hessian apply from a pair list, ``(H v)_i = sum_j g_ij d_ij
    (d_ij . (v_i - v_j))`` with ``g = k / d^2`` per pair and `v` ``(n, 3,
    k)``, in the dtype of `v` on its device."""
    disp = coord[i] - coord[j]                              # (P, 3)
    s = torch.einsum("pd,pdk->pk", disp, v[i] - v[j])       # (P, k)
    t = g[:, None, None] * disp[:, :, None] * s[:, None, :]
    out = torch.zeros_like(v)
    out.index_add_(0, i, t)
    out.index_add_(0, j, -t)
    return out


def kirchhoff_apply_pairs(i, j, k_vals, n, v):
    """Kirchhoff apply from a pair list, ``(K v)_i = sum_j k_ij (v_i -
    v_j)``, `v` ``(n, k)``."""
    if v.shape[0] != n:
        raise ValueError(f"v has {v.shape[0]} rows, expected {n}")
    t = k_vals[:, None] * (v[i] - v[j])
    out = torch.zeros_like(v)
    out.index_add_(0, i, t)
    out.index_add_(0, j, -t)
    return out
