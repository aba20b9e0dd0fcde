"""
Spatial cell-list neighbour search, numpy only.

The port's own copy of the numpy path of
``springcraft_tpu/structure/celllist.py``: the API subset of
``biotite.structure.CellList`` that the reference uses
(``interaction.py:155-159``, ``test_forcefield.py:270-272``),
construction from coordinates and a cell size, and
``create_adjacency_matrix(cutoff)``.  It gives exactly the brute-force
adjacency ``d^2(i, j) <= cutoff^2`` (self-contacts included; callers
clear the diagonal), the dense mask of the assembly.  The JAX package's
native C++ cell list (``springcraft_tpu/_native``) is not ported: its
numpy fallback, this module, gives the same adjacency.
"""

from __future__ import annotations

import numpy as np

from .atoms import coord as as_coord

__all__ = ["CellList"]

#: Up to this many atoms the adjacency is one brute-force distance mask.
BRUTE_FORCE_MAX = 2048


class CellList:
    """
    Cell list over a set of coordinates.

    Parameters
    ----------
    atoms : AtomArray or ndarray, shape=(n,3)
        The atoms or coordinates.
    cell_size : float
        Edge length of the grid cells.  Should equal the maximum
        interaction distance queried later.
    """

    def __init__(self, atoms, cell_size):
        self._coord = np.asarray(as_coord(atoms), dtype=np.float64)
        if cell_size <= 0:
            raise ValueError("Cell size must be greater than 0")
        self._cell_size = float(cell_size)

    def create_adjacency_matrix(self, threshold_distance):
        """
        Boolean ``(n, n)`` matrix marking atom pairs with
        ``distance <= threshold_distance`` (diagonal included).
        """
        if threshold_distance > self._cell_size:
            raise ValueError(
                "Threshold distance must not exceed the cell size"
            )
        coord = self._coord
        n = len(coord)
        sq_cutoff = threshold_distance * threshold_distance
        if n <= BRUTE_FORCE_MAX:
            diff = coord[:, None, :] - coord[None, :, :]
            return np.einsum("ijk,ijk->ij", diff, diff) <= sq_cutoff

        # grid buckets of the threshold's edge; each atom against the 27
        # cells around its own
        lo = coord.min(axis=0)
        cell_idx = np.floor((coord - lo) / threshold_distance).astype(
            np.int64)
        dims = cell_idx.max(axis=0) + 1
        flat = (cell_idx[:, 0] * dims[1] + cell_idx[:, 1]) * dims[2] \
            + cell_idx[:, 2]
        order = np.argsort(flat, kind="stable")
        starts = np.searchsorted(flat[order], np.arange(dims.prod() + 1))

        adj = np.zeros((n, n), dtype=bool)
        for i in range(n):
            ci = cell_idx[i]
            neighbors = []
            for dx in (-1, 0, 1):
                if not 0 <= ci[0] + dx < dims[0]:
                    continue
                for dy in (-1, 0, 1):
                    if not 0 <= ci[1] + dy < dims[1]:
                        continue
                    for dz in (-1, 0, 1):
                        if not 0 <= ci[2] + dz < dims[2]:
                            continue
                        c = int(flat[i]) + (dx * dims[1] + dy) * dims[2] + dz
                        neighbors.append(order[starts[c]:starts[c + 1]])
            cand = np.concatenate(neighbors)
            d = coord[cand] - coord[i]
            adj[i, cand[np.einsum("ij,ij->i", d, d) <= sq_cutoff]] = True
        return adj
