"""
Elastic-network sanity checks (host side, numpy only).

The port's own copy of ``springcraft_tpu/utils/network.py``.  The fast
covariance and shift-invert paths assume the interaction network is
*connected* (null space exactly the rigid-body modes); these helpers let
callers verify that before trusting those paths.
"""

from __future__ import annotations

import numpy as np

__all__ = ["connected_components", "is_connected"]


def connected_components(adjacency):
    """
    Component label per node for a boolean adjacency matrix
    (union-find).

    Returns
    -------
    labels : ndarray, shape=(n,), dtype=int
        0-based component ids.
    count : int
        Number of connected components.
    """
    adjacency = np.asarray(adjacency, dtype=bool)
    n = adjacency.shape[0]
    parent = np.arange(n)

    def find(i):
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:
            parent[i], i = root, parent[i]
        return root

    rows, cols = np.where(np.triu(adjacency, k=1))
    for i, j in zip(rows, cols):
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[rj] = ri

    roots = np.array([find(i) for i in range(n)])
    _, labels = np.unique(roots, return_inverse=True)
    return labels, int(labels.max()) + 1 if n else 0


def is_connected(coord, cutoff):
    """
    Whether all atoms form one elastic network at the given cutoff —
    the precondition of the analytic-null-space fast paths
    (:mod:`..ops.rigid`, :mod:`..ops.modes`).
    """
    coord = np.asarray(coord, dtype=np.float64)
    diff = coord[:, None, :] - coord[None, :, :]
    adjacency = np.einsum("ijk,ijk->ij", diff, diff) <= float(cutoff) ** 2
    np.fill_diagonal(adjacency, False)
    _, count = connected_components(adjacency)
    return count == 1
