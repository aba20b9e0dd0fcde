"""
The general generator: every input of a run made from its seed, by the
parameters of the configuration's ``structure`` object.

Atoms are drawn uniformly in a cube at CA density (``ca_per_A3``: the
JAX package's benchmark draws 300 CA atoms in a 34 A cube), then every
atom with fewer than ``min_neighbours`` others within
``neighbour_radius_A`` is drawn again, until none is: a protein's CA
atom is never alone, and a lone atom of a uniform draw (in a corner, at
an edge) makes a network that is nearly or wholly disconnected, whose
pseudo-inverse no float32 program can give.  The residue names of the
structure are drawn uniformly from the 20 amino acids, on ``chains``
equal runs of the array with consecutive residue IDs.  Conformers are
the drawn positions plus an independent Gaussian displacement of
``jitter_A`` per coordinate.

Seeds go to NumPy's PCG64 (``default_rng``), which takes any
non-negative integer; positions, names and displacements are drawn in
that order, float32 where the program reads float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: Residue names in the order the synthetic assemblies draw them.
AA20 = ("ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS",
        "ILE", "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP",
        "TYR", "VAL")
#: Rounds of redrawing lone atoms before the draw is given up.
MAX_ROUNDS = 1000


@dataclasses.dataclass
class Structures:
    """``coords`` ``(count, n, 3)`` float32 conformers of one structure
    and its per-atom annotations."""

    coords: np.ndarray
    res_name: np.ndarray
    chain_id: np.ndarray
    res_id: np.ndarray


def _positions(rng, n, side, min_neighbours, radius):
    from scipy.spatial import cKDTree

    base = rng.random((n, 3)) * side
    for _ in range(MAX_ROUNDS):
        counts = cKDTree(base).query_ball_point(
            base, radius, return_length=True) - 1
        lone = np.flatnonzero(counts < min_neighbours)
        if lone.size == 0:
            return base
        base[lone] = rng.random((lone.size, 3)) * side
    raise RuntimeError(f"no structure of {n} atoms with {min_neighbours} "
                       f"neighbours within {radius} A each")


def conformers(spec, seed, count):
    """`count` conformers of the structure `spec` (the configuration's
    ``structure`` object: ``n_atoms``, ``ca_per_A3``,
    ``min_neighbours``, ``neighbour_radius_A``, ``jitter_A``,
    ``chains``), drawn from `seed`."""
    rng = np.random.default_rng(seed)
    n = int(spec["n_atoms"])
    side = (n / float(spec["ca_per_A3"])) ** (1 / 3)
    base = _positions(rng, n, side, int(spec["min_neighbours"]),
                      float(spec["neighbour_radius_A"])).astype(np.float32)
    res_name = np.array(AA20)[rng.integers(0, 20, n)]
    chains = int(spec.get("chains", 1))
    chain_id = np.array(list("ABCDEFGH"))[np.arange(n) * chains // n]
    jitter = np.float32(spec["jitter_A"])
    coords = base[None] + rng.standard_normal((count, n, 3),
                                              dtype=np.float32) * jitter
    return Structures(coords, res_name, chain_id, np.arange(1, n + 1))
