"""
Elastic networks and their ANM Hessians in float64, from the models'
definitions alone.

ANM (Atilgan et al. 2001, Biophys J 80:505): atoms i != j joined by a
spring of constant k_ij when their distance is within the cutoff; the
3 x 3 block of the Hessian is ``H_ij = -k_ij d d^T / |d|^2`` with ``d =
r_i - r_j``, and ``H_ii = -sum_j H_ij``.  The Hessian here is in the
xyz plane layout, row ``a n + i`` for component ``a`` of atom ``i``.

Force fields:

* ``invariant``: ``k = 1`` within ``cutoff_A``;
* ``sd_enm`` (Dehouck & Mikhailov 2013, PLoS Comput Biol 9:e1003209):
  ``k`` by residue-type pair and distance bin, read from the frozen
  tables under ``data/`` and scaled by ``10 R T`` at 300 K; bonded
  neighbours (the next residue of the same chain) take ``43.52 x 10 R
  T`` in every bin; zero beyond the last bin edge.  A pair's bin is the
  number of bin edges strictly below its distance.

Which pairs interact, and in which sdENM bin, is decided on squared
distances with every operation rounded to float32, ``((dx dx + dy dy) +
dz dz)`` from the float32 coordinates as given: the network that a
float32 program sees.  Everything else is float64.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

#: Row and column order of the sdENM tables (the header of ``sd_enm.csv``).
SD_ENM_ORDER = ("ALA", "CYS", "ASP", "GLU", "PHE", "GLY", "HIS", "ILE",
                "LYS", "LEU", "MET", "ASN", "PRO", "GLN", "ARG", "SER",
                "THR", "VAL", "TRP", "TYR")
#: 10 R T at 300 K in kJ/mol: the unit of the published sdENM constants.
SD_ENM_SCALE = 0.0083144621 * 300 * 10
SD_ENM_BONDED = 43.52 * SD_ENM_SCALE


class Network:
    """The springs of one force field over one chain of atoms: `field`
    the configuration's ``force_field`` object, and for a tabulated
    family the residue names, chain IDs and residue IDs of the atoms."""

    def __init__(self, field, res_name=None, chain_id=None, res_id=None):
        self.family = field["family"]
        if self.family == "invariant":
            self.cutoff_sq = float(field["cutoff_A"]) ** 2
            return
        if self.family != "sd_enm":
            raise ValueError(f"no reference for force field "
                             f"{self.family!r}")
        table = np.loadtxt(os.path.join(DATA, "sd_enm.csv"), delimiter=",")
        self.table = table.reshape(-1, 20, 20) * SD_ENM_SCALE
        edges = np.loadtxt(os.path.join(DATA, "d_enm_edges.csv"))
        self.edges_sq = edges.astype(np.float64) ** 2
        self.cutoff_sq = float(self.edges_sq[-1])
        order = {name: i for i, name in enumerate(SD_ENM_ORDER)}
        self.types = np.array([order[name] for name in res_name])
        _, self.chain = np.unique(np.asarray(chain_id), return_inverse=True)
        self.res_id = np.asarray(res_id, dtype=np.int64)

    def constants(self, sq):
        """Spring constants ``(..., n, n)`` float64 for the squared
        distances `sq` between the `n` atoms; zero on the atom itself and
        beyond the cutoff."""
        dev = sq.device
        n = sq.shape[-1]
        i = torch.arange(n, device=dev)[:, None]
        j = torch.arange(n, device=dev)[None, :]
        within = (sq <= self.cutoff_sq) & (i != j)
        if self.family == "invariant":
            return within.to(torch.float64)
        edges = torch.as_tensor(self.edges_sq, device=dev)
        bins = torch.searchsorted(edges, sq.contiguous()).clamp_(
            max=self.table.shape[0] - 1)
        types = torch.as_tensor(self.types, device=dev)
        table = torch.as_tensor(self.table, device=dev)
        k = table[bins, types[i], types[j]]
        chain = torch.as_tensor(self.chain, device=dev)
        res = torch.as_tensor(self.res_id, device=dev)
        bonded = ((j - i).abs() == 1) & (chain[i] == chain[j]) \
            & ((res[j] - res[i]).abs() == 1)
        k = torch.where(bonded, torch.full_like(k, SD_ENM_BONDED), k)
        return torch.where(within, k, torch.zeros_like(k))


def _sq32(c32):
    """Squared distances with every operation rounded to float32, in the
    order ``(dx dx + dy dy) + dz dz``."""
    d = c32[..., :, None, :] - c32[..., None, :, :]
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return ((x * x + y * y) + z * z).to(torch.float64)


def hessian_xyz(coord, network):
    """The float64 ANM Hessian ``(..., 3n, 3n)`` in the xyz plane layout
    of float32 coordinates `coord` ``(..., n, 3)`` (a tensor; the result
    lies on its device)."""
    c32 = coord.to(torch.float32)
    c64 = c32.to(torch.float64)
    n = c32.shape[-2]
    d = c64[..., :, None, :] - c64[..., None, :, :]
    sq = (d * d).sum(dim=-1)
    k = network.constants(_sq32(c32))
    g = k / torch.where(sq == 0, torch.ones_like(sq), sq)
    idx = torch.arange(n, device=c32.device)
    h = torch.zeros(c32.shape[:-2] + (3 * n, 3 * n), dtype=torch.float64,
                    device=c32.device)
    for a in range(3):
        for b in range(3):
            block = -g * d[..., a] * d[..., b]
            h[..., a * n:(a + 1) * n, b * n:(b + 1) * n] = block
            h[..., a * n + idx, b * n + idx] = -block.sum(dim=-1)
    return h


def rigid_basis(coord):
    """Orthonormal basis ``(..., 3n, 6)`` (xyz layout, float64) of the
    translations and the rotations about the centroid of `coord`."""
    c = coord.to(torch.float64)
    c = c - c.mean(dim=-2, keepdim=True)
    x, y, z = c[..., 0], c[..., 1], c[..., 2]
    one, zero = torch.ones_like(x), torch.zeros_like(x)
    cols = [(one, zero, zero), (zero, one, zero), (zero, zero, one),
            (zero, -z, y), (z, zero, -x), (-y, x, zero)]
    t = torch.stack([torch.cat(col, dim=-1) for col in cols], dim=-1)
    return torch.linalg.qr(t)[0]


def bfactor_from_msf(msf):
    """``B = 8 pi^2 MSF / 3``."""
    return (8 * math.pi ** 2 / 3) * msf
