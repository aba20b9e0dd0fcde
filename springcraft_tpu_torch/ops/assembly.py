"""
Dense batched ANM Hessian (xyz plane layout) and GNM Kirchhoff assembly.

Counterpart of ``springcraft_tpu/ops/assembly.py:43-181, 266-307`` for
the analytic and the tabulated families, with or without patch overlays
(spring constants from :func:`.ffparams.force_constants`: an analytic
rule or a table lookup, then the overlays' adjacency and value
pipeline).  These are the plain PyTorch versions of the assembly
kernels (wrapped in :mod:`.assembly_kernels`) and follow their
arithmetic: valid pairs are ``p != q`` within the cutoff; the Hessian
has ``g = -k / sq`` (``sq == 0`` guarded), ``plane = (g d_a) d_b`` and
the negated row sum on the diagonal; the Kirchhoff matrix has ``-k`` off
the diagonal and the row sum of ``k`` on it.

:func:`overlay_correction_hessian_xyz` and
:func:`overlay_correction_kirchhoff` add the overlays' sparse correction
to matrices assembled for the base family, which is how the kernels
carry a ``PatchedForceField``.  They are scatters, not kernels, in the
JAX package too.
"""

from __future__ import annotations

import torch

from .ffparams import force_constants, overlay_pair_delta

__all__ = [
    "overlay_correction_hessian_xyz",
    "overlay_correction_kirchhoff",
    "kirchhoff_plain",
    "hessian_planes_plain",
    "hessian_xyz_plain",
    "planes_to_xyz",
]


def _pair_geometry(coords, params):
    """Displacements ``d_a = x_p,a - x_q,a``, squared distances and the
    masked spring constants ``(B, n, n)`` of a conformer batch."""
    disp = [coords[..., :, None, a] - coords[..., None, :, a]
            for a in range(3)]
    sq = disp[0] * disp[0] + disp[1] * disp[1] + disp[2] * disp[2]
    return disp, sq, force_constants(params, sq)


def kirchhoff_plain(coords, params):
    """Dense Kirchhoff matrices ``(B, n, n)`` of a conformer batch
    ``(B, n, 3)``, any float dtype (reference ``interaction.py:14-54``;
    plain version of :func:`.assembly_kernels.kirchhoff_ensemble`)."""
    _, _, k = _pair_geometry(coords, params)
    return torch.diag_embed(k.sum(dim=-1)) - k


def hessian_planes_plain(coords, params):
    """Nine Hessian component planes of a conformer batch.

    Parameters
    ----------
    coords : Tensor, shape=(B, n, 3)
    params : FFParams

    Returns
    -------
    planes : Tensor, shape=(9, B, n, n)
        ``planes[3 a + b][:, p, q] == H[:, a n + p, b n + q]`` with ``H``
        the xyz-layout Hessian.
    """
    disp, sq, k = _pair_geometry(coords, params)
    g = -k / torch.where(sq == 0, torch.ones_like(sq), sq)
    planes = torch.stack([(g * disp[a]) * disp[b]
                          for a in range(3) for b in range(3)])
    diag = planes.sum(dim=-1)                    # (9, B, n) row sums
    return planes - torch.diag_embed(diag)


def planes_to_xyz(planes):
    """``(9, B, n, n)`` component planes -> ``(B, 3n, 3n)`` xyz-layout
    matrices."""
    _, batch, n, _ = planes.shape
    return (planes.reshape(3, 3, batch, n, n).permute(2, 0, 3, 1, 4)
            .reshape(batch, 3 * n, 3 * n))


def hessian_xyz_plain(coords, params):
    """Dense ``(B, 3n, 3n)`` xyz-layout Hessians of a conformer batch,
    any float dtype (plain version of
    :func:`.assembly_kernels.hessian_xyz_ensemble`)."""
    return planes_to_xyz(hessian_planes_plain(coords, params))


def _scatter_pairs(matrix, rows, cols, values):
    """``matrix[..., rows, cols] += values`` in place for index tensors
    ``(Q,)`` that may repeat and `values` ``(..., Q)``.  Repeated entries
    accumulate in no fixed order."""
    m = matrix.shape[-1]
    flat = matrix.view(-1, m * m)
    flat.index_add_(1, rows * m + cols, values.reshape(flat.shape[0], -1))
    return matrix


def overlay_correction_hessian_xyz(hessian, coord, params):
    """Add the patch-overlay correction to xyz-layout Hessians
    ``(..., 3n, 3n)`` assembled for the base family of `params` on
    `coord` ``(..., n, 3)``: a scatter of 3 x 3 superelements over the
    pairs an overlay touches (``-g d d^T`` on both triangles, ``+g d
    d^T`` on the two diagonal blocks, ``g = delta / |d|^2``).  Adds in
    place to a contiguous `hessian` and returns it."""
    ii, jj, delta, disp, safe_sq = overlay_pair_delta(coord, params)
    if ii.numel() == 0:
        return hessian
    n = coord.shape[-2]
    g = delta / safe_sq
    rows, cols, values = [], [], []
    for a in range(3):
        for b in range(3):
            v = g * disp[..., a] * disp[..., b]
            rows += [a * n + ii, a * n + jj, a * n + ii, a * n + jj]
            cols += [b * n + jj, b * n + ii, b * n + ii, b * n + jj]
            values += [-v, -v, v, v]
    return _scatter_pairs(hessian, torch.cat(rows), torch.cat(cols),
                          torch.cat(values, dim=-1))


def overlay_correction_kirchhoff(kirchhoff, coord, params):
    """GNM twin of :func:`overlay_correction_hessian_xyz` for Kirchhoff
    matrices ``(..., n, n)``."""
    ii, jj, delta, _, _ = overlay_pair_delta(coord, params)
    if ii.numel() == 0:
        return kirchhoff
    return _scatter_pairs(
        kirchhoff, torch.cat([ii, jj, ii, jj]), torch.cat([jj, ii, ii, jj]),
        torch.cat([-delta, -delta, delta, delta], dim=-1))
