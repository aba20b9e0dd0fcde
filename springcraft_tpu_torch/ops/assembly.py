"""
Dense batched ANM Hessian (xyz plane layout) and GNM Kirchhoff assembly.

Counterpart of ``springcraft_tpu/ops/assembly.py:43-181`` for the
analytic and the tabulated families (spring constants from
:func:`.ffparams.base_constants`: an analytic rule or a table lookup).
These are the plain PyTorch versions of the assembly
kernels (wrapped in :mod:`.assembly_kernels`) and follow their
arithmetic: valid pairs are ``p != q`` within the cutoff; the Hessian
has ``g = -k / sq`` (``sq == 0`` guarded), ``plane = (g d_a) d_b`` and
the negated row sum on the diagonal; the Kirchhoff matrix has ``-k`` off
the diagonal and the row sum of ``k`` on it.
"""

from __future__ import annotations

import torch

from .ffparams import base_constants

__all__ = [
    "kirchhoff_plain",
    "hessian_planes_plain",
    "hessian_xyz_plain",
    "planes_to_xyz",
]


def _pair_geometry(coords, params):
    """Displacements ``d_a = x_p,a - x_q,a``, squared distances and the
    masked spring constants ``(B, n, n)`` of a conformer batch."""
    n = coords.shape[-2]
    disp = [coords[..., :, None, a] - coords[..., None, :, a]
            for a in range(3)]
    sq = disp[0] * disp[0] + disp[1] * disp[1] + disp[2] * disp[2]
    valid = ~torch.eye(n, dtype=torch.bool, device=coords.device)
    if params.has_cutoff:
        valid = valid & (sq <= torch.as_tensor(params.cutoff_sq,
                                               dtype=sq.dtype))
    k = torch.where(valid, base_constants(params, sq),
                    torch.zeros_like(sq))
    return disp, sq, k


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
