"""
Dense batched ANM Hessian assembly in the xyz plane layout.

Counterpart of ``springcraft_tpu/ops/assembly.py:43-181`` for the
analytic families.  :func:`hessian_planes_plain` is the plain PyTorch
version of the assembly kernel (``csrc/hessian_planes.cu``, wrapped by
:func:`.assembly_kernels.hessian_planes_ensemble`) and follows its
arithmetic: valid pairs are ``p != q`` within the cutoff,
``g = -k / sq`` (``sq == 0`` guarded), ``plane = (g d_a) d_b``, and the
diagonal is the negated row sum.
"""

from __future__ import annotations

import torch

from .ffparams import analytic_constants

__all__ = [
    "hessian_planes_plain",
    "hessian_xyz_plain",
    "planes_to_xyz",
]


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
    n = coords.shape[-2]
    disp = [coords[..., :, None, a] - coords[..., None, :, a]
            for a in range(3)]
    sq = disp[0] * disp[0] + disp[1] * disp[1] + disp[2] * disp[2]
    eye = torch.eye(n, dtype=torch.bool, device=coords.device)
    valid = ~eye
    if params.has_cutoff:
        valid = valid & (sq <= torch.as_tensor(params.cutoff_sq,
                                               dtype=sq.dtype))
    k = torch.where(valid, analytic_constants(params.kind, sq),
                    torch.zeros_like(sq))
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
    """Dense ``(B, 3n, 3n)`` xyz-layout Hessians of a conformer batch
    (any float dtype; the f64 reference engine assembles here)."""
    return planes_to_xyz(hessian_planes_plain(coords, params))
