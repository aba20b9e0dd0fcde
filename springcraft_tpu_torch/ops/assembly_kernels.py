"""
Wrappers of the assembly and prep kernels, with their plain versions.

Counterpart of ``springcraft_tpu/ops/pallas_kernels.py:688-1040``
(ensemble Hessian assembly) and ``:1046-1165, 1344-1386`` (the
regularize/stitch prep).

* :func:`hessian_planes_ensemble` — kernel ``csrc/hessian_planes.cu``;
  plain version :func:`.assembly.hessian_planes_plain`.
* :func:`regularize_stitch` — kernel ``csrc/regularize_stitch.cu``;
  plain version :func:`regularize_stitch_plain`.

A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches its kernel (float32 only) or raises.  It never falls back
from one to the other.  ``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .. import _build
from .assembly import hessian_planes_plain, planes_to_xyz

__all__ = [
    "hessian_planes_ensemble",
    "regularize_stitch",
    "regularize_stitch_plain",
]

#: Largest conformer the assembly kernel stages in 48 KB of shared memory.
_MAX_ATOMS = 4096
_MAX_GRID_YZ = 65535


def hessian_planes_ensemble(coords, params):
    """Nine xyz Hessian component planes of a conformer batch,
    ``(B, n, 3) -> (9, B, n, n)`` (see
    :func:`.assembly.hessian_planes_plain` for the layout)."""
    if coords.ndim != 3 or coords.shape[-1] != 3:
        raise ValueError(f"coords must be (B, n, 3), got "
                         f"{tuple(coords.shape)}")
    if _build.route("hessian_planes_ensemble", coords) == "cpu":
        return hessian_planes_plain(coords, params)
    _build.require_cuda_f32("hessian_planes_ensemble", coords=coords)
    batch, n, _ = coords.shape
    if n > _MAX_ATOMS or batch > _MAX_GRID_YZ:
        raise ValueError(f"hessian_planes_ensemble: (B, n) = ({batch}, "
                         f"{n}) exceeds the kernel's limits (B <= "
                         f"{_MAX_GRID_YZ}, n <= {_MAX_ATOMS})")
    out = torch.empty((9, batch, n, n), dtype=torch.float32,
                      device=coords.device)
    _build.launch(
        "sc_hessian_planes", coords.device, coords.data_ptr(),
        out.data_ptr(), batch, n, params.kind_code,
        float(params.cutoff_sq) if params.has_cutoff else 0.0,
        int(params.has_cutoff))
    hessian_planes_ensemble.launches += 1
    return out


hessian_planes_ensemble.launches = 0


def regularize_stitch_plain(planes, scale_h, ts, mp):
    """Plain version of :func:`regularize_stitch`: concatenation,
    scaling, ``ts @ ts^T`` and an identity pad."""
    batch, m = scale_h.shape
    reg = (planes_to_xyz(planes) * scale_h[:, :, None]
           * scale_h[:, None, :] + ts @ ts.transpose(-1, -2))
    out = torch.zeros((batch, mp, mp), dtype=reg.dtype, device=reg.device)
    out[:, :m, :m] = reg
    idx = torch.arange(m, mp, device=reg.device)
    out[:, idx, idx] = 1.0
    return out


def regularize_stitch(planes, scale_h, ts, mp):
    """Identity-padded, regularized, equilibrated factor input from the
    raw Hessian planes:

        reg = S' H S' + ts ts^T   (top-left 3n x 3n),  I on the pad

    Parameters
    ----------
    planes : Tensor, shape=(9, B, n, n)
    scale_h : Tensor, shape=(B, 3n)
        Row/column scale ``S'`` (Jacobi scale with mass weights folded
        in).
    ts : Tensor, shape=(B, 3n, 6)
        Scaled null basis ``S T sqrt(sigma)``.
    mp : int
        Padded size, ``>= 3n``.

    Returns
    -------
    reg : Tensor, shape=(B, mp, mp)
    """
    if planes.ndim != 4 or planes.shape[0] != 9 \
            or planes.shape[-1] != planes.shape[-2]:
        raise ValueError(f"planes must be (9, B, n, n), got "
                         f"{tuple(planes.shape)}")
    _, batch, n, _ = planes.shape
    m = 3 * n
    if tuple(scale_h.shape) != (batch, m) \
            or tuple(ts.shape) != (batch, m, 6):
        raise ValueError(
            f"scale_h must be ({batch}, {m}) and ts ({batch}, {m}, 6), "
            f"got {tuple(scale_h.shape)} and {tuple(ts.shape)}")
    if mp < m:
        raise ValueError(f"mp={mp} must be >= 3n={m}")
    if _build.route("regularize_stitch", planes, scale_h, ts) == "cpu":
        return regularize_stitch_plain(planes, scale_h, ts, mp)
    _build.require_cuda_f32("regularize_stitch", planes=planes, scale_h=scale_h,
                      ts=ts)
    if mp > _MAX_GRID_YZ or batch > _MAX_GRID_YZ:
        raise ValueError(f"regularize_stitch: (B, mp) = ({batch}, {mp}) "
                         f"exceeds the kernel's grid limit {_MAX_GRID_YZ}")
    out = torch.empty((batch, mp, mp), dtype=torch.float32,
                      device=planes.device)
    _build.launch("sc_regularize_stitch", planes.device, planes.data_ptr(),
                  scale_h.data_ptr(), ts.data_ptr(), out.data_ptr(), batch,
                  n, mp)
    regularize_stitch.launches += 1
    return out


regularize_stitch.launches = 0
