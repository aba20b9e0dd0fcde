"""
The public names of the JAX package's assembly-kernel module,
``springcraft_tpu/ops/pallas_kernels.py``, over the port's kernels.

This module holds no kernel of its own.  Each name keeps the JAX
signature and defaults, with a torch `dtype` and an added `device=`, and
calls a wrapper of :mod:`.assembly_kernels`: a CUDA tensor launches its
kernel (float32; anything else raises), a CPU tensor runs its plain
version, and nothing falls back from one to the other.  The TPU plans
``tile=``, ``interpret=`` and ``batch_inner=`` are not carried over: the
port's kernels tile by warps and read column atoms from device memory at
any number of atoms.

* :func:`hessian_pallas` — one structure's xyz Hessian (K5,
  ``csrc/hessian_planes.cu`` through ``hessian_xyz_ensemble``).
* :func:`kirchhoff_pallas` — one structure's Kirchhoff matrix (K6,
  ``csrc/kirchhoff.cu`` through ``kirchhoff_ensemble``).
* :func:`hessian_pallas_ensemble` — a batch's xyz Hessians (K5) or, with
  ``raw_planes=True``, their nine component planes (K1 through
  ``hessian_planes_ensemble``).
* :func:`kirchhoff_pallas_ensemble` — a batch's Kirchhoff matrices (K4).

Patch overlays go through the base family's kernel and the sparse
correction of :mod:`.assembly`, as in the JAX package.  The JAX names
``pair_constant_planes``, ``fused_prep_plan``, ``assembly_prep_plan``,
``regularize_stitch_pallas`` and ``assembly_stitch_pallas`` are TPU
layouts and VMEM plans; the port's prep kernels are
:func:`.assembly_kernels.regularize_stitch` and
:func:`.assembly_kernels.assembly_stitch`.
"""

from __future__ import annotations

import torch

from ..utils.config import as_tensor
from .assembly_kernels import (hessian_planes_ensemble, hessian_xyz_ensemble,
                               kirchhoff_ensemble)
from .ffparams import KERNEL_KINDS

__all__ = [
    "hessian_pallas",
    "kirchhoff_pallas",
    "hessian_pallas_ensemble",
    "kirchhoff_pallas_ensemble",
    "supports_params",
    "supports_ensemble",
]


def supports_params(params):
    """Whether the assembly kernels take `params`: the analytic families
    and ``table_compact``, with or without patch overlays (the JAX
    package's answer: its overlays must be concrete, which the port's
    always are); ``table_pair`` is refused."""
    return params.kind in KERNEL_KINDS


def supports_ensemble(params, n, max_plane_bytes=2 * 1024**3):
    """Whether :func:`hessian_pallas_ensemble` takes `params` at `n`
    atoms: wherever :func:`supports_params` holds.

    The JAX package answers ``True`` only for ``table_compact`` whose
    precomputed pair-constant planes fit `max_plane_bytes`, because its
    TPU kernel cannot gather from a table; the port's kernels look the
    constants up per pair, need no planes and take every family at any
    `n`, so `n` and `max_plane_bytes` do not change the answer.  It is
    ``True`` wherever the JAX answer is."""
    return supports_params(params)


def _check(params):
    if not supports_params(params):
        raise ValueError(
            f"Pallas path does not support kind={params.kind!r} "
            f"with overlays={bool(params.overlays)}")


def _coords(coords, dtype, device, ndim):
    coords = as_tensor(coords, dtype, device)
    if coords.ndim != ndim or coords.shape[-1] != 3:
        shape = "(n, 3)" if ndim == 2 else "(B, n, 3)"
        raise ValueError(f"coordinates must be {shape}, got "
                         f"{tuple(coords.shape)}")
    return coords.contiguous()


def hessian_pallas(coord, params, dtype=torch.float32, device=None):
    """
    One structure's ANM Hessian, assembled by K5.

    Parameters
    ----------
    coord : Tensor or ndarray, shape=(n, 3)
    params : FFParams
        Must satisfy :func:`supports_params`.
    dtype : torch.dtype
        float32 on CUDA; any float dtype on the CPU (the plain version).
    device : optional
        Where a numpy `coord` goes (default: the current CUDA device); a
        tensor stays where it lies.

    Returns
    -------
    hessian : Tensor, shape=(3n, 3n), dtype
        xyz plane layout: ``H[a n + p, b n + q]``.
    """
    _check(params)
    coord = _coords(coord, dtype, device, 2)
    return hessian_xyz_ensemble(coord[None], params)[0]


def kirchhoff_pallas(coord, params, dtype=torch.float32, device=None):
    """One structure's GNM Kirchhoff matrix ``(n, n)``, assembled by K6
    (arguments as :func:`hessian_pallas`)."""
    _check(params)
    coord = _coords(coord, dtype, device, 2)
    return kirchhoff_ensemble(coord[None], params)[0]


def hessian_pallas_ensemble(coords, params, dtype=torch.float32,
                            device=None, raw_planes=False):
    """
    The ANM Hessians of a conformer batch sharing one parameter set,
    ``(B, n, 3) -> (B, 3n, 3n)`` in xyz plane layout (K5).

    ``raw_planes=True`` returns instead the nine ``(B, n, n)`` component
    planes as a list, ``planes[3 a + b][:, p, q] == H[:, a n + p, b n +
    q]`` (K1).  The JAX package pads each plane to its tile; the port's
    planes are ``n`` wide.  Refused with patch overlays, whose correction
    applies to the assembled matrix.
    """
    _check(params)
    coords = _coords(coords, dtype, device, 3)
    if not raw_planes:
        return hessian_xyz_ensemble(coords, params)
    if params.overlays:
        raise ValueError(
            "raw_planes=True is unsupported with patch overlays — the "
            "sparse overlay correction applies to the assembled matrix")
    return list(hessian_planes_ensemble(coords, params))


def kirchhoff_pallas_ensemble(coords, params, dtype=torch.float32,
                              device=None):
    """The GNM Kirchhoff matrices of a conformer batch, ``(B, n, 3) ->
    (B, n, n)`` (K4; arguments as :func:`hessian_pallas_ensemble`)."""
    _check(params)
    coords = _coords(coords, dtype, device, 3)
    return kirchhoff_ensemble(coords, params)
