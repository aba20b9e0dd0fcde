"""
Analytic null space and the regularized pseudo-inverse covariance.

Counterpart of ``springcraft_tpu/ops/rigid.py`` (main-path subset).  For
a connected network with orthonormal null basis ``T`` and any
``sigma > 0``,

    pinv(H) = (H + sigma T T^t)^-1 - T T^t / sigma,

so the covariance comes from an SPD inverse.  Everything here is
batched over a leading conformer axis (the JAX package vmaps).

Two engines give the plane traces
``traces[i, j] = sum_a pinv(H)[a n + i, a n + j]`` that the fluctuation
observables consume:

* ``"blocked"`` — the divide-and-conquer inverse factor of
  :mod:`.spd_linalg` (panel-inverse kernel at the leaves) and blockwise
  Gram products; fed from the raw Hessian planes through the
  regularize/stitch kernel on the main path
  (:func:`covariance_plane_traces_from_planes`);
* ``"cho_solve"`` — ``torch.linalg.cholesky`` plus a triangular solve,
  any dtype: the port's own float64 reference.

A network with a null space beyond ``T`` (disconnected, collinear) makes
the regularized matrix singular; both engines then give non-finite
output by design.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import spd_linalg
from .assembly_kernels import regularize_stitch

__all__ = [
    "rigid_modes_anm",
    "null_mode_gnm",
    "covariance_plane_traces",
    "covariance_plane_traces_from_planes",
]


def rigid_modes_anm(coords, masses=None):
    """Orthonormal xyz-layout basis ``(..., 3n, 6)`` of the six rigid-body
    modes (translations, rotations about the centroid) of conformers
    ``(..., n, 3)``; with `masses` the modes of the mass-weighted
    Hessian ``W H W`` (scaled by ``sqrt(m)``)."""
    n = coords.shape[-2]
    centered = coords - coords.mean(dim=-2, keepdim=True)
    x, y, z = centered[..., 0], centered[..., 1], centered[..., 2]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    modes = torch.stack([
        torch.stack([one, zero, zero], dim=-2),     # Tx
        torch.stack([zero, one, zero], dim=-2),     # Ty
        torch.stack([zero, zero, one], dim=-2),     # Tz
        torch.stack([zero, -z, y], dim=-2),         # Rx
        torch.stack([z, zero, -x], dim=-2),         # Ry
        torch.stack([-y, x, zero], dim=-2),         # Rz
    ], dim=-1)                                      # (..., 3, n, 6)
    if masses is not None:
        modes = modes * torch.sqrt(masses)[:, None]
    q, _ = torch.linalg.qr(modes.reshape(modes.shape[:-3] + (3 * n, 6)))
    return q


def null_mode_gnm(n, masses=None, dtype=torch.float32, device=None):
    """Orthonormal null vector ``(n, 1)`` of a connected GNM Kirchhoff
    matrix, mass-scaled for a mass-weighted one."""
    if masses is not None:
        device = masses.device
    if device is None:
        raise ValueError("null_mode_gnm needs device= (or masses)")
    v = torch.ones((n, 1), dtype=dtype, device=device)
    if masses is not None:
        v = v * torch.sqrt(masses.to(dtype))[:, None]
    return v / torch.linalg.norm(v)


def _equilibration(diag_m, t):
    """``(scale, sigma, ts)`` of the null-space-regularized Jacobi
    equilibration with ``sigma`` the mean of the diagonal:
    ``scale = (diag + sigma |t_row|^2)^-1/2`` and
    ``ts = t * scale sqrt(sigma)``."""
    sigma = diag_m.mean(dim=-1)[..., None, None]
    tn2 = (t * t).sum(dim=-1)
    scale = torch.rsqrt(diag_m + sigma[..., 0] * tn2)
    ts = t * (scale * torch.sqrt(sigma[..., 0]))[..., None]
    return scale, sigma, ts


def _regularize_equilibrated(matrix, t, pad_to=None):
    """``reg = S (M + sigma T T^t) S`` with ``S = diag(reg)^-1/2`` from
    the analytic diagonal, optionally identity-padded to ``pad_to``.
    Returns ``(reg, scale, sigma)``; ``scale`` stays unpadded."""
    m = matrix.shape[-1]
    diag_m = torch.diagonal(matrix, dim1=-2, dim2=-1)
    scale, sigma, ts = _equilibration(diag_m, t)
    reg = (matrix * scale[..., :, None] * scale[..., None, :]
           + ts @ ts.transpose(-1, -2))
    if pad_to is not None and pad_to != m:
        reg = F.pad(reg, (0, pad_to - m, 0, pad_to - m))
        idx = torch.arange(m, pad_to, device=reg.device)
        reg[..., idx, idx] = 1.0
    return reg, scale, sigma


def stitch_inputs(planes, t, masses=None):
    """Everything the regularize/stitch kernel needs besides the planes:
    ``(scale, sigma, scale_h, ts)``.  ``scale`` un-scales the inverse
    factor downstream; ``scale_h = scale * w`` folds the mass weights
    ``w = 1 / sqrt(m)`` of ``M' = W H W`` into the kernel's row and
    column scale."""
    n = planes.shape[-1]
    diag_m = torch.cat([torch.diagonal(planes[4 * a], dim1=-2, dim2=-1)
                        for a in range(3)], dim=-1)          # (B, 3n)
    w_xyz = None
    if masses is not None:
        w_xyz = (1.0 / torch.sqrt(masses.to(planes.dtype))).repeat(3)
        diag_m = diag_m * (w_xyz * w_xyz)[None]
    scale, sigma, ts = _equilibration(diag_m, t)
    scale_h = scale if w_xyz is None else scale * w_xyz[None]
    if ts.shape[-2] != 3 * n:
        raise ValueError(f"null basis has {ts.shape[-2]} rows, planes "
                         f"need {3 * n}")
    return scale, sigma, scale_h.contiguous(), ts.contiguous()


def _regularize_equilibrated_planes(planes, n, t, masses=None):
    """Semantic twin of ``_regularize_equilibrated(pad_to=padded_size(3
    n))`` starting from the nine raw Hessian planes ``(9, B, n, n)``,
    through the regularize/stitch kernel.  `t` is the (mass-adjusted)
    null basis ``(B, 3n, 6)``.  Returns ``(reg, scale, sigma)``."""
    if planes.shape[-1] != n:
        raise ValueError(f"planes are {tuple(planes.shape)}, n={n}")
    t = t.to(planes.dtype)
    scale, sigma, scale_h, ts = stitch_inputs(planes, t, masses)
    mp = spd_linalg.padded_size(3 * n)
    return regularize_stitch(planes, scale_h, ts, mp), scale, sigma


def _w_parts_from_reg_blocked(reg, scale, m):
    """Column-scaled top-level blocks ``(w11, w21, w22)`` of the inverse
    factor of the identity-padded ``reg`` (``pinv(reg_unscaled) =
    W^T W``); ``w21`` is ``None`` for single-leaf sizes."""
    g11, g21, g22 = spd_linalg.spd_inverse_factor_parts(reg)
    h = g11.shape[-1]
    mp = h if g21 is None else h + g22.shape[-1]
    scale_p = F.pad(scale, (0, mp - m)) if mp != m else scale
    if g21 is None:
        return g11 * scale_p[..., None, :], None, None
    return (g11 * scale_p[..., None, :h],
            g21 * scale_p[..., None, :h],
            g22 * scale_p[..., None, h:])


def _gram(w):
    """``w^T w`` over the last two axes."""
    return w.transpose(-1, -2) @ w


def _null_correction(t, sigma, n):
    """Plane-traced null-space term ``sum_a T_a T_a^T / sigma``."""
    tp = t.reshape(t.shape[:-2] + (3, n, t.shape[-1]))
    return torch.einsum("...anp,...amp->...nm", tp, tp) / sigma


def _plane_traces_from_w_parts(parts, t, sigma, n):
    """Plane traces from the factor's top-level blocks: each plane Gram
    splits over the row blocks, ``G_a = top_a^T top_a + bot_a^T bot_a``,
    so the dense factor never materializes; the top term contracts only
    rows from the 128-aligned floor of the plane's first column (rows
    above are exact zeros)."""
    w11, w21, w22 = parts
    if w21 is None:
        return _plane_traces_from_w(w11, t, sigma, n)
    h = w11.shape[-1]
    traces = None
    for a in range(3):
        c0, c1 = a * n, (a + 1) * n
        ga = None
        if c0 < h:
            t1 = min(c1, h)
            k0 = c0 // 128 * 128
            ga = F.pad(_gram(w11[..., k0:, c0:t1]),
                       (0, c1 - t1, 0, c1 - t1))
        cols = []
        if c0 < h:
            cols.append(w21[..., :, c0:min(c1, h)])
        if c1 > h:
            cols.append(w22[..., :, max(c0, h) - h:c1 - h])
        wb = cols[0] if len(cols) == 1 else torch.cat(cols, dim=-1)
        g_bot = _gram(wb)
        ga = g_bot if ga is None else ga + g_bot
        traces = ga if traces is None else traces + ga
    return traces - _null_correction(t, sigma, n)


def _plane_traces_from_w(w, t, sigma, n):
    """Plane traces ``sum_a W_a^T W_a - sum_a T_a T_a^T / sigma`` from a
    column-scaled lower-triangular factor ``W``, each Gram contracting
    from the 128-aligned floor of ``a n``."""
    traces = None
    for a in range(3):
        k0 = (a * n) // 128 * 128
        ga = _gram(w[..., k0:, a * n:(a + 1) * n])
        traces = ga if traces is None else traces + ga
    return traces - _null_correction(t, sigma, n)


def covariance_plane_traces_from_planes(planes, n, null_basis,
                                        masses=None):
    """Blocked-engine plane traces ``(B, n, n)`` of the pseudo-inverse
    covariance straight from the raw Hessian planes ``(9, B, n, n)`` —
    the main path.  Optional `masses` fold into the stitch's scale."""
    t = null_basis.to(planes.dtype)
    reg, scale, sigma = _regularize_equilibrated_planes(
        planes, n, t, masses=masses)
    parts = _w_parts_from_reg_blocked(reg, scale, 3 * n)
    return _plane_traces_from_w_parts(parts, t, sigma, n)


def covariance_plane_traces(matrix, null_basis, inverse="cho_solve"):
    """Plane traces ``(..., n, n)`` of the pseudo-inverse of xyz-layout
    ANM Hessians ``(..., 3n, 3n)``.

    ``inverse="cho_solve"`` factors with ``torch.linalg.cholesky`` and a
    triangular solve against the identity (any dtype);
    ``inverse="blocked"`` runs the divide-and-conquer inverse factor.
    """
    m = matrix.shape[-1]
    if m % 3:
        raise ValueError(f"xyz-layout ANM matrix dimension must be "
                         f"divisible by 3, got {m}")
    n = m // 3
    t = null_basis.to(matrix.dtype)
    if inverse == "blocked":
        reg, scale, sigma = _regularize_equilibrated(
            matrix, t, pad_to=spd_linalg.padded_size(m))
        parts = _w_parts_from_reg_blocked(reg, scale, m)
        return _plane_traces_from_w_parts(parts, t, sigma, n)
    if inverse != "cho_solve":
        raise ValueError(f"unknown inverse engine {inverse!r}")
    reg, scale, sigma = _regularize_equilibrated(matrix, t)
    # cholesky_ex does not raise on a non-SPD matrix: mark it NaN, as
    # the blocked engine's unclamped pivots do
    chol, info = torch.linalg.cholesky_ex(reg)
    chol = torch.where((info != 0)[..., None, None],
                       torch.full_like(chol, float("nan")), chol)
    eye = torch.eye(m, dtype=matrix.dtype, device=matrix.device)
    w = torch.linalg.solve_triangular(chol, eye.expand_as(chol), upper=False)
    w = w * scale[..., None, :]
    return _plane_traces_from_w(w, t, sigma, n)
