"""
Analytic null space and the regularized pseudo-inverse covariance.

Counterpart of ``springcraft_tpu/ops/rigid.py`` (main-path subset).  For
a connected network with orthonormal null basis ``T`` and any
``sigma > 0``,

    pinv(H) = (H + sigma T T^t)^-1 - T T^t / sigma,

so the covariance comes from an SPD inverse.  Everything here is
batched over a leading conformer axis (the JAX package vmaps).

Every covariance function takes the JAX package's ``sigma=``, the weight
of the null space (default: the mean diagonal of the matrix), and
:func:`covariance_cholesky` its ``block_size=`` (the identity solved in
column blocks); :func:`pinv_diagonal` gives the covariance diagonal alone
from one factor and column-block solves.

Two engines give the covariance ``pinv(M)`` (:func:`covariance_cholesky`,
ANM and GNM) or, for an xyz-layout ANM Hessian, only its plane traces
``traces[i, j] = sum_a pinv(H)[a n + i, a n + j]`` that MSF, B-factors
and DCC consume (:func:`covariance_plane_traces`):

* ``"blocked"`` — the divide-and-conquer inverse factor ``G`` of
  :mod:`.spd_linalg` (panel-inverse kernel at the leaves) and Gram
  products of the column-scaled factor; the ANM ensemble pipeline feeds
  it from the raw Hessian planes through the regularize/stitch kernel
  (:func:`covariance_plane_traces_from_planes`,
  :func:`covariance_cholesky_from_planes`) or, opt-in, straight from
  the coordinates through the assembly-fused stitch kernel
  (:func:`covariance_plane_traces_direct`,
  :func:`covariance_cholesky_direct`; analytic families);
* ``"cho_solve"`` — ``torch.linalg.cholesky_ex`` plus a solve against
  the identity, any dtype: the single-structure engine and the port's
  own float64 reference.

A network with a null space beyond ``T`` (disconnected, collinear) makes
the regularized matrix singular; both engines then give non-finite
output by design.

The covariance functions name their three stages for a running
profiler (:func:`..utils.profiling.span`): ``springcraft::prep`` (the
regularized, equilibrated factor input), ``springcraft::inverse_factor``
(the inverse factor, or the Cholesky factor and its solve) and
``springcraft::grams`` (the Grams and the null-space term).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.profiling import span
from . import spd_linalg
from .assembly import _pair_geometry
from .assembly_kernels import (MAX_ATOMS_STITCH, assembly_row_sums,
                               assembly_stitch, regularize_stitch)
from .ffparams import ANALYTIC_KINDS

__all__ = [
    "rigid_modes_anm",
    "null_mode_gnm",
    "covariance_cholesky",
    "covariance_cholesky_from_planes",
    "covariance_cholesky_direct",
    "covariance_plane_traces",
    "covariance_plane_traces_from_planes",
    "covariance_plane_traces_direct",
    "direct_prep_applies",
    "pinv_diagonal",
]


def rigid_modes_anm(coords, masses=None, layout="xyz"):
    """Orthonormal basis ``(..., 3n, 6)`` of the six rigid-body modes
    (translations, rotations about the centroid) of conformers ``(...,
    n, 3)``; with `masses` the modes of the mass-weighted Hessian ``W H
    W`` (scaled by ``sqrt(m)``).  `layout` ``"xyz"`` (component planes,
    the kernels' layout) or ``"atom"`` (components interleaved per
    atom)."""
    if layout not in ("xyz", "atom"):
        raise ValueError(f"Unknown layout '{layout}'")
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
        modes = modes * torch.sqrt(torch.as_tensor(masses))[:, None]
    if layout == "atom":
        modes = modes.transpose(-3, -2)
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


def _sigma(diag_m, sigma):
    """The null-space weight ``(..., 1, 1)``: `sigma` (a number, or one
    per matrix of the batch) or, for ``None``, the mean diagonal."""
    if sigma is None:
        return diag_m.mean(dim=-1)[..., None, None]
    sigma = torch.as_tensor(sigma, dtype=diag_m.dtype, device=diag_m.device)
    return sigma[..., None, None]


def _equilibration(diag_m, t, sigma=None):
    """``(scale, sigma, ts)`` of the null-space-regularized Jacobi
    equilibration, ``sigma`` by default the mean of the diagonal:
    ``scale = (diag + sigma |t_row|^2)^-1/2`` and
    ``ts = t * scale sqrt(sigma)``."""
    sigma = _sigma(diag_m, sigma)
    tn2 = (t * t).sum(dim=-1)
    scale = torch.rsqrt(diag_m + sigma[..., 0] * tn2)
    ts = t * (scale * torch.sqrt(sigma[..., 0]))[..., None]
    return scale, sigma, ts


def _regularize_equilibrated(matrix, t, pad_to=None, sigma=None):
    """``reg = S (M + sigma T T^t) S`` with ``S = diag(reg)^-1/2`` from
    the analytic diagonal, optionally identity-padded to ``pad_to``.
    Returns ``(reg, scale, sigma)``; ``scale`` stays unpadded."""
    m = matrix.shape[-1]
    diag_m = torch.diagonal(matrix, dim1=-2, dim2=-1)
    scale, sigma, ts = _equilibration(diag_m, t, sigma)
    reg = (matrix * scale[..., :, None] * scale[..., None, :]
           + ts @ ts.transpose(-1, -2))
    if pad_to is not None and pad_to != m:
        reg = F.pad(reg, (0, pad_to - m, 0, pad_to - m))
        idx = torch.arange(m, pad_to, device=reg.device)
        reg[..., idx, idx] = 1.0
    return reg, scale, sigma


def _stitch_inputs_from_diag(diag_m, t, masses, sigma=None):
    """``(scale, sigma, scale_h, ts)`` of the stitch kernels from the
    raw Hessian diagonal ``(B, 3n)``: mass weights ``w = 1 / sqrt(m)``
    of ``M' = W H W`` scale the diagonal and fold into the kernel's row
    and column scale ``scale_h = scale * w``; ``scale`` un-scales the
    inverse factor downstream."""
    w_xyz = None
    if masses is not None:
        w_xyz = (1.0 / torch.sqrt(masses.to(diag_m.dtype))).repeat(3)
        diag_m = diag_m * (w_xyz * w_xyz)[None]
    scale, sigma, ts = _equilibration(diag_m, t, sigma)
    scale_h = scale if w_xyz is None else scale * w_xyz[None]
    if ts.shape[-2] != diag_m.shape[-1]:
        raise ValueError(f"null basis has {ts.shape[-2]} rows, the "
                         f"Hessian has {diag_m.shape[-1]}")
    return scale, sigma, scale_h.contiguous(), ts.contiguous()


def stitch_inputs(planes, t, masses=None, sigma=None):
    """Everything the regularize/stitch kernel needs besides the planes
    (see :func:`_stitch_inputs_from_diag`), the diagonal read off the
    three diagonal planes."""
    diag_m = torch.cat([torch.diagonal(planes[4 * a], dim1=-2, dim2=-1)
                        for a in range(3)], dim=-1)          # (B, 3n)
    return _stitch_inputs_from_diag(diag_m, t, masses, sigma)


def _regularize_equilibrated_planes(planes, n, t, masses=None, sigma=None):
    """Semantic twin of ``_regularize_equilibrated(pad_to=padded_size(3
    n))`` starting from the nine raw Hessian planes ``(9, B, n, n)``,
    through the regularize/stitch kernel.  `t` is the (mass-adjusted)
    null basis ``(B, 3n, 6)``.  Returns ``(reg, scale, sigma)``."""
    if planes.shape[-1] != n:
        raise ValueError(f"planes are {tuple(planes.shape)}, n={n}")
    t = t.to(planes.dtype)
    scale, sigma, scale_h, ts = stitch_inputs(planes, t, masses, sigma)
    mp = spd_linalg.padded_size(3 * n)
    return regularize_stitch(planes, scale_h, ts, mp), scale, sigma


def _hessian_diag_xyz_batched(coords, params):
    """``(B, 3n)`` diagonal of the xyz-layout ANM Hessian straight from
    coordinates: all the assembly-fused prep needs ahead of its kernel
    (the Jacobi scale is a global function of the diagonal through
    ``sigma``, so the kernel cannot compute it row by row).  Plain
    PyTorch, O(n) output, as the JAX package computes it; the prep
    takes it from the kernel's row-sum pass
    (:func:`_diagonal_of_row_sums`)."""
    disp, sq, k = _pair_geometry(coords, params)
    g = k / torch.where(sq == 0, torch.ones_like(sq), sq)
    return torch.cat([(g * d * d).sum(dim=-1) for d in disp], dim=-1)


def _diagonal_of_row_sums(row_sums):
    """``(B, 3n)`` Hessian diagonal from the diagonal superelements
    ``(B, n, 9)`` of :func:`.assembly_kernels.assembly_row_sums`."""
    batch, n, _ = row_sums.shape
    return row_sums[..., ::4].transpose(-1, -2).reshape(batch, 3 * n)


def direct_prep_applies(params, n):
    """Whether the assembly-fused prep covers this configuration: an
    analytic family without patch overlays at a size its kernel stages.
    Anything else takes the planes path or dense Hessians, as in the JAX
    package."""
    return params.kind in ANALYTIC_KINDS and not params.overlays \
        and n <= MAX_ATOMS_STITCH


def _regularize_equilibrated_direct(coords, params, t, masses=None,
                                    sigma=None):
    """Semantic twin of :func:`_regularize_equilibrated_planes` that
    starts from the coordinates ``(B, n, 3)``: the pair planes are
    recomputed inside the assembly-fused stitch kernel and never reach
    device memory.  The kernel's row-sum pass gives the diagonal
    superelements: their diagonal sets the scale, and the store pass
    writes all nine.  ``scale`` and ``sigma`` match the planes path to
    the summation order of the diagonal.  Returns ``(reg, scale,
    sigma)``."""
    t = t.to(coords.dtype)
    row_sums = assembly_row_sums(coords, params)
    scale, sigma, scale_h, ts = _stitch_inputs_from_diag(
        _diagonal_of_row_sums(row_sums), t, masses, sigma)
    mp = spd_linalg.padded_size(3 * coords.shape[1])
    return (assembly_stitch(coords, params, scale_h, ts, mp, row_sums),
            scale, sigma)


def _padded_scale(scale, mp):
    """``scale`` zero-padded to ``mp`` columns: the padding rows of the
    identity-padded factor carry zeros in the first ``m`` columns, so
    contracting over the full padded range downstream stays exact."""
    m = scale.shape[-1]
    return F.pad(scale, (0, mp - m)) if mp != m else scale


def _w_from_reg_blocked(reg, scale):
    """Column-scaled inverse factor ``W = G S`` ``(..., mp, mp)`` of the
    identity-padded ``reg``, so that ``pinv(reg_unscaled) = W^T W``
    (``S G^T G S = (G S)^T (G S)``)."""
    g = spd_linalg.spd_inverse_factor(reg)
    return g * _padded_scale(scale, g.shape[-1])[..., None, :]


def _w_parts_from_reg_blocked(reg, scale):
    """Column-scaled top-level blocks ``(w11, w21, w22)`` of
    :func:`_w_from_reg_blocked`; ``w21`` is ``None`` for single-leaf
    sizes."""
    g11, g21, g22 = spd_linalg.spd_inverse_factor_parts(reg)
    h = g11.shape[-1]
    mp = h if g21 is None else h + g22.shape[-1]
    scale_p = _padded_scale(scale, mp)
    if g21 is None:
        return g11 * scale_p[..., None, :], None, None
    return (g11 * scale_p[..., None, :h],
            g21 * scale_p[..., None, :h],
            g22 * scale_p[..., None, h:])


def _gram(w):
    """``w^T w`` over the last two axes."""
    return w.transpose(-1, -2) @ w


def _gram_lower(w):
    """``W^T W`` of a column-scaled lower-triangular ``W`` ``(..., mp,
    mp)``, skipping its exact-zero upper region: the rows split at the
    128-aligned ``h = (mp // 2) // 128 * 128``, and the top block's
    columns ``>= h`` are zero, so its Gram fills only the leading
    ``(h, h)`` block.  Only exact-zero terms are dropped."""
    mp = w.shape[-2]
    h = (mp // 2) // 128 * 128
    if h < 128:
        return _gram(w)
    g_top = _gram(w[..., :h, :h])
    return _gram(w[..., h:, :]) + F.pad(g_top, (0, mp - h, 0, mp - h))


def _null_projector(t, sigma):
    """Null-space term ``T T^T / sigma`` of the pseudo-inverse."""
    return t @ t.transpose(-1, -2) / sigma


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


def covariance_plane_traces_from_planes(planes, n, null_basis, sigma=None,
                                        masses=None):
    """Blocked-engine plane traces ``(B, n, n)`` of the pseudo-inverse
    covariance straight from the raw Hessian planes ``(9, B, n, n)`` —
    the main path.  Optional `masses` fold into the stitch's scale;
    `sigma` as in :func:`covariance_cholesky`."""
    t = null_basis.to(planes.dtype)
    with span("prep"):
        reg, scale, sigma = _regularize_equilibrated_planes(
            planes, n, t, masses=masses, sigma=sigma)
    with span("inverse_factor"):
        parts = _w_parts_from_reg_blocked(reg, scale)
    with span("grams"):
        return _plane_traces_from_w_parts(parts, t, sigma, n)


def covariance_cholesky_from_planes(planes, n, null_basis, sigma=None,
                                    masses=None):
    """Blocked-engine pseudo-inverse covariance ``(B, 3n, 3n)`` (xyz
    layout) straight from the raw Hessian planes ``(9, B, n, n)``.
    Optional `masses` fold into the stitch's scale."""
    t = null_basis.to(planes.dtype)
    with span("prep"):
        reg, scale, sigma = _regularize_equilibrated_planes(
            planes, n, t, masses=masses, sigma=sigma)
    m = 3 * n
    with span("inverse_factor"):
        w = _w_from_reg_blocked(reg, scale)
    with span("grams"):
        return _gram_lower(w)[..., :m, :m] - _null_projector(t, sigma)


def covariance_plane_traces_direct(coords, params, null_basis, sigma=None,
                                   masses=None):
    """:func:`covariance_plane_traces_from_planes` straight from the
    coordinates ``(B, n, 3)`` through the assembly-fused prep."""
    n = coords.shape[1]
    t = null_basis.to(coords.dtype)
    with span("prep"):
        reg, scale, sigma = _regularize_equilibrated_direct(
            coords, params, t, masses=masses, sigma=sigma)
    with span("inverse_factor"):
        parts = _w_parts_from_reg_blocked(reg, scale)
    with span("grams"):
        return _plane_traces_from_w_parts(parts, t, sigma, n)


def covariance_cholesky_direct(coords, params, null_basis, sigma=None,
                               masses=None):
    """:func:`covariance_cholesky_from_planes` straight from the
    coordinates ``(B, n, 3)`` through the assembly-fused prep."""
    m = 3 * coords.shape[1]
    t = null_basis.to(coords.dtype)
    with span("prep"):
        reg, scale, sigma = _regularize_equilibrated_direct(
            coords, params, t, masses=masses, sigma=sigma)
    with span("inverse_factor"):
        w = _w_from_reg_blocked(reg, scale)
    with span("grams"):
        return _gram_lower(w)[..., :m, :m] - _null_projector(t, sigma)


def _cholesky_factor(reg):
    """Lower Cholesky factor of a batch of SPD matrices.  cholesky_ex
    does not raise on a matrix that is not SPD: mark that factor NaN, as
    the blocked engine's unclamped pivots do."""
    chol, info = torch.linalg.cholesky_ex(reg)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(chol, float("nan")), chol)


def _factor_in(factor_dtype, inverse, matrix, null_basis):
    """`matrix` and `null_basis` in `factor_dtype` (``None``: as they
    are; the Cholesky engine only)."""
    if factor_dtype is None or factor_dtype == matrix.dtype:
        return matrix, null_basis
    if inverse != "cho_solve":
        raise ValueError("factor_dtype applies to inverse='cho_solve'")
    return matrix.to(factor_dtype), null_basis.to(factor_dtype)


def _identity_columns(m, start, count, like):
    """Columns ``start`` ... ``start + count - 1`` of the ``(m, m)``
    identity."""
    rows = torch.arange(m, device=like.device)[:, None]
    cols = torch.arange(start, start + count, device=like.device)[None, :]
    return (rows == cols).to(like.dtype)


def covariance_cholesky(matrix, null_basis, sigma=None, block_size=None,
                        inverse="cho_solve", factor_dtype=None):
    """Pseudo-inverse ``(..., m, m)`` of PSD interaction matrices
    ``(..., m, m)`` with a known orthonormal null basis ``(..., m, k)``
    (the six rigid modes of an ANM Hessian, the constant mode of a GNM
    Kirchhoff matrix; leading dimensions broadcast).

    `sigma` weighs the null space (default: the mean diagonal; one
    number, or one per matrix).  ``inverse="cho_solve"`` factors with
    ``torch.linalg.cholesky_ex`` and solves against the identity (any
    dtype), for an unbatched matrix in column blocks of `block_size`
    when given (it must divide ``m``; the blocked engine refuses it);
    ``inverse="blocked"`` runs the divide-and-conquer inverse factor and
    the Gram of its column-scaled form.  `factor_dtype` runs the
    Cholesky engine, regularization included, in another dtype than
    `matrix`'s and casts the result back (the single-structure entry
    points: float64).
    """
    out_dtype = matrix.dtype
    matrix, null_basis = _factor_in(factor_dtype, inverse, matrix,
                                    null_basis)
    m = matrix.shape[-1]
    t = null_basis.to(matrix.dtype)
    if inverse == "blocked":
        if block_size is not None:
            raise ValueError(
                "block_size (column-blocked identity solves, the "
                "memory-lean cho_solve path) is incompatible with "
                "inverse='blocked', which materializes dense (m, m) "
                "factor/inverse temporaries")
        with span("prep"):
            reg, scale, sigma = _regularize_equilibrated(
                matrix, t, pad_to=spd_linalg.padded_size(m), sigma=sigma)
        with span("inverse_factor"):
            w = _w_from_reg_blocked(reg, scale)
        with span("grams"):
            return (_gram_lower(w)[..., :m, :m]
                    - _null_projector(t, sigma)).to(out_dtype)
    if inverse != "cho_solve":
        raise ValueError(f"unknown inverse engine {inverse!r}")
    with span("prep"):
        reg, scale, sigma = _regularize_equilibrated(matrix, t, sigma=sigma)
    with span("inverse_factor"):
        chol = _cholesky_factor(reg)
        if block_size is None or matrix.ndim > 2:
            eye = torch.eye(m, dtype=matrix.dtype, device=matrix.device)
            inv = torch.cholesky_solve(eye.expand_as(chol), chol)
        else:
            if m % block_size:
                raise ValueError(f"block_size={block_size} must divide "
                                 f"m={m}")
            inv = torch.cat([
                torch.cholesky_solve(
                    _identity_columns(m, start, block_size, chol), chol)
                for start in range(0, m, block_size)], dim=1)
    with span("grams"):
        inv = inv * scale[..., :, None] * scale[..., None, :]
        return (inv - _null_projector(t, sigma)).to(out_dtype)


def covariance_plane_traces(matrix, null_basis, sigma=None,
                            inverse="cho_solve", factor_dtype=None):
    """Plane traces ``(..., n, n)`` of the pseudo-inverse of xyz-layout
    ANM Hessians ``(..., 3n, 3n)``.

    ``inverse="cho_solve"`` factors with ``torch.linalg.cholesky`` and a
    triangular solve against the identity (any dtype);
    ``inverse="blocked"`` runs the divide-and-conquer inverse factor.
    `sigma` and `factor_dtype` as in :func:`covariance_cholesky`.
    """
    out_dtype = matrix.dtype
    matrix, null_basis = _factor_in(factor_dtype, inverse, matrix,
                                    null_basis)
    m = matrix.shape[-1]
    if m % 3:
        raise ValueError(f"xyz-layout ANM matrix dimension must be "
                         f"divisible by 3, got {m}")
    n = m // 3
    t = null_basis.to(matrix.dtype)
    if inverse == "blocked":
        with span("prep"):
            reg, scale, sigma = _regularize_equilibrated(
                matrix, t, pad_to=spd_linalg.padded_size(m), sigma=sigma)
        with span("inverse_factor"):
            parts = _w_parts_from_reg_blocked(reg, scale)
        with span("grams"):
            return _plane_traces_from_w_parts(parts, t, sigma, n)
    if inverse != "cho_solve":
        raise ValueError(f"unknown inverse engine {inverse!r}")
    with span("prep"):
        reg, scale, sigma = _regularize_equilibrated(matrix, t, sigma=sigma)
    with span("inverse_factor"):
        chol = _cholesky_factor(reg)
        eye = torch.eye(m, dtype=matrix.dtype, device=matrix.device)
        w = torch.linalg.solve_triangular(chol, eye.expand_as(chol),
                                          upper=False)
        w = w * scale[..., None, :]
    with span("grams"):
        return _plane_traces_from_w(w, t, sigma, n).to(out_dtype)


def pinv_diagonal(matrix, null_basis, sigma=None, block_size=1024,
                  donate=False):
    """Diagonal ``(m,)`` of the pseudo-inverse of one PSD matrix ``(m,
    m)`` with a known null basis, without the inverse: one Cholesky
    factor and solves against `block_size` identity columns at a time
    (it must divide ``m``), of which only the diagonal block is kept.
    Peak memory is the factor plus ``m * block_size`` per block.  With
    `donate` the regularization overwrites `matrix` in place (its
    contents are gone afterwards), so that at most two ``(m, m)``
    tensors are live.  For an xyz-layout ANM Hessian ``msf_i = sum_a
    diag[a n + i]``."""
    if matrix.ndim != 2:
        raise ValueError("pinv_diagonal expects an unbatched matrix")
    m = matrix.shape[-1]
    if m % block_size:
        raise ValueError(f"block_size={block_size} must divide m={m}")
    t = null_basis.to(matrix.dtype)
    scale, sigma, ts = _equilibration(torch.diagonal(matrix), t, sigma)
    outer = scale[:, None] * scale[None, :]
    reg = matrix.mul_(outer) if donate else matrix * outer
    chol = _cholesky_factor(reg.addmm_(ts, ts.T))
    del reg
    diag = torch.cat([
        torch.diagonal(torch.cholesky_solve(
            _identity_columns(m, start, block_size, chol),
            chol)[start:start + block_size])
        for start in range(0, m, block_size)])
    return diag * scale * scale - (t * t).sum(dim=1) / sigma[0, 0]
