"""
Batched divide-and-conquer inverse Cholesky factor of SPD matrices.

Counterpart of ``springcraft_tpu/ops/pallas_linalg.py:270-623``.  The
recursion keeps the JAX package's split points, padding and exact-zero
block skips, so that both packages factor the SAME padded problem:

    A = [[A11, .], [A21, A22]]
    G11 = invfactor(A11);  L21 = A21 G11^T
    G22 = invfactor(A22 - L21 L21^T)
    G21 = -G22 (L21 G11)

The node products are plain ``torch.matmul`` (the JAX package leaves
them to XLA).  The leaves, ``L^-1`` of SPD panels of at most ``LEAF``
rows, are the kernel ``csrc/panel_inverse.cu`` behind
:func:`panel_inverse_batched`, with :func:`panel_inverse_plain` beside
it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build

__all__ = [
    "LEAF",
    "panel_inverse_batched",
    "panel_inverse_plain",
    "spd_inverse_factor_parts",
    "padded_size",
]

#: Leaf-panel size of the recursion (the JAX package's default
#: ``block``), and the largest panel the kernel takes: its ``[M | I]``
#: state, 2 pb^2 floats, lives in shared memory (32 KB).
LEAF = 64


def _round_up(x, m):
    return -(-x // m) * m


def _check_panels(panels):
    if panels.ndim != 3 or panels.shape[-1] != panels.shape[-2] \
            or panels.shape[-1] % 8:
        raise ValueError(f"panels must be (P, pb, pb) with pb % 8 == 0, "
                         f"got {tuple(panels.shape)}")


def panel_inverse_plain(panels):
    """Plain version of :func:`panel_inverse_batched`: the kernel's
    augmented ``[M | I]`` row elimination as a loop of tensor ops over
    the batch.  No pivot clamp — a panel that is not SPD gives
    non-finite output (``torch.linalg.cholesky`` would raise
    instead)."""
    _check_panels(panels)
    count, pb, _ = panels.shape
    eye = torch.eye(pb, dtype=panels.dtype, device=panels.device)
    s = torch.cat([panels, eye.expand(count, pb, pb)], dim=-1)
    for i in range(pb):
        rs = 1.0 / torch.sqrt(s[:, i, i])
        row_i = s[:, i, :].clone()
        coef = s[:, i:, i] * (rs * rs)[:, None]
        coef[:, 0] = 1.0 - rs
        s[:, i:, :] = s[:, i:, :] - coef[:, :, None] * row_i[:, None, :]
    return torch.tril(s[:, :, pb:])


def panel_inverse_batched(panels):
    """``L^-1`` (lower triangular, strict upper exactly zero) of a batch
    of SPD panels ``(P, pb, pb)``, ``pb`` a multiple of 8 (at most
    ``LEAF`` on CUDA)."""
    _check_panels(panels)
    if _build.route("panel_inverse_batched", panels) == "cpu":
        return panel_inverse_plain(panels)
    _build.require_cuda_f32("panel_inverse_batched", panels=panels)
    count, pb, _ = panels.shape
    if pb > LEAF:
        raise ValueError(f"panel_inverse_batched: pb={pb} exceeds "
                         f"{LEAF}")
    out = torch.empty_like(panels)
    _build.launch("sc_panel_inverse", panels.device, panels.data_ptr(),
                  out.data_ptr(), count, pb)
    panel_inverse_batched.launches += 1
    return out


panel_inverse_batched.launches = 0


def padded_size(m):
    """Padded size of the recursion for an ``(m, m)`` input."""
    return _choose_padding(m, LEAF)


def _choose_padding(m, base_max):
    """Next multiple of 128 (every split stays 128-aligned), of 64 up to
    256, or of 8 for single-leaf inputs — the JAX package's rule,
    tuned on the TPU and kept so both packages factor the same
    problem."""
    if m <= max(8, min(128, base_max)):
        return _round_up(m, 8)
    if m <= 256:
        return _round_up(m, 64)
    return _round_up(m, 128)


def spd_inverse_factor_parts(a):
    """Top-split blocks ``(g11, g21, g22)`` of the inverse factor
    ``G = [[g11, 0], [g21, g22]] = L^-1`` of the identity-padded SPD
    batch ``a`` (``(..., m, m)``), so that ``A^-1 = (G^T G)[:m, :m]``;
    ``g21`` and ``g22`` are ``None`` when the padded problem is a single
    leaf."""
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"expected (..., m, m), got {tuple(a.shape)}")
    batch_shape = a.shape[:-2]
    m = a.shape[-1]
    a = a.reshape((-1, m, m))
    mp = padded_size(m)
    if mp != m:
        a = F.pad(a, (0, mp - m, 0, mp - m))
        idx = torch.arange(m, mp, device=a.device)
        a[:, idx, idx] = 1.0
    parts = _top_inverse_factor_parts(a)
    return tuple(None if p is None else p.reshape(batch_shape + p.shape[-2:])
                 for p in parts)


def _top_inverse_factor_parts(a):
    """One node of the recursion, final concat left to the caller."""
    s = a.shape[-1]
    if s <= LEAF:
        return panel_inverse_batched(a.contiguous()), None, None
    h = _round_up(s // 2, 128)
    if h >= s:
        h = s // 2
    g11 = _recursive_inverse_factor(a[:, :h, :h])
    l21, s22 = _schur_lower(a, h, g11)
    g22 = _recursive_inverse_factor(s22)
    g21 = -_tri_left_mm(g22, _tri_right_mm(l21, g11))
    return g11, g21, g22


def _recursive_inverse_factor(a):
    """``G = L^-1`` of a batched SPD ``(b, s, s)``."""
    g11, g21, g22 = _top_inverse_factor_parts(a)
    if g21 is None:
        return g11
    h = g11.shape[-1]
    s = a.shape[-1]
    top = F.pad(g11, (0, s - h))
    bot = torch.cat([g21, g22], dim=2)
    return torch.cat([top, bot], dim=1)


def _tri_split(h):
    """128-aligned split for a sub-factor's block triangle, or 0."""
    q = _round_up(h // 2, 128)
    return q if 0 < q < h else 0


def _mt(x):
    return x.transpose(-1, -2)


def _schur_lower(a, h, g11):
    """``L21 = A21 G11^T`` and ``S22 = A22 - L21 L21^T``, skipping the
    sub-factor's zero blocks; S22's strict upper-right quadrant is
    zero-filled (the recursion never reads it)."""
    a21 = a[:, h:, :h]
    q = _tri_split(h)
    if not q:
        l21 = a21 @ _mt(g11)
        return l21, a[:, h:, h:] - l21 @ _mt(l21)
    l21 = torch.cat([a21[:, :, :q] @ _mt(g11[:, :q, :q]),
                     a21 @ _mt(g11[:, q:, :])], dim=2)
    w = a.shape[-1] - h
    qq = _tri_split(w)
    if not qq:
        return l21, a[:, h:, h:] - l21 @ _mt(l21)
    s22_l = a[:, h:, h:h + qq] - l21 @ _mt(l21[:, :qq, :])
    s22_br = a[:, h + qq:, h + qq:] - l21[:, qq:, :] @ _mt(l21[:, qq:, :])
    s22 = torch.cat([
        F.pad(s22_l[:, :qq, :], (0, w - qq)),
        torch.cat([s22_l[:, qq:, :], s22_br], dim=2),
    ], dim=1)
    return l21, s22


def _tri_right_mm(x, g):
    """``X @ G`` for a sub-factor with exact zero top-right blocks."""
    q = _tri_split(g.shape[-1])
    if not q:
        return x @ g
    return torch.cat([x @ g[:, :, :q], x[:, :, q:] @ g[:, q:, q:]], dim=2)


def _tri_left_mm(g, x):
    """``G @ X`` for a sub-factor with exact zero top-right blocks."""
    q = _tri_split(g.shape[-2])
    if not q:
        return g @ x
    return torch.cat([g[:, :q, :q] @ x[:, :q, :], g[:, q:, :] @ x], dim=1)
