"""
Batched divide-and-conquer inverse Cholesky factor of SPD matrices.

Counterpart of ``springcraft_tpu/ops/pallas_linalg.py:192-623``
(:func:`spd_inverse_factor`, :func:`spd_inverse_factor_parts`,
:func:`spd_inverse_blocked`, the panel functions).  The
recursion keeps the JAX package's split points, padding and exact-zero
block skips, so that both packages factor the SAME padded problem:

    A = [[A11, .], [A21, A22]]
    G11 = invfactor(A11);  L21 = A21 G11^T
    G22 = invfactor(A22 - L21 L21^T)
    G21 = -G22 (L21 G11)

The node products are plain ``torch.matmul`` (the JAX package leaves
them to XLA).  The leaves, ``L^-1`` of SPD panels of at most ``block``
rows (``LEAF`` = 64 by default, clamped to 8-``MAX_LEAF`` as in the
JAX package), are the kernel ``csrc/panel_inverse.cu`` behind
:func:`panel_inverse_batched` with ``shrink_block=8``, with
:func:`panel_inverse_plain` beside it.  Two more public panel functions
stand beside the recursion, as in the JAX package: the full-window form
of the same elimination (:func:`panel_inverse_full`, the kernel's second
entry, reached through ``panel_inverse_batched(shrink_block=None)``, the
default) and the panel Cholesky
factor (:func:`panel_cholesky_batched`, kernel
``csrc/panel_cholesky.cu``, plain version :func:`panel_cholesky_plain`).

Beside them, the solve pair of a Cholesky factor, ``S (L L^T)^-1 S B``
(:func:`chol_solve`, kernel ``csrc/chol_solve.cu``, plain version
:func:`chol_solve_plain`): the inverse apply of the Cholesky
shift-invert engine, which reads the factor in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build

__all__ = [
    "LEAF",
    "MAX_LEAF",
    "panel_inverse_batched",
    "panel_inverse_full",
    "panel_inverse_plain",
    "panel_cholesky",
    "panel_cholesky_batched",
    "panel_cholesky_plain",
    "chol_solve",
    "chol_solve_factor",
    "chol_solve_plain",
    "spd_inverse_blocked",
    "spd_inverse_factor",
    "spd_inverse_factor_parts",
    "padded_size",
]

#: Leaf-panel size of the recursion: the JAX package's default ``block``.
LEAF = 64
#: The largest leaf, the clamp of ``block`` (``pallas_linalg.py:429``),
#: and the largest panel the two panel-inverse kernels take: one block
#: holds a panel's elimination state in registers.
MAX_LEAF = 128
#: Largest panel the Cholesky kernel takes (16 warps, the state in
#: registers).
MAX_CHOLESKY_PANEL = 128
#: Rows of a row block of the solve pair (``csrc/chol_solve.cu``).
CHOL_SOLVE_BLOCK = 64
#: Right-hand-side columns one launch pair takes; wider blocks go in turns.
CHOL_SOLVE_COLUMNS = 48


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


def _launch_panels(wrapper, entry, plain, panels, limit, align=4):
    """Run a panel kernel (C entry `entry`, panels up to `limit` rows,
    starting on an `align`-byte boundary) on `panels`, or its plain
    version on a CPU tensor."""
    name = wrapper.__name__
    _check_panels(panels)
    if _build.route(name, panels) == "cpu":
        return plain(panels)
    _build.require_cuda_f32(name, panels=panels)
    count, pb, _ = panels.shape
    if pb > limit:
        raise ValueError(f"{name}: pb={pb} exceeds {limit}, the largest "
                         f"panel the kernel takes")
    if panels.data_ptr() % align:
        raise ValueError(f"{name}: the panels must start on a {align}-byte "
                         f"boundary (the kernel's vector loads)")
    out = torch.empty_like(panels)
    _build.launch(entry, panels.device, panels.data_ptr(), out.data_ptr(),
                  count, pb)
    wrapper.launches += 1
    return out


def panel_inverse_batched(panels, shrink_block=None):
    """``L^-1`` (lower triangular, strict upper exactly zero) of a batch
    of SPD panels ``(P, pb, pb)``, ``pb`` a multiple of 8 (at most
    ``MAX_LEAF`` on CUDA).

    `shrink_block` is the JAX package's switch, with its default:
    ``None`` takes the full-window kernel K9, :func:`panel_inverse_full`;
    any block size that divides ``pb`` takes the kernel K3 that leaves
    finished rows alone (it retires them one by one, so every block size
    gives the same bits, and on CUDA its panels must start on a 16-byte
    boundary).  Both give the plain version's output bit for bit; the
    recursion's leaves take ``shrink_block=8``, as in the JAX
    package."""
    if shrink_block is None:
        return panel_inverse_full(panels)
    _check_panels(panels)
    if shrink_block <= 0 or panels.shape[-1] % shrink_block:
        raise ValueError(f"shrink_block must divide pb={panels.shape[-1]}, "
                         f"got {shrink_block}")
    return _launch_panels(panel_inverse_batched, "sc_panel_inverse",
                          panel_inverse_plain, panels, MAX_LEAF, align=16)


def panel_inverse_full(panels):
    """:func:`panel_inverse_batched` by the full-window elimination:
    every step updates all ``pb`` rows over all ``2 pb`` columns of
    ``[M | I]``, the state held in registers.  On an SPD panel its output
    equals the other kernel's and the plain version's bit for bit (the
    extra updates are exact zeros)."""
    return _launch_panels(panel_inverse_full, "sc_panel_inverse_full",
                          panel_inverse_plain, panels, MAX_LEAF)


def panel_cholesky_plain(panels):
    """Plain version of :func:`panel_cholesky`: right-looking Cholesky
    as a loop of tensor ops over the batch, no pivot clamp."""
    _check_panels(panels)
    pb = panels.shape[-1]
    s = panels.clone()
    for i in range(pb):
        rs = 1.0 / torch.sqrt(s[:, i, i])
        col = s[:, i:, i] * rs[:, None]
        s[:, i:, i] = col
        s[:, i + 1:, i + 1:] = s[:, i + 1:, i + 1:] \
            - col[:, 1:, None] * col[:, None, 1:]
    return torch.tril(s)


def panel_cholesky(panels):
    """Lower Cholesky factors (strict upper exactly zero) of a batch of
    SPD panels ``(P, pb, pb)``, ``pb`` a multiple of 8 (at most
    ``MAX_CHOLESKY_PANEL`` on CUDA, where the panels must start on a
    16-byte boundary: the kernel's vector loads).  A panel that is not
    SPD gives non-finite output; the output equals the plain version's
    bit for bit."""
    return _launch_panels(panel_cholesky, "sc_panel_cholesky",
                          panel_cholesky_plain, panels, MAX_CHOLESKY_PANEL,
                          align=16)


panel_inverse_batched.launches = 0
panel_inverse_full.launches = 0
panel_cholesky.launches = 0


def chol_solve_plain(x, chol, scale):
    """Plain version of :func:`chol_solve`, in the kernel's blocked
    order: row blocks of ``CHOL_SOLVE_BLOCK`` in solve order, each
    block's right-hand side less its products with the blocks solved
    before it, then its diagonal block solved."""
    m, block = chol.shape[-1], CHOL_SOLVE_BLOCK
    rhs = scale[:, None] * x
    y = torch.empty_like(rhs)
    for s in range(0, m, block):
        e = min(s + block, m)
        y[s:e] = torch.linalg.solve_triangular(
            chol[s:e, s:e], rhs[s:e] - chol[s:e, :s] @ y[:s], upper=False)
    out = torch.empty_like(rhs)
    for s in reversed(range(0, m, block)):
        e = min(s + block, m)
        out[s:e] = torch.linalg.solve_triangular(
            chol[s:e, s:e].mT, y[s:e] - chol[e:, s:e].mT @ out[e:],
            upper=True)
    return scale[:, None] * out


def _chol_solve_reads(chol):
    """Whether `chol` lies as :func:`chol_solve`'s kernel reads it."""
    return (chol.stride(0) == 1 and chol.stride(1) >= chol.shape[0]
            and chol.stride(1) * chol.element_size() % 16 == 0
            and chol.data_ptr() % 16 == 0)


def chol_solve_factor(chol):
    """The factor `chol` ``(m, m)`` as :func:`chol_solve` reads it:
    column-major, its address and leading dimension multiples of 16 bytes
    (the kernel's copies).  ``torch.linalg.cholesky_ex``'s factor is
    returned as it is when m is a multiple of 4 (float32) or 2 (float64);
    another is copied once into that layout, its leading dimension padded,
    so that every solve with it streams the triangle in 16-byte copies."""
    if _chol_solve_reads(chol):
        return chol
    m, align = chol.shape[0], 16 // chol.element_size()
    ld = -(-m // align) * align
    return chol.new_empty((m, ld))[:, :m].mT.copy_(chol)


#: Per (card, stream): the kernel's counters and two flags a row block,
#: zeroed once; each launch leaves them zero.
_CHOL_SOLVE_STATE = {}


def _chol_solve_state(device, n_blocks):
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    state = _CHOL_SOLVE_STATE.get(key)
    if state is None or state.numel() < 2 * n_blocks + 4:
        state = torch.zeros(2 * n_blocks + 4, dtype=torch.int32,
                            device=device)
        _CHOL_SOLVE_STATE[key] = state
    return state


def chol_solve(x, chol, scale):
    """``S (L L^T)^-1 S x`` for a lower Cholesky factor `chol` ``(m, m)``,
    a right-hand side `x` ``(m, b)`` and ``S = diag(scale)``: a forward
    and a backward triangular solve, ``torch.cholesky_solve`` with the
    scaling folded in.

    On CUDA (float32 or float64) each solve is one launch of
    ``csrc/chol_solve.cu`` (two a call, in turns of
    ``CHOL_SOLVE_COLUMNS`` columns past them), which reads the factor
    where it lies: column-major, ``chol.stride() == (1, ld)``, ``ld`` and
    the address multiples of 16 bytes, as :func:`chol_solve_factor`
    leaves it (another layout raises); `x` may have any strides.  The
    result is the same bit for bit on every call.  On the CPU,
    :func:`chol_solve_plain`.  Returns a new contiguous ``(m, b)``
    tensor."""
    name = "chol_solve"
    if chol.ndim != 2 or chol.shape[0] != chol.shape[1] or x.ndim != 2 \
            or x.shape[0] != chol.shape[0]:
        raise ValueError(f"{name}: expected chol (m, m) and x (m, b), got "
                         f"{tuple(chol.shape)} and {tuple(x.shape)}")
    m, b = x.shape
    if tuple(scale.shape) != (m,):
        raise ValueError(f"{name}: scale must be ({m},), got "
                         f"{tuple(scale.shape)}")
    if _build.route(name, x, chol, scale) == "cpu":
        return chol_solve_plain(x, chol, scale)
    if chol.dtype not in (torch.float32, torch.float64) \
            or any(t.dtype != chol.dtype for t in (x, scale)):
        raise TypeError(f"{name}: x, chol and scale must share float32 or "
                        f"float64 on CUDA, got "
                        f"{[str(t.dtype) for t in (x, chol, scale)]}")
    out = torch.empty((m, b), dtype=x.dtype, device=x.device)
    if m == 0 or b == 0:
        return out
    if not _chol_solve_reads(chol):
        raise ValueError(f"{name}: chol must be column-major, its leading "
                         f"dimension >= {m} and a multiple of 16 bytes, as "
                         f"chol_solve_factor leaves it, got strides "
                         f"{chol.stride()}")
    if not scale.is_contiguous():
        raise ValueError(f"{name}: scale must be contiguous")
    n_blocks = -(-m // CHOL_SOLVE_BLOCK)
    state = _chol_solve_state(x.device, n_blocks)
    f64 = int(x.dtype == torch.float64)
    ld = chol.stride(1)
    # the partial sums, then Y, then X
    work = torch.empty((3, n_blocks * CHOL_SOLVE_BLOCK, CHOL_SOLVE_COLUMNS),
                       dtype=x.dtype, device=x.device)
    for c0 in range(0, b, CHOL_SOLVE_COLUMNS):
        cols = min(CHOL_SOLVE_COLUMNS, b - c0)
        part = x[:, c0:c0 + cols]
        _build.launch("sc_chol_solve", x.device, chol.data_ptr(), ld, m,
                      part.data_ptr(), part.stride(0), part.stride(1), cols,
                      scale.data_ptr(), work[0].data_ptr(),
                      work[1].data_ptr(), None, 0, state.data_ptr(), 1, f64)
        _build.launch("sc_chol_solve", x.device, chol.data_ptr(), ld, m,
                      work[1].data_ptr(), CHOL_SOLVE_COLUMNS, 1, cols,
                      scale.data_ptr(), work[0].data_ptr(),
                      work[2].data_ptr(), out[:, c0:].data_ptr(), b,
                      state.data_ptr(), 0, f64)
        chol_solve.launches += 2
    return out


chol_solve.launches = 0


def _tri_inverse_newton(l):
    """Exact inverse of batched lower-triangular panels by log-depth
    Newton iteration: with ``X0 = diag(L)^-1`` the residual ``I - X L``
    is strictly lower triangular, so each ``X <- X (2 I - L X)``
    squares it to zero in ``ceil(log2(pb))`` rounds.  Plain matrix
    products, as in the JAX package."""
    pb = l.shape[-1]
    d = torch.diagonal(l, dim1=-2, dim2=-1)
    x = torch.eye(pb, dtype=l.dtype, device=l.device) / d[..., :, None]
    for _ in range(max(1, (pb - 1).bit_length())):
        x = 2.0 * x - x @ (l @ x)
    return x


def panel_cholesky_batched(panels):
    """Cholesky factor and its inverse for a batch of small SPD panels
    ``(P, pb, pb)``: ``(l, w)`` with ``l`` lower triangular and
    ``w = l^-1`` by Newton products on ``l``."""
    l = panel_cholesky(panels)
    return l, _tri_inverse_newton(l)


def _leaf_cap(block):
    """The recursion's leaf cap: `block` clamped to 8-``MAX_LEAF``, as the
    JAX package clamps it, so both factor the same padded problem with
    the same leaves."""
    return max(8, min(MAX_LEAF, int(block)))


def _check_precision(precision):
    """Every product runs in full float32 (TF32 stays off, the JAX
    package's ``precision='highest'``): `precision` is ``None`` or
    ``"highest"``."""
    if precision not in (None, "highest"):
        raise ValueError(f"precision must be None or 'highest' (full "
                         f"float32 products), got {precision!r}")


def padded_size(m, block=LEAF):
    """Padded size of the recursion for an ``(m, m)`` input with leaves
    of at most `block` rows."""
    return _choose_padding(m, _leaf_cap(block))


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


def _identity_padded(a, base):
    """The SPD batch ``a`` (``(..., m, m)``) as ``(b, mp, mp)``,
    identity-padded to the recursion's size for leaves of at most
    `base` rows (exact: the pad decouples)."""
    if a.ndim < 2 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"expected (..., m, m), got {tuple(a.shape)}")
    m = a.shape[-1]
    a = a.reshape((-1, m, m))
    mp = _choose_padding(m, base)
    if mp != m:
        a = F.pad(a, (0, mp - m, 0, mp - m))
        idx = torch.arange(m, mp, device=a.device)
        a[:, idx, idx] = 1.0
    return a


def spd_inverse_factor(a, block=LEAF, precision=None):
    """Inverse factor ``G = L^-1`` ``(..., mp, mp)`` of the
    identity-padded SPD batch ``a`` (``(..., m, m)``, ``mp =
    padded_size(m, block)``), so that ``A^-1 = (G^T G)[:m, :m]``; the
    strict upper triangle is exactly zero.  `block` caps the leaf
    panels (clamped to 8-``MAX_LEAF``); `precision` is ``None`` or
    ``"highest"``."""
    _check_precision(precision)
    base = _leaf_cap(block)
    g = _recursive_inverse_factor(_identity_padded(a, base), base)
    return g.reshape(a.shape[:-2] + g.shape[-2:])


def spd_inverse_blocked(a, block=LEAF, precision=None):
    """Dense inverse ``(..., m, m)`` of a batch of SPD matrices by the
    divide-and-conquer inverse factor and one Gram product,
    ``A^-1 = (G^T G)[:m, :m]``; `block` and `precision` as in
    :func:`spd_inverse_factor`."""
    m = a.shape[-1]
    g = spd_inverse_factor(a, block=block, precision=precision)
    return (g.transpose(-1, -2) @ g)[..., :m, :m]


def spd_inverse_factor_parts(a, block=LEAF, precision=None):
    """Top-split blocks ``(g11, g21, g22)`` of :func:`spd_inverse_factor`,
    ``G = [[g11, 0], [g21, g22]]``, without the final concatenation;
    ``g21`` and ``g22`` are ``None`` when the padded problem is a single
    leaf."""
    _check_precision(precision)
    base = _leaf_cap(block)
    parts = _top_inverse_factor_parts(_identity_padded(a, base), base)
    return tuple(None if p is None else p.reshape(a.shape[:-2]
                                                  + p.shape[-2:])
                 for p in parts)


def _top_inverse_factor_parts(a, base):
    """One node of the recursion, final concat left to the caller."""
    s = a.shape[-1]
    if s <= base:
        return panel_inverse_batched(a.contiguous(), shrink_block=8), \
            None, None
    h = _round_up(s // 2, 128)
    if h >= s:
        h = s // 2
    g11 = _recursive_inverse_factor(a[:, :h, :h], base)
    l21, s22 = _schur_lower(a, h, g11)
    g22 = _recursive_inverse_factor(s22, base)
    g21 = -_tri_left_mm(g22, _tri_right_mm(l21, g11))
    return g11, g21, g22


def _recursive_inverse_factor(a, base):
    """``G = L^-1`` of a batched SPD ``(b, s, s)``, leaves of at most
    `base` rows."""
    g11, g21, g22 = _top_inverse_factor_parts(a, base)
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
