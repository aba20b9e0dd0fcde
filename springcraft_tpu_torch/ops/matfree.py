"""
Matrix-free ENM operators and the solvers above them: ``H @ X`` and
``K @ X`` without materializing the Hessian or the Kirchhoff matrix.

Counterpart of ``springcraft_tpu/ops/matfree.py`` for the families whose
parameters are O(n): the analytic ones and the tabulated
``table_compact`` (sdENM, eANM, ...), each with or without patch
overlays; ``table_pair`` is refused, as there.  The dense pipelines hold
the ``(3n, 3n)`` Hessian, 32 GB in float32 at 30k residues; here the
operator stays implicit,

    y_i = sum_j g_ij d_ij (d_ij . x_j) - (sum_j g_ij d_ij d_ij^T) x_i,

with ``d_ij = r_i - r_j`` and ``g_ij = -k_ij / |d_ij|^2``, in the xyz
plane layout ``(3n, k)`` of the JAX package.

* Plain row-blocked operators (what XLA ran outside Pallas):
  :func:`hessian_apply`, :func:`kirchhoff_apply`,
  :func:`hessian_degree_bound`, :func:`hessian_diag_blocks`,
  :func:`kirchhoff_degree`, :func:`matfree_mode_residuals`.
* Host set-up (numpy): :func:`spatial_sort_permutation` (Morton order),
  :func:`tile_neighbor_lists` and :func:`tile_csr`, the row-sorted tile
  pairs as a CSR (row pointer from ``counts``, column tiles).  The JAX
  package splits the pair list into segments because its scalar-prefetch
  arrays live in a TPU's SMEM; the CUDA kernels take the whole CSR.
* The pair CSR (:class:`PairCSR`, :func:`pair_csr`, kernel
  ``csrc/matfree_pairs.cu``): every ordered pair within the cutoff of
  the tile CSR's neighbour tiles, as a row pointer, the slot and the
  spring constant of each pair, 8 bytes a pair, built once per solver
  set-up by the tile walk and the test of the TPU kernels (the table
  lookup of ``table_compact`` included).  Its plain version
  :func:`pair_csr_plain` reads the pairs off the plain tile walk.
* Four kernel wrappers: :func:`pair_csr`; :func:`hessian_apply_sparse`
  (K13, ``csrc/matfree_hessian.cu``) and :func:`kirchhoff_apply_sparse`
  (K14, ``csrc/matfree_kirchhoff.cu``), gathers over the pair CSR, whose
  plain versions :func:`hessian_apply_pair_csr_plain` /
  :func:`kirchhoff_apply_pair_csr_plain` sum over the same list; and
  :func:`hessian_apply_dense` (K12, every pair tested on every apply,
  the same test, then register-tiled FMAs over the staged X).  The
  public sparse wrappers take tile neighbour lists: on CUDA they build
  the pair CSR and apply in one call, on the CPU they run the tile
  walk's plain versions :func:`hessian_apply_sparse_plain` /
  :func:`kirchhoff_apply_sparse_plain`, which keep the TPU kernels'
  arithmetic.  A CPU tensor runs the plain version; a CUDA tensor
  launches the kernel (float32, contiguous) or raises.
  ``<wrapper>.launches`` counts kernel launches (one per build for
  :func:`pair_csr`, whose kernel runs in two passes);
  ``pair_csr.table_launches`` and ``hessian_apply_dense.table_launches``
  those through the table branch (``table_compact``).
* Patch overlays never reach a kernel: every operator runs the base
  family and adds the sparse correction :func:`overlay_apply_hessian` /
  :func:`overlay_apply_kirchhoff` over the pairs an overlay can touch.
* Chebyshev-filtered subspace iteration: :func:`lowest_modes_matfree`,
  :func:`lowest_modes_matfree_gnm` (and :func:`estimate_lambda_max`).
* Deflated, block-Jacobi-preconditioned CG with per-column step sizes:
  :func:`covariance_solve_matfree`, :func:`covariance_solve_matfree_gnm`,
  :func:`linear_response_matfree`, :func:`prs_rows_matfree`,
  :func:`dcc_rows_matfree`, :func:`dcc_rows_matfree_gnm`.
* Effector/sensor profiles and the stochastic estimators, float64 on
  the coordinates' device around one batched CG each:
  :func:`prs_diag_from_modes`, :func:`effector_sensor_from_modes`
  (rank-k mode sums, no CG), :func:`effector_sensor_matfree` (exact at
  sites), :func:`prs_diag_stochastic`, :func:`msf_stochastic`,
  :func:`msf_stochastic_gnm`, :func:`effector_sensor_stochastic`
  (Rademacher probes drawn as the JAX package draws them).

Routing (the JAX package's ``use_pallas = backend == "tpu"``, read as
CUDA): float32 coordinates on CUDA take the kernels — the pair CSR once
per solver and K13 / K14 over it on every apply when the family has a
cutoff (``sparse`` default), the dense-grid K12 otherwise — and keep the
TPU's oversampling default ``max(k, 8, 48 - k)``; every other dtype or
device runs the plain versions (the tile walk on the block-sparse
route).  GNM without ``sparse`` stays on the plain :func:`kirchhoff_apply`,
as in JAX.  On the kernel route with the pair CSR the solvers read the
Gershgorin bound, the block-Jacobi diagonal and the degree off it
(float64 sums over the list, in its sorted order); elsewhere they take
the O(n^2) row-block passes, as the JAX package does.

In Morton order (the block-sparse solvers) the per-atom codes of a
tabulated family and the overlay masks are permuted with the atoms,
while the bonded test of the table lookup goes by original atom id, the
ids that also mask self-pairs and padding.

The solvers take the JAX package's ``use_pallas=`` (``False`` refused on
CUDA), ``matvec_precision="highest"`` and ``checkpoint=`` / ``retries=``:
the Chebyshev solvers run their outer loop through
:func:`..utils.elastic.resumable_loop` (with `checkpoint`, a snapshot of
the loop carry after every outer iteration; with `retries`, a retry of an
iteration that met a device failure).
"""

from __future__ import annotations

import functools
import typing

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ..utils import elastic
from ..utils.config import as_tensor, check_use_pallas, resolve_device
from . import rigid
from .assembly_kernels import _table_args
from .ffparams import (KERNEL_KINDS, FFParams, overlay_pair_delta,
                       rect_base_constants, strip_overlays)

__all__ = [
    "hessian_apply",
    "kirchhoff_apply",
    "overlay_apply_hessian",
    "overlay_apply_kirchhoff",
    "hessian_apply_dense",
    "hessian_apply_sparse",
    "kirchhoff_apply_sparse",
    "hessian_apply_pallas",
    "hessian_apply_pallas_sparse",
    "kirchhoff_apply_pallas_sparse",
    "hessian_apply_sparse_plain",
    "kirchhoff_apply_sparse_plain",
    "hessian_apply_dense_plain",
    "TileCSR",
    "tile_csr",
    "PairCSR",
    "pair_csr",
    "pair_csr_plain",
    "hessian_apply_pair_csr_plain",
    "kirchhoff_apply_pair_csr_plain",
    "spatial_sort_permutation",
    "tile_neighbor_lists",
    "estimate_lambda_max",
    "hessian_degree_bound",
    "hessian_diag_blocks",
    "kirchhoff_degree",
    "lowest_modes_matfree",
    "lowest_modes_matfree_gnm",
    "covariance_solve_matfree",
    "covariance_solve_matfree_gnm",
    "linear_response_matfree",
    "prs_rows_matfree",
    "dcc_rows_matfree",
    "dcc_rows_matfree_gnm",
    "matfree_mode_residuals",
    "prs_diag_from_modes",
    "effector_sensor_from_modes",
    "effector_sensor_matfree",
    "prs_diag_stochastic",
    "msf_stochastic",
    "msf_stochastic_gnm",
    "effector_sensor_stochastic",
]


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _check_params(params):
    kind = getattr(params, "kind", type(params).__name__)
    if isinstance(params, FFParams) and kind in KERNEL_KINDS:
        return
    if kind in KERNEL_KINDS:
        raise TypeError("params must be springcraft_tpu_torch FFParams "
                        "(see ops.ffparams.from_numpy_params)")
    raise ValueError(
        f"matrix-free path does not support kind={kind!r} (O(n^2) "
        f"parameters: use the dense assembly instead); it takes "
        f"{KERNEL_KINDS}, with or without patch overlays")


def _squared_distance(d):
    """``dx*dx + dy*dy + dz*dz`` in that order, as the kernels round it."""
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
        + d[..., 2] * d[..., 2]


def _rect_constants(sq, rows, cols, n, params, row_ids=None, col_ids=None):
    """Masked base-family force constants of a rectangular (R, C) block:
    `rows` / `cols` are atom slots (they index the per-atom codes of a
    tabulated family), `row_ids` / `col_ids` the atoms' original ids
    where the slots are a reordering (default: the slots themselves).
    Validity and the table's bonded test go by id; zeros beyond the
    cutoff, on self-pairs and on padding (id ``>= n``)."""
    rid = rows if row_ids is None else row_ids
    cid = cols if col_ids is None else col_ids
    k = rect_base_constants(params, sq, rows, cols, rid, cid)
    return torch.where(_interacting(sq, rid, cid, n, params), k,
                       torch.zeros_like(sq))


def _interacting(sq, rid, cid, n, params):
    """Which pairs of an (R, C) block interact, by the kernels' test:
    original ids `rid` / `cid` distinct and below `n` and, with a
    cutoff, ``sq <= cutoff_sq``."""
    valid = (rid[:, None] != cid[None, :]) \
        & (rid < n)[:, None] & (cid < n)[None, :]
    if params.has_cutoff:
        valid = valid & (sq <= params.cutoff_sq)
    return valid


def _coord(coord, dtype, device):
    coord = as_tensor(coord, dtype, device)
    if coord.ndim != 2 or coord.shape[1] != 3:
        raise ValueError(f"coord must be (n, 3), got {tuple(coord.shape)}")
    return coord


def _columns(x, rows, like, name="x"):
    """`x` (``(rows, k)`` or ``(rows,)``) as a 2-D tensor of `like`'s
    dtype on its device, and whether it was a vector: 3n rows for the xyz
    plane layout, n for Kirchhoff."""
    x = as_tensor(x, like.dtype, like.device)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[:, None]
    if x.ndim != 2 or x.shape[0] != rows:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{rows} rows")
    return x, squeeze


def _padded_rows(n, block, start, stop):
    """Rows to pad an ``(n, ...)`` array to: the columns' multiple of
    `block`, or past it the whole blocks of rows from `start` to
    `stop`."""
    return max(_round_up(n, block), start + _round_up(stop - start, block))


def _row_blocks(coord, params, block, start=0, stop=None):
    """Blocked row passes over all atom pairs of the base family (no
    overlays): yields ``(r0, d, sq, kmat)`` per block of `block` rows
    from `start` up to `stop` (default: all rows; ``d`` ``(block, n_pad,
    3)``, the masked constants ``kmat`` ``(block, n_pad)``), rows and
    columns padded to a multiple of `block`; a last block past `stop`
    holds the rows after it (or padding).  O(block * n) live memory."""
    params = strip_overlays(params)
    n = coord.shape[0]
    params._check_atoms(n)
    stop = n if stop is None else stop
    n_pad = _round_up(n, block)
    coord_p = F.pad(coord, (0, 0, 0, _padded_rows(n, block, start, stop)
                            - n))
    ids = torch.arange(coord_p.shape[0], device=coord.device)
    cols = ids[:n_pad]
    for r0 in range(start, stop, block):
        d = coord_p[r0:r0 + block, None, :] - coord_p[None, :n_pad, :]
        sq = _squared_distance(d)
        yield r0, d, sq, _rect_constants(sq, ids[r0:r0 + block], cols, n,
                                         params)


def _safe(sq):
    return torch.where(sq == 0, torch.ones_like(sq), sq)


# ---------------------------------------------------------------------------
# Plain row-blocked operators
# ---------------------------------------------------------------------------

def hessian_apply(coord, x, params, *, block=512, dtype=torch.float32,
                  device=None):
    """
    ``H @ x`` for the xyz-layout ANM Hessian, without materializing it:
    row-blocked, O(block * n) live memory, any dtype and device — the
    plain operator and the reference of the kernels.

    Parameters
    ----------
    coord : Tensor or ndarray, shape=(n, 3)
    x : Tensor or ndarray, shape=(3n, k) or (3n,)
        Block of vectors in xyz plane layout.
    params : FFParams
        An analytic family or ``table_compact``; patch overlays apply as
        a sparse correction (:func:`overlay_apply_hessian`).

    Returns
    -------
    y : Tensor, same shape as `x`, on `coord`'s device
    """
    _check_params(params)
    coord = _coord(coord, dtype, device)
    n = coord.shape[0]
    x, squeeze = _columns(x, 3 * n, coord)
    if params.overlays:
        y = hessian_apply(coord, x, strip_overlays(params), block=block,
                          dtype=dtype) \
            + overlay_apply_hessian(coord, x, params, dtype=dtype)
        return y[:, 0] if squeeze else y
    y = _hessian_apply_rows(coord, x, params, block, 0, n)
    y = y.reshape(3 * n, x.shape[1])
    return y[:, 0] if squeeze else y


def _hessian_apply_rows(coord, x, params, block, start, stop):
    """Rows ``start`` ... ``stop - 1`` of each plane of the base family's
    ``H @ x`` (`x` ``(3n, k)``), ``(3, stop - start, k)``: the row-blocked
    passes of :func:`hessian_apply` over those rows only."""
    n, k = coord.shape[0], x.shape[1]
    n_pad = _round_up(n, block)
    x_p = F.pad(x.reshape(3, n, k),
                (0, 0, 0, _padded_rows(n, block, start, stop) - n))
    out = []
    for r0, d, sq, kmat in _row_blocks(coord, params, block, start, stop):
        g = -kmat / _safe(sq)
        xr = x_p[:, r0:r0 + block]
        y = []
        for a in range(3):
            acc = torch.zeros_like(xr[0])
            for b in range(3):
                plane = g * d[..., a] * d[..., b]
                acc = acc + plane @ x_p[b, :n_pad]
                acc = acc - plane.sum(dim=1)[:, None] * xr[b]
            y.append(acc)
        out.append(torch.stack(y))
    return torch.cat(out, dim=1)[:, :stop - start]


def kirchhoff_apply(coord, x, params, *, block=512, dtype=torch.float32,
                    device=None):
    """``K @ x`` for the GNM Kirchhoff matrix without materializing it
    (row-blocked, any dtype); `x` is ``(n, k)`` or ``(n,)``.  Patch
    overlays apply as a sparse correction
    (:func:`overlay_apply_kirchhoff`)."""
    _check_params(params)
    coord = _coord(coord, dtype, device)
    n = coord.shape[0]
    x, squeeze = _columns(x, n, coord)
    if params.overlays:
        y = kirchhoff_apply(coord, x, strip_overlays(params), block=block,
                            dtype=dtype) \
            + overlay_apply_kirchhoff(coord, x, params, dtype=dtype)
        return y[:, 0] if squeeze else y
    n_pad = _round_up(n, block)
    x_p = F.pad(x, (0, 0, 0, n_pad - n))
    out = [-(kmat @ x_p) + kmat.sum(dim=1)[:, None] * x_p[r0:r0 + block]
           for r0, _, _, kmat in _row_blocks(coord, params, block)]
    y = torch.cat(out)[:n]
    return y[:, 0] if squeeze else y


def hessian_degree_bound(coord, params, *, masses=None, block=512,
                         dtype=torch.float32, device=None):
    """
    Guaranteed upper bound on the largest eigenvalue of the (optionally
    mass-weighted) ANM Hessian, by block-row Gershgorin:

        lambda_max <= max_i w_i * (sum_j k_ij w_j + w_i sum_j k_ij)

    with ``w = 1 / sqrt(masses)`` (ones without masses).  The Kirchhoff
    bound coincides.  One blocked pass; a 0-d tensor.  Patch overlays add
    ``max_i w_i (sum_j |delta_ij| w_j + w_i sum_j |delta_ij|)``: still an
    upper bound, possibly looser.
    """
    _check_params(params)
    coord = _coord(coord, dtype, device)
    n = coord.shape[0]
    w = (torch.ones(n, dtype=dtype, device=coord.device) if masses is None
         else 1.0 / torch.sqrt(as_tensor(masses, dtype, coord.device)))
    w_p = F.pad(w, (0, _round_up(n, block) - n))
    rows = []
    for r0, _, _, kmat in _row_blocks(coord, params, block):
        wr = w_p[r0:r0 + block]
        rows.append(wr * (kmat @ w_p + wr * kmat.sum(dim=1)))
    bound = torch.cat(rows).max()
    if params.overlays:
        ii, jj, delta, _, _ = overlay_pair_delta(coord, params)
        if ii.numel():
            ad = delta.abs()
            wsum = torch.zeros_like(w).index_add_(0, ii, ad * w[jj]) \
                .index_add_(0, jj, ad * w[ii])
            rsum = torch.zeros_like(w).index_add_(0, ii, ad) \
                .index_add_(0, jj, ad)
            bound = bound + (w * (wsum + w * rsum)).max()
    return bound


def hessian_diag_blocks(coord, params, *, block=512, dtype=torch.float32,
                        device=None):
    """The ``(n, 3, 3)`` diagonal superblocks of the ANM Hessian
    (``sum_j k_ij / d^2 d d^T``) in one blocked pass — the block-Jacobi
    preconditioner of :func:`covariance_solve_matfree`.  Patch overlays
    scatter their exact contribution in."""
    _check_params(params)
    coord = _coord(coord, dtype, device)
    n = coord.shape[0]
    out = []
    for _, d, sq, kmat in _row_blocks(coord, params, block):
        g = kmat / _safe(sq)
        out.append(torch.stack([
            torch.stack([(g * d[..., a] * d[..., b]).sum(dim=1)
                         for b in range(3)], dim=-1)
            for a in range(3)], dim=-2))
    blocks = torch.cat(out)[:n]
    if params.overlays:
        ii, jj, delta, disp, safe_sq = overlay_pair_delta(coord, params)
        if ii.numel():
            dd = (delta / safe_sq)[:, None, None] * disp[:, :, None] \
                * disp[:, None, :]
            blocks = blocks.index_add_(0, ii, dd).index_add_(0, jj, dd)
    return blocks


def kirchhoff_degree(coord, params, *, block=512, dtype=torch.float32,
                     device=None):
    """Per-atom Kirchhoff diagonal (the degree, ``sum_j k_ij``) by a
    blocked pass — the GNM Jacobi preconditioner.  O(n^2) work; patch
    overlays scatter their contribution in."""
    _check_params(params)
    coord = _coord(coord, dtype, device)
    deg = [kmat.sum(dim=1)
           for _, _, _, kmat in _row_blocks(coord, params, block)]
    deg = torch.cat(deg)[:coord.shape[0]]
    if params.overlays:
        ii, jj, delta, _, _ = overlay_pair_delta(coord, params)
        if ii.numel():
            deg = deg.index_add_(0, ii, delta).index_add_(0, jj, delta)
    return deg


def overlay_apply_hessian(coord, x, params, *, dtype=torch.float32,
                          pos=None, device=None):
    """``(Delta H) @ x`` for the sparse correction of the patch overlays
    in xyz layout, O(P k) for P affected pairs: what every matrix-free
    operator adds to its base-family apply.  `pos` ``(n,)`` maps slots
    to original atom positions where `coord`, `x` and the overlay masks
    are reordered (Morton order), for the bonded test of
    ``table_compact``.  Accumulates with ``index_add_``: float32 sums in
    no fixed order."""
    coord = _coord(coord, dtype, device)
    n = coord.shape[0]
    x, squeeze = _columns(x, 3 * n, coord)
    k = x.shape[1]
    xb = x.reshape(3, n, k)
    ii, jj, delta, disp, safe_sq = overlay_pair_delta(coord, params,
                                                      pos=pos)
    y = torch.zeros_like(xb)
    if ii.numel():
        diff = xb[:, ii] - xb[:, jj]                        # (3, P, k)
        s = (delta / safe_sq)[:, None] * sum(
            disp[:, a, None] * diff[a] for a in range(3))   # (P, k)
        for a in range(3):
            contrib = disp[:, a, None] * s
            y[a].index_add_(0, ii, contrib).index_add_(0, jj, -contrib)
    y = y.reshape(3 * n, k)
    return y[:, 0] if squeeze else y


def overlay_apply_kirchhoff(coord, x, params, *, dtype=torch.float32,
                            pos=None, device=None):
    """``(Delta K) @ x``, the GNM twin of :func:`overlay_apply_hessian`
    (`x`: ``(n, k)`` or ``(n,)``)."""
    coord = _coord(coord, dtype, device)
    x, squeeze = _columns(x, coord.shape[0], coord)
    ii, jj, delta, _, _ = overlay_pair_delta(coord, params, pos=pos)
    y = torch.zeros_like(x)
    if ii.numel():
        t = delta[:, None] * (x[ii] - x[jj])
        y.index_add_(0, ii, t).index_add_(0, jj, -t)
    return y[:, 0] if squeeze else y


def matfree_mode_residuals(coord, params, eig_values, eig_vectors, *,
                           masses=None, block=512, dtype=torch.float32,
                           device=None):
    """Relative eigenpair residuals ``|H u - lambda u| / |lambda|`` of
    modes in rows (``(k, 3n)``) through the plain operator — a post-hoc
    check without the dense Hessian."""
    coord = _coord(coord, dtype, device)
    u = as_tensor(eig_vectors, dtype, coord.device).T
    if masses is not None:
        w3 = (1.0 / torch.sqrt(as_tensor(masses, dtype,
                                         coord.device))).repeat(3)
        hu = w3[:, None] * hessian_apply(coord, w3[:, None] * u, params,
                                         block=block, dtype=dtype)
    else:
        hu = hessian_apply(coord, u, params, block=block, dtype=dtype)
    lam = as_tensor(eig_values, dtype, coord.device)
    r = hu - u * lam[None, :]
    return torch.linalg.vector_norm(r, dim=0) \
        / torch.clamp(lam.abs(), min=1e-30)


# ---------------------------------------------------------------------------
# Host set-up: Morton order, tile neighbour lists, the tile-pair CSR
# ---------------------------------------------------------------------------

def _part1by2(v):
    """Spread the lower 21 bits of `v` so consecutive bits are 3 apart
    (uint64 Morton helper)."""
    v = v.astype(np.uint64) & np.uint64(0x1FFFFF)
    v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
    return v


def spatial_sort_permutation(coord, cell=8.0):
    """Permutation ordering atoms along a Morton (Z-order) curve over
    `cell`-sized grid cells, so that consecutive atoms — and hence the
    kernels' tiles — are spatially compact.  Host-side (numpy)."""
    coord = np.asarray(coord, dtype=np.float64)
    q = np.floor((coord - coord.min(axis=0)) / float(cell))
    q = np.clip(q, 0, 2**21 - 1).astype(np.uint64)
    key = (_part1by2(q[:, 0])
           | (_part1by2(q[:, 1]) << np.uint64(1))
           | (_part1by2(q[:, 2]) << np.uint64(2)))
    return np.argsort(key, kind="stable")


def tile_neighbor_lists(coord, cutoff, tile=256):
    """
    Tile-level neighbour lists: for each row tile, the column tiles whose
    axis-aligned bounding boxes are within `cutoff` — a superset of the
    interacting pairs (the kernels still apply the exact per-pair
    cutoff).  Effective on spatially ordered atoms.

    Returns
    -------
    nbr : ndarray, shape=(n_tiles, max_nbrs), int32
        Neighbour tile indices, rows padded with the row's own index.
    counts : ndarray, shape=(n_tiles,), int32
        Number of valid entries per row.
    """
    coord = np.asarray(coord, dtype=np.float64)
    n = coord.shape[0]
    n_tiles = _round_up(n, tile) // tile
    mins = np.empty((n_tiles, 3))
    maxs = np.empty((n_tiles, 3))
    for t in range(n_tiles):
        blk = coord[t * tile:min((t + 1) * tile, n)]
        mins[t] = blk.min(axis=0)
        maxs[t] = blk.max(axis=0)
    gap = np.maximum(mins[:, None, :] - maxs[None, :, :],
                     mins[None, :, :] - maxs[:, None, :])
    gap = np.maximum(gap, 0.0)
    adj = np.sum(gap * gap, axis=-1) <= float(cutoff) ** 2
    np.fill_diagonal(adj, True)
    counts = adj.sum(axis=1).astype(np.int32)
    nbr = np.empty((n_tiles, int(counts.max())), dtype=np.int32)
    for t in range(n_tiles):
        idx = np.where(adj[t])[0]
        nbr[t, :len(idx)] = idx
        nbr[t, len(idx):] = t
    return nbr, counts


def _flatten_pairs(nbr, counts, n_tiles):
    """Row-sorted flattened pair list ``(pair_rows, pair_cols)`` from
    tile neighbour lists."""
    nbr = np.asarray(nbr)
    counts = np.asarray(counts)
    if nbr.ndim != 2 or nbr.shape[0] != n_tiles \
            or counts.shape != (n_tiles,):
        raise ValueError(
            f"nbr {nbr.shape} / counts {counts.shape} do not describe "
            f"{n_tiles} tiles — rebuild with tile_neighbor_lists(coord, "
            f"cutoff, tile)")
    if np.any(counts < 1) or np.any(counts > nbr.shape[1]):
        raise ValueError(f"counts must lie in [1, {nbr.shape[1]}]")
    pair_rows = np.repeat(np.arange(n_tiles, dtype=np.int32),
                          counts.astype(np.int64))
    pair_cols = np.concatenate(
        [nbr[t, :counts[t]] for t in range(n_tiles)]).astype(np.int32)
    if np.any(pair_cols < 0) or np.any(pair_cols >= n_tiles):
        raise ValueError(f"neighbour tiles must lie in [0, {n_tiles})")
    return pair_rows, pair_cols


class TileCSR(typing.NamedTuple):
    """Row-sorted tile pairs on the device: row tile ``t`` visits column
    tiles ``cols[row_ptr[t]:row_ptr[t + 1]]``; ``ids`` ``(n,)`` holds
    each slot's original atom index (self-pair and padding masks)."""

    row_ptr: torch.Tensor
    cols: torch.Tensor
    ids: torch.Tensor


def tile_csr(nbr, counts, orig_ids, n, tile, device):
    """:class:`TileCSR` of tile neighbour lists (int32, on `device`);
    `orig_ids` defaults to ``arange(n)`` (unsorted layout)."""
    n_tiles = _round_up(n, tile) // tile
    _, cols = _flatten_pairs(nbr, counts, n_tiles)
    row_ptr = np.zeros(n_tiles + 1, dtype=np.int32)
    row_ptr[1:] = np.cumsum(np.asarray(counts, dtype=np.int64))
    if orig_ids is None:
        ids = torch.arange(n, dtype=torch.int32, device=device)
    else:
        ids = as_tensor(orig_ids, torch.int32, device).contiguous()
        if ids.shape != (n,):
            raise ValueError(f"orig_ids must be ({n},), got "
                             f"{tuple(ids.shape)}")
    return TileCSR(torch.as_tensor(row_ptr, device=device),
                   torch.as_tensor(cols, device=device), ids)


def _dense_csr(n, tile, device):
    """Every column tile for every row tile, ids ``arange(n)``: the
    dense grid of K12 as a CSR."""
    n_tiles = _round_up(n, tile) // tile
    nbr = np.tile(np.arange(n_tiles, dtype=np.int32), (n_tiles, 1))
    return tile_csr(nbr, np.full(n_tiles, n_tiles, np.int32), None, n,
                    tile, device)


# ---------------------------------------------------------------------------
# Plain versions of the kernels: the tile walk, row tile by row tile
# ---------------------------------------------------------------------------

def _tile_pairs(coord, csr, tile, params, tiles=None):
    """Per row tile (of `tiles`, default all): ``(rows, slots, d, sq,
    valid, kmat)`` over the
    gathered slots ``slots`` ``(C,)`` of its neighbour tiles (``d``
    ``(tile, C, 3)``, ``valid`` the kernels' test by original id, cutoff
    and padding, ``kmat`` the base family's constants masked by it), on
    coordinates and ids padded to whole tiles (padding slots carry id
    ``n``).  A tabulated family's codes are read by slot, its bonded
    test goes by id."""
    params = strip_overlays(params)
    n = coord.shape[0]
    params._check_atoms(n)
    n_pad = _round_up(n, tile)
    coord_p = F.pad(coord, (0, 0, 0, n_pad - n))
    ids = F.pad(csr.ids, (0, n_pad - n), value=n)
    offs = torch.arange(tile, device=coord.device)
    ptr = csr.row_ptr.tolist()
    for t in range(n_pad // tile) if tiles is None else tiles:
        rows = slice(t * tile, (t + 1) * tile)
        slots = (csr.cols[ptr[t]:ptr[t + 1]].long()[:, None] * tile
                 + offs).reshape(-1)
        d = coord_p[rows, None, :] - coord_p[None, slots, :]
        sq = _squared_distance(d)
        rid, cid = ids[rows].long(), ids[slots].long()
        valid = _interacting(sq, rid, cid, n, params)
        kmat = torch.where(valid, rect_base_constants(
            params, sq, t * tile + offs, slots, rid, cid),
            torch.zeros_like(sq))
        yield rows, slots, d, sq, valid, kmat


def hessian_apply_sparse_plain(coord, x, params, csr, tile):
    """Plain version of K13 (and, over :func:`_dense_csr`, of K12):
    ``H @ x`` for `coord` ``(n, 3)`` and `x` ``(3n, k)`` by the TPU
    kernel's arithmetic — per row tile, the nine component planes over
    its neighbour tiles contracted with X, the row sums applied last.
    The base family of `params` (a tabulated one in the order of
    `coord`); overlays are the caller's correction."""
    return _sparse_plain_rows(coord, x, params, csr, tile, 0, coord.shape[0])


def _sparse_plain_rows(coord, x, params, csr, tile, row_start, n_rows):
    """Rows ``row_start`` ... ``row_start + n_rows - 1`` of each plane of
    :func:`hessian_apply_sparse_plain`, ``(3 n_rows, k)``: the row tiles
    that meet them."""
    n = coord.shape[0]
    k = x.shape[-1]
    n_pad = _round_up(n, tile)
    x_p = F.pad(x.reshape(3, n, k), (0, 0, 0, n_pad - n))
    t0 = row_start // tile
    t1 = _round_up(row_start + n_rows, tile) // tile
    base = t0 * tile
    out = x_p.new_empty((3, (t1 - t0) * tile, k))
    for rows, slots, d, sq, _, kmat in _tile_pairs(coord, csr, tile, params,
                                                   range(t0, t1)):
        g = -kmat / _safe(sq)
        xc = x_p[:, slots]
        local = slice(rows.start - base, rows.stop - base)
        for a in range(3):
            planes = [g * d[..., a] * d[..., b] for b in range(3)]
            acc = sum(planes[b] @ xc[b] for b in range(3))
            for b in range(3):
                acc = acc - planes[b].sum(dim=1)[:, None] * x_p[b, rows]
            out[a, local] = acc
    lo = row_start - base
    return out[:, lo:lo + n_rows].reshape(3 * n_rows, k)


def _row_range(n, row_start, n_rows):
    """`n_rows` (default: the rows from `row_start` to the end), checked
    to lie inside ``[0, n)``."""
    n_rows = n - row_start if n_rows is None else n_rows
    if not 0 <= row_start <= n - n_rows or n_rows < 0:
        raise ValueError(f"row range [{row_start}, {row_start + n_rows}) "
                         f"outside the {n} atoms")
    return n_rows


def _plane_rows(y, n, row_start, n_rows):
    """Rows ``row_start`` ... ``row_start + n_rows - 1`` of each plane of
    `y` ``(3n, k)``, as ``(3 n_rows, k)``."""
    k = y.shape[-1]
    return y.reshape(3, n, k)[:, row_start:row_start + n_rows]\
        .reshape(3 * n_rows, k)


def hessian_apply_dense_plain(coord, x, params, tile=256, row_start=0,
                              n_rows=None):
    """Plain version of K12: :func:`hessian_apply_sparse_plain` over the
    dense grid of tiles with ids ``arange(n)``; with a row range only the
    rows ``row_start`` ... ``row_start + n_rows - 1`` of each plane,
    ``(3 n_rows, k)``, against every column atom."""
    n = coord.shape[0]
    n_rows = _row_range(n, row_start, n_rows)
    return _sparse_plain_rows(coord, x, params,
                              _dense_csr(n, tile, coord.device), tile,
                              row_start, n_rows)


def kirchhoff_apply_sparse_plain(coord, x, params, csr, tile):
    """Plain version of K14: ``K @ x`` (`x` ``(n, k)``) by the TPU
    kernel's arithmetic, ``-K_off @ x`` over the neighbour tiles, then
    ``+ deg * x``."""
    n = coord.shape[0]
    n_pad = _round_up(n, tile)
    x_p = F.pad(x, (0, 0, 0, n_pad - n))
    out = torch.empty_like(x_p)
    for rows, slots, _, _, _, kmat in _tile_pairs(coord, csr, tile,
                                                  params):
        out[rows] = -(kmat @ x_p[slots]) + kmat.sum(dim=1)[:, None] \
            * x_p[rows]
    return out[:n]


# ---------------------------------------------------------------------------
# The pair CSR: every interacting pair of the tile CSR, built once per set-up
# ---------------------------------------------------------------------------

#: Warps of the tile walk's blocks (``kWalkWarps`` in
#: ``csrc/tile_walk.cuh``): warp ``w`` takes the column atoms whose offset
#: in their tile is ``w`` modulo 4, and a row's pairs in the pair CSR are
#: warp 0's, then warp 1's, ..., each in walk order.
_WALK_WARPS = 4


class PairCSR(typing.NamedTuple):
    """Every ordered pair ``(i, j)`` that interacts, by row: row ``i``
    (a slot of the Morton order) holds ``slots[row_ptr[i]:row_ptr[i +
    1]]`` with spring constants ``k`` (the base family's, no overlays);
    ``row_ptr`` ``(n + 1,)`` and ``slots`` ``(P,)`` int32, ``k`` ``(P,)``
    in the working dtype."""

    row_ptr: torch.Tensor
    slots: torch.Tensor
    k: torch.Tensor


def pair_csr_plain(coord, params, csr, tile):
    """Plain version of the pair-CSR build: the pairs of the plain tile
    walk (:func:`_tile_pairs`) that pass the kernels' test, each row in
    the kernel's order (by walk warp, then by walk position), in the
    dtype of `coord`."""
    n = coord.shape[0]
    rows, slots, ks = [], [], []
    for row_slice, cols, _, _, valid, kmat in _tile_pairs(coord, csr, tile,
                                                          params):
        r, v = torch.nonzero(valid, as_tuple=True)
        warp = v % tile % _WALK_WARPS
        order = torch.argsort((r * _WALK_WARPS + warp) * cols.numel() + v)
        r, v = r[order], v[order]
        rows.append(r + row_slice.start)
        slots.append(cols[v])
        ks.append(kmat[r, v])
    row_ptr = torch.zeros(n + 1, dtype=torch.int64, device=coord.device)
    row_ptr[1:] = torch.cumsum(torch.bincount(torch.cat(rows), minlength=n),
                               0)
    return PairCSR(row_ptr.to(torch.int32), torch.cat(slots).to(torch.int32),
                   torch.cat(ks))


def _pair_rows(pairs):
    """The row of every pair of `pairs` (int64)."""
    n = pairs.row_ptr.numel() - 1
    return torch.repeat_interleave(
        torch.arange(n, device=pairs.row_ptr.device),
        torch.diff(pairs.row_ptr.long()))


def hessian_apply_pair_csr_plain(coord, x, pairs):
    """Plain version of K13 over the pair CSR: ``H @ x`` (x ``(3n, k)``)
    by ``index_add_`` over the list, ``y_i = sum_j g d (d . x_j)`` and the
    diagonal blocks ``D_i = sum_j g d d^T``, then ``y_i -= D_i x_i``."""
    n, k = coord.shape[0], x.shape[-1]
    i, j = _pair_rows(pairs), pairs.slots.long()
    d = coord[i] - coord[j]
    g = -pairs.k / _safe(_squared_distance(d))
    xb = x.reshape(3, n, k)
    s = sum(d[:, a, None] * xb[a, j] for a in range(3))          # (P, k)
    gd = g[:, None] * d                                         # (P, 3)
    blocks = torch.zeros((n, 3, 3), dtype=x.dtype, device=x.device)\
        .index_add_(0, i, gd[:, :, None] * d[:, None, :])
    y = torch.zeros_like(xb)
    for a in range(3):
        y[a].index_add_(0, i, gd[:, a, None] * s)
        y[a] -= sum(blocks[:, a, b, None] * xb[b] for b in range(3))
    return y.reshape(3 * n, k)


def kirchhoff_apply_pair_csr_plain(coord, x, pairs):
    """Plain version of K14 over the pair CSR: ``K @ x`` (x ``(n, k)``),
    ``-sum_j k_ij x_j`` by ``index_add_``, then ``+ deg_i x_i``."""
    n = coord.shape[0]
    i, j = _pair_rows(pairs), pairs.slots.long()
    deg = torch.zeros(n, dtype=x.dtype, device=x.device)\
        .index_add_(0, i, pairs.k)
    return torch.zeros_like(x).index_add_(0, i, -pairs.k[:, None] * x[j]) \
        + deg[:, None] * x


# ---------------------------------------------------------------------------
# Degree passes over the pair CSR (the kernel route's set-up)
# ---------------------------------------------------------------------------
#
# What :func:`hessian_degree_bound`, :func:`hessian_diag_blocks` and
# :func:`kirchhoff_degree` compute by O(n^2) row blocks, read off the pair
# CSR that the kernel route builds anyway: in its Morton order, `params`
# permuted with the atoms and `pos` the original positions (the bonded
# test of the overlays' ``table_compact`` lookup).  Sums in float64,
# rounded once to the dtype of `coord`; the overlays add their delta.

def _row_sums(rows, values, n):
    """Float64 sums of `values` ``(P, ...)`` by row ``rows`` ``(P,)``."""
    return torch.zeros((n,) + values.shape[1:], dtype=torch.float64,
                       device=values.device).index_add_(0, rows,
                                                        values.double())


def _overlay_delta64(coord, params, pos):
    """``(ii, jj, delta, disp, safe_sq)`` of the overlays in float64, or
    None without overlay pairs."""
    if not params.overlays:
        return None
    ii, jj, delta, disp, safe_sq = overlay_pair_delta(coord, params, pos=pos)
    if not ii.numel():
        return None
    return ii, jj, delta.double(), disp.double(), safe_sq.double()


def _pair_degree(coord, params, pairs, pos):
    """The Kirchhoff degree ``sum_j k_ij`` ``(n,)`` from `pairs`."""
    deg = _row_sums(_pair_rows(pairs), pairs.k, coord.shape[0])
    over = _overlay_delta64(coord, params, pos)
    if over is not None:
        ii, jj, delta = over[:3]
        deg.index_add_(0, ii, delta).index_add_(0, jj, delta)
    return deg.to(coord.dtype)


def _pair_degree_bound(coord, params, pairs, masses, pos):
    """:func:`hessian_degree_bound` from `pairs`: ``max_i w_i (sum_j k_ij
    w_j + w_i sum_j k_ij)``, plus the overlays' ``max_i w_i (sum_j
    |delta_ij| w_j + w_i sum_j |delta_ij|)``; a 0-d tensor."""
    n = coord.shape[0]
    w = (torch.ones(n, dtype=torch.float64, device=coord.device)
         if masses is None else 1.0 / torch.sqrt(masses.double()))
    rows, cols = _pair_rows(pairs), pairs.slots.long()
    k = pairs.k.double()
    bound = (w * (_row_sums(rows, k * w[cols], n)
                  + w * _row_sums(rows, k, n))).max()
    over = _overlay_delta64(coord, params, pos)
    if over is not None:
        ii, jj, delta = over[:3]
        ad = delta.abs()
        wsum = torch.zeros_like(w).index_add_(0, ii, ad * w[jj]) \
            .index_add_(0, jj, ad * w[ii])
        rsum = torch.zeros_like(w).index_add_(0, ii, ad) \
            .index_add_(0, jj, ad)
        bound = bound + (w * (wsum + w * rsum)).max()
    return bound.to(coord.dtype)


def _pair_diag_blocks(coord, params, pairs, pos):
    """:func:`hessian_diag_blocks` from `pairs`: ``(n, 3, 3)``, ``sum_j
    k_ij / d^2 d d^T`` with ``d = r_i - r_j`` in float64."""
    rows, cols = _pair_rows(pairs), pairs.slots.long()
    c = coord.double()
    d = c[rows] - c[cols]
    g = pairs.k.double() / _safe(_squared_distance(d))
    blocks = _row_sums(rows, g[:, None, None] * d[:, :, None]
                       * d[:, None, :], coord.shape[0])
    over = _overlay_delta64(coord, params, pos)
    if over is not None:
        ii, jj, delta, disp, safe_sq = over
        dd = (delta / safe_sq)[:, None, None] * disp[:, :, None] \
            * disp[:, None, :]
        blocks.index_add_(0, ii, dd).index_add_(0, jj, dd)
    return blocks.to(coord.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers (the pair CSR, K12, K13, K14)
# ---------------------------------------------------------------------------

#: Columns of X per block of K12 (``kMaxCols`` in
#: ``csrc/matfree_hessian.cu``: wider X takes the fewest equal column
#: chunks of at most 64) and per warp of the gathers K13, K14
#: (``kGatherCols`` in ``csrc/pair_gather.cuh``), and the grid's y limit
#: on the chunks.
_DENSE_COLS = 64
_GATHER_COLS = 64
_MAX_GRID_Y = 65535
#: Most bin edges the kernels stage (``kMaxEdges`` in ``csrc/spring.cuh``).
_MAX_EDGES = 64


def _check_kernel_shape(name, coord, x, cols_per_block):
    n, k = coord.shape[0], x.shape[1]
    if k > _MAX_GRID_Y * cols_per_block or 3 * n >= 2**31:
        raise ValueError(f"{name}: (n, k) = ({n}, {k}) exceeds the kernel's "
                         f"limits (k <= {_MAX_GRID_Y * cols_per_block}: "
                         f"{_MAX_GRID_Y} column chunks of at most "
                         f"{cols_per_block}; 3n < 2^31)")


def _kernel_args(params, n, device):
    """Family arguments of the walking kernels (the pair-CSR build, K12):
    kind, cutoff, and the table branch's pointers (the per-atom codes in
    the order of `coord`)."""
    if params.kind == "table_compact" and params.edges_sq is not None \
            and len(params.edges_sq) > _MAX_EDGES:
        raise ValueError(f"the matrix-free kernels stage at most "
                         f"{_MAX_EDGES} bin edges, got "
                         f"{len(params.edges_sq)}")
    return (params.kind_code,
            float(params.cutoff_sq) if params.has_cutoff else 0.0,
            int(params.has_cutoff), *_table_args(params, n, device))


def _with_overlay_apply(base, overlay_apply, coord, params, pos):
    """``x -> base(x) + (Delta) x``: the base-family apply `base` with
    the overlays' sparse correction behind it (`base` itself without
    overlays)."""
    if not params.overlays:
        return base
    return lambda x: base(x) + overlay_apply(coord, x, params,
                                             dtype=coord.dtype, pos=pos)


def pair_csr(coord, params, csr, tile=256):
    """
    The pair CSR of `coord` ``(n, 3)`` (Morton order) over the tile
    neighbour pairs `csr` (:func:`tile_csr` at `tile`): every ordered
    pair that passes the test of the TPU kernels, with the base family's
    spring constant (overlays are the caller's correction).  Built once
    per solver set-up; K13 and K14 gather over it on every apply.

    A CPU tensor runs :func:`pair_csr_plain`; a CUDA tensor launches the
    kernel (float32; ``csrc/matfree_pairs.cu``: a counting pass, one
    cumulative sum, a writing pass) or raises.  ``pair_csr.launches``
    counts builds, ``.table_launches`` those through the table branch.
    """
    _check_params(params)
    _check_tile(tile)
    params = strip_overlays(params)
    n = coord.shape[0]
    n_tiles = _round_up(n, tile) // tile
    if csr.ids.shape != (n,) or csr.row_ptr.shape != (n_tiles + 1,):
        raise ValueError(f"pair_csr: the tile CSR (ids {tuple(csr.ids.shape)},"
                         f" row_ptr {tuple(csr.row_ptr.shape)}) does not "
                         f"describe {n} atoms in tiles of {tile}")
    if _build.route("pair_csr", coord, *csr) == "cpu":
        return pair_csr_plain(coord, params, csr, tile)
    _build.require_cuda_f32("pair_csr", coord=coord)
    if 3 * n >= 2**31:
        raise ValueError(f"pair_csr: n = {n} exceeds the kernel's limit "
                         f"(3n < 2^31)")
    walk = (coord.data_ptr(), csr.ids.data_ptr(), csr.row_ptr.data_ptr(),
            csr.cols.data_ptr())
    family = _kernel_args(params, n, coord.device)
    counts = torch.empty(_WALK_WARPS * n, dtype=torch.int32,
                         device=coord.device)
    _build.launch("sc_pair_csr_count", coord.device, *walk,
                  counts.data_ptr(), n, tile, *family)
    offsets = torch.zeros(_WALK_WARPS * n + 1, dtype=torch.int64,
                          device=coord.device)
    offsets[1:] = torch.cumsum(counts, 0)
    total = int(offsets[-1])
    if total >= 2**31:
        raise ValueError(f"pair_csr: {total} pairs exceed the kernel's "
                         f"int32 offsets")
    offsets = offsets.to(torch.int32)
    slots = torch.empty(total, dtype=torch.int32, device=coord.device)
    k = torch.empty(total, dtype=torch.float32, device=coord.device)
    _build.launch("sc_pair_csr_fill", coord.device, *walk,
                  offsets.data_ptr(), slots.data_ptr(), k.data_ptr(), n,
                  tile, *family)
    pair_csr.launches += 1
    pair_csr.table_launches += params.kind == "table_compact"
    return PairCSR(offsets[::_WALK_WARPS].contiguous(), slots, k)


def _check_pairs(name, coord, x, pairs):
    """Raise unless `pairs` is a pair CSR of `coord`'s atoms, int32 and
    contiguous, with constants in `x`'s dtype."""
    n = coord.shape[0]
    if pairs.row_ptr.shape != (n + 1,) or pairs.slots.ndim != 1 \
            or pairs.k.shape != pairs.slots.shape:
        raise ValueError(f"{name}: the pair list (row_ptr "
                         f"{tuple(pairs.row_ptr.shape)}, slots "
                         f"{tuple(pairs.slots.shape)}, k "
                         f"{tuple(pairs.k.shape)}) does not fit {n} atoms")
    if pairs.row_ptr.dtype != torch.int32 or pairs.slots.dtype != torch.int32:
        raise TypeError(f"{name}: row_ptr and slots must be int32")
    if pairs.k.dtype != x.dtype:
        raise TypeError(f"{name}: the pair list's constants are "
                        f"{pairs.k.dtype}, x is {x.dtype}")
    if not (pairs.row_ptr.is_contiguous() and pairs.slots.is_contiguous()
            and pairs.k.is_contiguous()):
        raise ValueError(f"{name}: the pair list must be contiguous")


def _apply_pairs(wrapper, coord, x, pairs):
    """One K13 (`wrapper` :func:`hessian_apply_sparse`, x ``(3n, k)``) or
    K14 (:func:`kirchhoff_apply_sparse`, x ``(n, k)``) apply over
    `pairs`: the plain version on the CPU, the gather kernel on CUDA."""
    name = wrapper.__name__
    node = wrapper is kirchhoff_apply_sparse
    _check_pairs(name, coord, x, pairs)
    if _build.route(name, coord, x, *pairs) == "cpu":
        plain = (kirchhoff_apply_pair_csr_plain if node
                 else hessian_apply_pair_csr_plain)
        return plain(coord, x, pairs)
    _build.require_cuda_f32(name, coord=coord, x=x)
    _check_kernel_shape(name, coord, x, _GATHER_COLS)
    n, k = coord.shape[0], x.shape[1]
    out = torch.empty_like(x)
    lists = (pairs.row_ptr.data_ptr(), pairs.slots.data_ptr(),
             pairs.k.data_ptr(), x.data_ptr(), out.data_ptr(), n, k)
    if node:
        _build.launch("sc_kirchhoff_apply_pairs", coord.device, *lists)
    else:
        _build.launch("sc_hessian_apply_pairs", coord.device,
                      coord.data_ptr(), *lists)
    wrapper.launches += 1
    return out


def _sparse_apply(wrapper, coord, x, params, csr, tile):
    """The public block-sparse apply: the tile walk's plain version on
    the CPU; on CUDA the pair CSR is built and the gather launched in
    one call.  Patch overlays follow as the sparse correction, `csr`'s
    ids giving the original positions."""
    node = wrapper is kirchhoff_apply_sparse
    name = wrapper.__name__
    if _build.route(name, coord, x, *csr) == "cpu":
        apply = functools.partial(
            kirchhoff_apply_sparse_plain if node
            else hessian_apply_sparse_plain, coord, params=params, csr=csr,
            tile=tile)
    else:
        _build.require_cuda_f32(name, coord=coord, x=x)
        pairs = pair_csr(coord, params, csr, tile)
        apply = functools.partial(_apply_pairs, wrapper, coord, pairs=pairs)
    return _with_overlay_apply(
        apply, overlay_apply_kirchhoff if node else overlay_apply_hessian,
        coord, params, csr.ids)(x)


def _launch_dense(coord, x, params, tile, row_start=0, n_rows=None):
    """Route one dense-grid Hessian apply (x ``(3n, k)``) over the rows
    ``row_start`` ... ``row_start + n_rows - 1`` of each plane (default:
    all), ``(3 n_rows, k)``: the plain version on the CPU, K12 on CUDA.
    Patch overlays follow the base-family apply as a sparse correction,
    of which the range keeps its rows."""
    n = coord.shape[0]
    n_rows = _row_range(n, row_start, n_rows)
    if params.overlays:
        base = _launch_dense(coord, x, strip_overlays(params), tile,
                             row_start, n_rows)
        delta = overlay_apply_hessian(coord, x, params, dtype=coord.dtype)
        return base + _plane_rows(delta, n, row_start, n_rows)
    name = "hessian_apply_dense"
    if _build.route(name, coord, x) == "cpu":
        return hessian_apply_dense_plain(coord, x, params, tile, row_start,
                                         n_rows)
    _build.require_cuda_f32(name, coord=coord, x=x)
    _check_kernel_shape(name, coord, x, _DENSE_COLS)
    k = x.shape[1]
    out = x.new_empty((3 * n_rows, k))
    _build.launch("sc_hessian_apply_dense", coord.device, coord.data_ptr(),
                  x.data_ptr(), out.data_ptr(), n, k, row_start, n_rows,
                  *_kernel_args(params, n, coord.device))
    hessian_apply_dense.launches += 1
    hessian_apply_dense.table_launches += params.kind == "table_compact"
    return out


def _check_tile(tile):
    if int(tile) != tile or tile < 1:
        raise ValueError(f"tile must be a positive int, got {tile!r}")


def hessian_apply_sparse(coord, x, params, nbr, counts, orig_ids=None,
                         tile=256, *, dtype=torch.float32, device=None):
    """
    Block-sparse matrix-free ``H @ x`` (K13): only the pairs within the
    cutoff of the tile pairs of :func:`tile_neighbor_lists` do work.

    Parameters
    ----------
    coord : Tensor or ndarray, shape=(n, 3)
        Atom coordinates, ideally spatially sorted
        (:func:`spatial_sort_permutation`).
    x : Tensor or ndarray, shape=(3n, k) or (3n,)
        Vectors in xyz plane layout (the same order as `coord`).
    nbr, counts : ndarray
        Tile neighbour lists of `coord` at `tile`.
    orig_ids : array, shape=(n,), optional
        Original atom index of each slot; defaults to ``arange(n)``.

    Returns
    -------
    y : Tensor, same shape as `x`.  A CPU tensor runs the plain tile
    walk; a CUDA tensor (float32, contiguous) builds the pair CSR and
    launches the gather, or raises.  The solvers build the pair CSR once
    and apply it many times.
    """
    _check_params(params)
    _check_tile(tile)
    coord = _coord(coord, dtype, device)
    n = coord.shape[0]
    xb, squeeze = _columns(x, 3 * n, coord)
    csr = tile_csr(nbr, counts, orig_ids, n, tile, coord.device)
    y = _sparse_apply(hessian_apply_sparse, coord, xb, params, csr, tile)
    return y[:, 0] if squeeze else y


def hessian_apply_dense(coord, x, params, tile=256, *, dtype=torch.float32,
                        device=None):
    """Dense-grid matrix-free ``H @ x`` (K12): every pair is tested —
    the route of the families without a cutoff and of ``sparse=False``.
    `tile` blocks the plain version's rows; the kernel tiles rows and
    column atoms by 32 itself.  A CPU tensor runs the plain
    version; a CUDA tensor launches the kernel (float32, contiguous) or
    raises."""
    _check_params(params)
    _check_tile(tile)
    coord = _coord(coord, dtype, device)
    n = coord.shape[0]
    xb, squeeze = _columns(x, 3 * n, coord)
    y = _launch_dense(coord, xb, params, tile)
    return y[:, 0] if squeeze else y


def kirchhoff_apply_sparse(coord, x, params, nbr, counts, orig_ids=None,
                           tile=256, *, dtype=torch.float32, device=None):
    """Block-sparse matrix-free ``K @ x`` for the GNM Kirchhoff operator
    (K14); `x` is ``(n, k)`` or ``(n,)``, the rest as
    :func:`hessian_apply_sparse`."""
    _check_params(params)
    _check_tile(tile)
    coord = _coord(coord, dtype, device)
    n = coord.shape[0]
    xb, squeeze = _columns(x, n, coord)
    csr = tile_csr(nbr, counts, orig_ids, n, tile, coord.device)
    y = _sparse_apply(kirchhoff_apply_sparse, coord, xb, params, csr, tile)
    return y[:, 0] if squeeze else y


for _wrapper in (pair_csr, hessian_apply_sparse, hessian_apply_dense,
                 kirchhoff_apply_sparse):
    _wrapper.launches = 0
for _wrapper in (pair_csr, hessian_apply_dense):
    _wrapper.table_launches = 0

# The JAX package's names of the three operators (``matfree.py:451, 882,
# 1022``), with its signatures less ``interpret=``.
hessian_apply_pallas = hessian_apply_dense
kirchhoff_apply_pallas_sparse = kirchhoff_apply_sparse


def hessian_apply_pallas_sparse(coord, x, params, nbr, counts,
                                orig_ids=None, tile=256, *,
                                dtype=torch.float32, device=None,
                                precision="highest"):
    """:func:`hessian_apply_sparse` under the JAX package's name.  Its
    `precision` chose the TPU's float32 products (``"highest"``) or one
    bfloat16 pass (``"default"``, which it measured unusable for modes);
    the port's gather computes in float32 and takes only
    ``"highest"``."""
    if precision != "highest":
        raise ValueError(f"precision={precision!r}: the port's K13 computes "
                         f"in float32 and takes only 'highest'")
    return hessian_apply_sparse(coord, x, params, nbr, counts, orig_ids,
                                tile, dtype=dtype, device=device)


def _hessian_operator(coord, params, *, kernel, sparse, csr, pairs, tile,
                      block):
    """``x -> H @ x`` on `coord` for x ``(3n, p)``: on the kernel route
    K13 over `pairs` or K12, else the plain tile walk over `csr` or the
    row-blocked operator."""
    # the solvers' blocks (QR factors among them) may be strided; the
    # kernels take contiguous X
    if sparse:
        base = ((lambda x: _apply_pairs(hessian_apply_sparse, coord,
                                        x.contiguous(), pairs)) if kernel
                else functools.partial(hessian_apply_sparse_plain, coord,
                                       params=params, csr=csr, tile=tile))
        return _with_overlay_apply(base, overlay_apply_hessian, coord,
                                   params, csr.ids)
    if kernel:
        return lambda x: _launch_dense(coord, x.contiguous(), params, tile)
    return functools.partial(hessian_apply, coord, params=params,
                             block=block, dtype=coord.dtype)


def _kirchhoff_operator(coord, params, *, kernel, sparse, csr, pairs, tile,
                        block):
    """``x -> K @ x`` for x ``(n, p)``: K14 over `pairs` on the kernel
    route with `sparse`, the plain tile walk without the kernel route,
    the row-blocked operator without `sparse`."""
    if sparse:
        base = ((lambda x: _apply_pairs(kirchhoff_apply_sparse, coord,
                                        x.contiguous(), pairs)) if kernel
                else functools.partial(kirchhoff_apply_sparse_plain, coord,
                                       params=params, csr=csr, tile=tile))
        return _with_overlay_apply(base, overlay_apply_kirchhoff, coord,
                                   params, csr.ids)
    return functools.partial(kirchhoff_apply, coord, params=params,
                             block=block, dtype=coord.dtype)


# ---------------------------------------------------------------------------
# Chebyshev-filtered subspace iteration
# ---------------------------------------------------------------------------

def estimate_lambda_max(matvec, m, n_iter=50, safety=1.1, seed=0,
                        dtype=torch.float32, device=None):
    """Upper-bound estimate of the largest eigenvalue of a PSD operator
    by power iteration (`n_iter` applies of one vector) times `safety`;
    a lower bound before the safety factor, so the solvers use
    :func:`hessian_degree_bound` instead.  The start vector lies on
    `device`, by default the current CUDA device."""
    v = torch.cos(torch.arange(m, dtype=dtype, device=resolve_device(device))
                  * 0.7 + seed) + 1e-3
    v = v / torch.linalg.vector_norm(v)
    for _ in range(n_iter):
        w = matvec(v)
        v = w / torch.linalg.vector_norm(w)
    return safety * torch.linalg.vector_norm(matvec(v))


def _deflate(t, x):
    return x - t @ (t.T @ x)


def _chebyshev_filter(matvec, x, degree, a, b, a0=0.0):
    """Scaled Chebyshev filter (Zhou & Saad): amplifies eigencomponents
    in ``[a0, a]`` relative to the damped band ``[a, b]`` (`a`, `b`
    Python floats)."""
    e = (b - a) / 2.0
    c = (b + a) / 2.0
    sigma1 = e / (a0 - c)
    sigma = sigma1
    x_prev = x
    y = (matvec(x) - c * x) * (sigma1 / e)
    for _ in range(degree - 1):
        sigma_new = 1.0 / (2.0 / sigma1 - sigma)
        y_new = (2.0 * sigma_new / e) * (matvec(y) - c * y) \
            - (sigma * sigma_new) * x_prev
        x_prev, y, sigma = y, y_new, sigma_new
    return y


def _chebfsi_init(t, m, *, p, seed):
    key = torch.arange(m * p, dtype=t.dtype, device=t.device).reshape(m, p)
    x = torch.cos(key * 0.7 + seed) + 1e-3
    x, _ = torch.linalg.qr(_deflate(t, x))
    return x


def _chebfsi_outer(matvec, t, x, a, b, *, degree, k):
    """One filter + Rayleigh-Ritz pass; returns the rotated block, the
    next filter cutoff (a Python float), the Ritz values and the
    wanted-mode residuals."""
    p = x.shape[1]
    shift = 0.5 * b  # rigid modes land mid-band -> damped by the filter

    def shifted_matvec(v):
        return matvec(v) + shift * (t @ (t.T @ v))

    y = _chebyshev_filter(shifted_matvec, x, degree, a, b)
    y, _ = torch.linalg.qr(_deflate(t, y))
    hy = matvec(y)
    s = y.T @ hy
    theta, w = torch.linalg.eigh((s + s.T) / 2)
    x = y @ w
    hx = hy @ w[:, :k]
    res = torch.linalg.vector_norm(hx - x[:, :k] * theta[None, :k], dim=0) \
        / torch.clamp(theta[:k].abs(), min=1e-30)
    # next filter cutoff: just above the largest kept Ritz value, clamped
    # inside the spectrum
    a = min(max(1.05 * float(theta[p - 1]), b * 1e-4), 0.5 * b)
    return x, a, theta, res


def _chebfsi(matvec, t, m, lam_max, *, k, oversample, degree, n_outer,
             seed, tol=None, checkpoint=None, retries=0):
    if n_outer < 1:
        raise ValueError(f"n_outer must be >= 1, got {n_outer}")
    b = float(lam_max)
    p = k + oversample

    # Each outer iteration is a step of utils.elastic.resumable_loop, the
    # snapshot and retry boundary (with neither `checkpoint` nor
    # `retries`, a plain loop).  The snapshot holds the loop carry as the
    # loop carries it (x, theta, res tensors of t's dtype, a a Python
    # float), so a resumed solve repeats the uninterrupted one bit for
    # bit; it assumes the same (coord, params, k, seed, ...) call, since
    # the operator is rebuilt, not saved.
    def step(_, st):
        x = elastic._restore(st["x"], (m, p), t.dtype, t.device)
        x, a, theta, res = _chebfsi_outer(matvec, t, x, float(st["a"]), b,
                                          degree=degree, k=k)
        return {"x": x, "a": a, "theta": theta, "res": res}

    def stop(st):
        return tol is not None and float(st["res"].max()) < tol

    state = {"x": _chebfsi_init(t, m, p=p, seed=seed), "a": b / 10.0,
             "theta": torch.zeros(k, dtype=t.dtype, device=t.device),
             "res": torch.full((k,), float("inf"), dtype=t.dtype,
                               device=t.device)}
    state, _ = elastic.resumable_loop(step, state, n_outer,
                                      checkpoint=checkpoint, stop=stop,
                                      retries=retries, probe=t.device)
    return state["theta"][:k], state["x"][:, :k].T, state["res"]


class _Setup(typing.NamedTuple):
    """The block-sparse solvers' set-up (:func:`_sparse_setup`)."""

    coord: torch.Tensor
    params: FFParams
    masses: torch.Tensor | None
    csr: TileCSR
    perm: np.ndarray
    pairs: PairCSR | None


def _sparse_setup(coord, params, masses, tile, kernel):
    """Set-up shared by the block-sparse solvers: Morton sort, tile
    neighbour lists and their CSR (host), permuted masses, the
    parameters with their per-atom codes and overlay masks in the sorted
    order (a new record with device tensors of its own) and, on the
    `kernel` route, the pair CSR of the base family.  Returns a
    :class:`_Setup` ``(sorted coord, permuted params, permuted masses,
    csr, perm, pairs)`` (``pairs`` None off the kernel route)."""
    host = coord.detach().cpu().double().numpy()
    params._check_atoms(host.shape[0])
    perm = spatial_sort_permutation(host)
    sorted_host = host[perm]
    nbr, counts = tile_neighbor_lists(
        sorted_host, float(np.sqrt(params.cutoff_sq)), tile)
    coord_s = torch.as_tensor(sorted_host, dtype=coord.dtype,
                              device=coord.device)
    csr = tile_csr(nbr, counts, perm.astype(np.int32), coord.shape[0], tile,
                   coord.device)
    if masses is not None:
        masses = masses[torch.as_tensor(perm, device=coord.device)]
    if params.kind == "table_compact" or params.overlays:
        params = params.permuted(perm)
    pairs = pair_csr(coord_s, params, csr, tile) if kernel else None
    return _Setup(coord_s, params, masses, csr, perm, pairs)


def _solver_setup(coord, params, masses, *, kernel, sparse, matvec, tile):
    """:func:`_sparse_setup` on the block-sparse route (`sparse` without a
    `matvec`), else None."""
    if sparse and matvec is None:
        return _sparse_setup(coord, params, masses, tile, kernel)
    return None


def _degree_bound(coord, params, masses, setup, block, lambda_max):
    """The filter's upper edge: `lambda_max` if given, else the
    Gershgorin bound, read off the pair CSR where `setup` has one (the
    kernel route), else by the O(n^2) pass over the original order."""
    if lambda_max is not None:
        return lambda_max
    if setup is not None and setup.pairs is not None:
        return _pair_degree_bound(setup.coord, setup.params, setup.pairs,
                                  setup.masses, setup.csr.ids)
    return hessian_degree_bound(coord, params, masses=masses, block=block,
                                dtype=coord.dtype)


def _route(coord, params, matvec, sparse, tile):
    """``(kernel, sparse)``: the kernel route is float32 on CUDA; `sparse`
    defaults to it with a cutoff and no `matvec`."""
    _check_tile(tile)
    kernel = coord.dtype == torch.float32 and coord.device.type == "cuda"
    if sparse is None:
        sparse = kernel and params.has_cutoff and matvec is None
    return kernel, bool(sparse)


def _oversample(oversample, k, kernel, matvec):
    """Extra subspace vectors: the TPU's ``max(k, 8, 48 - k)`` on the
    kernel route (chosen there for the 128-lane padding, kept so that the
    card runs the TPU's algorithm), ``max(k, 8)`` elsewhere."""
    if oversample is not None:
        return int(oversample)
    return max(k, 8, 48 - k) if (kernel and matvec is None) else max(k, 8)


def _mass_weighted(base, w):
    """``x -> w * base(w * x)`` for rows weighted by `w` (or `base`)."""
    if w is None:
        return base

    def matvec(x):
        wx = x * (w[:, None] if x.ndim == 2 else w)
        y = base(wx)
        return y * (w[:, None] if y.ndim == 2 else w)
    return matvec


def lowest_modes_matfree(coord, params, k, *, masses=None, oversample=None,
                         degree=96, n_outer=10, tile=256, block=512,
                         use_pallas=None, sparse=None, dtype=torch.float32,
                         lambda_max=None, seed=0, matvec=None, tol=None,
                         matvec_precision="highest", checkpoint=None,
                         retries=0, device=None):
    """
    The `k` lowest non-trivial ANM modes **without materializing the
    Hessian** — Chebyshev-filtered subspace iteration over the
    matrix-free operator, the six rigid-body modes shifted into the
    damped band.  Requires a connected network; convergence is
    gap-dependent, so check the returned residuals.

    Parameters
    ----------
    coord : Tensor or ndarray, shape=(n, 3)
        A tensor keeps its device; anything else goes to `device`, by
        default the current CUDA device.
    params : FFParams
        An analytic family or ``table_compact``, with or without patch
        overlays.
    k : int
        Number of modes.
    masses : Tensor or ndarray, shape=(n,), optional
        Mass weighting: operates on ``W H W``, ``W = diag(1/sqrt(m))``.
    oversample : int, optional
        Extra subspace vectors; default ``max(k, 8, 48 - k)`` on the
        kernel route (float32 on CUDA), ``max(k, 8)`` elsewhere.
    degree : int
        Chebyshev filter degree per outer iteration.
    n_outer : int
        Outer (filter + Rayleigh-Ritz) iterations.
    sparse : bool, optional
        Block-sparse operator: Morton-sorted atoms, tile neighbour lists,
        only interacting tile pairs visited (on the kernel route the pair
        CSR is built once and K13 gathers over it on every apply).
        Default: on for the kernel route with a cutoff and no `matvec`.
        Results come back in the original atom order.
    lambda_max : float, optional
        Known spectral upper bound; skips :func:`hessian_degree_bound`.
    tol : float, optional
        Stop once the largest wanted-mode relative residual is below it.
    matvec : callable, optional
        Override the operator: ``matvec(x)`` with x ``(3n, p)`` returns
        ``H @ x``; mass weighting still wraps it.
    use_pallas : {None, "auto", True, False}
        The JAX package's switch: the kernels on CUDA, their plain
        versions on the CPU; ``False`` raises on CUDA.
    matvec_precision : {"highest"}
        Full float32 products, the only setting (as in the JAX package).
    checkpoint : str or utils.elastic.LoopCheckpoint, optional
        Snapshot the outer loop's carry to this ``.npz`` after every outer
        iteration and resume from it when it exists: a call interrupted
        at outer iteration j and made again (in this process or a new
        one) restarts at j and returns what the uninterrupted call would,
        bit for bit.  The snapshot is removed when the call returns.  A
        snapshot whose block has another shape or dtype, or whose
        iteration is not below `n_outer`, is another call's: ValueError.
    retries : int
        Retries of an outer iteration that raised a device failure
        (:func:`..utils.elastic.retry_on_failure`: 5 s wait, then a probe
        of the coordinates' device).

    Returns
    -------
    eig_values : Tensor, shape=(k,), ascending
    eig_vectors : Tensor, shape=(k, 3n), xyz layout, modes in rows
    residuals : Tensor, shape=(k,)
        ``|H u - lambda u| / lambda``.
    """
    _check_params(params)
    if matvec_precision != "highest":
        raise ValueError(f"matvec_precision must be 'highest' (full "
                         f"float32 products), got {matvec_precision!r}")
    coord = _coord(coord, dtype, device)
    check_use_pallas(use_pallas, coord.device)
    n = coord.shape[0]
    kernel, sparse = _route(coord, params, matvec, sparse, tile)
    q = _oversample(oversample, k, kernel, matvec)
    if masses is not None:
        masses = as_tensor(masses, dtype, coord.device)
    setup = _solver_setup(coord, params, masses, kernel=kernel,
                          sparse=sparse, matvec=matvec, tile=tile)
    # guaranteed upper bound (the filter needs b >= lambda_max)
    lam_max = _degree_bound(coord, params, masses, setup, block, lambda_max)
    perm = csr = pairs = None
    if setup is not None:
        coord, params, masses, csr, perm, pairs = setup
    base = matvec if matvec is not None else _hessian_operator(
        coord, params, kernel=kernel, sparse=sparse, csr=csr, pairs=pairs,
        tile=tile, block=block)
    w3 = None if masses is None else (1.0 / torch.sqrt(masses)).repeat(3)
    t = rigid.rigid_modes_anm(coord, masses=masses)
    vals, vecs, res = _chebfsi(
        _mass_weighted(base, w3), t, 3 * n, lam_max, k=k, oversample=q,
        degree=degree, n_outer=n_outer, seed=seed, tol=tol,
        checkpoint=checkpoint, retries=retries)
    if perm is not None:
        # back to the original atom order: sorted slot i is atom perm[i]
        inv = np.argsort(perm)
        cols = np.concatenate([a * n + inv for a in range(3)])
        vecs = vecs[:, torch.as_tensor(cols, device=vecs.device)]
    return vals, vecs, res


def lowest_modes_matfree_gnm(coord, params, k, *, masses=None,
                             oversample=None, degree=96, n_outer=10,
                             tile=256, block=512, use_pallas=None,
                             sparse=None, dtype=torch.float32,
                             lambda_max=None, seed=0, matvec=None, tol=None,
                             checkpoint=None, retries=0, device=None):
    """
    The `k` lowest non-trivial GNM modes without materializing the
    Kirchhoff matrix: :func:`lowest_modes_matfree` over the Kirchhoff
    operator (K14 on the kernel route with `sparse`, else the plain
    operators), with the constant vector as the deflated null space.

    Returns ``(eig_values (k,), eig_vectors (k, n), residuals (k,))`` in
    the original atom order.  `use_pallas`, `checkpoint` and `retries` as
    in :func:`lowest_modes_matfree`.
    """
    _check_params(params)
    coord = _coord(coord, dtype, device)
    check_use_pallas(use_pallas, coord.device)
    n = coord.shape[0]
    kernel, sparse = _route(coord, params, matvec, sparse, tile)
    q = _oversample(oversample, k, kernel, matvec)
    if masses is not None:
        masses = as_tensor(masses, dtype, coord.device)
    setup = _solver_setup(coord, params, masses, kernel=kernel,
                          sparse=sparse, matvec=matvec, tile=tile)
    # the block-row Gershgorin bound coincides for the Kirchhoff matrix
    lam_max = _degree_bound(coord, params, masses, setup, block, lambda_max)
    perm = csr = pairs = None
    if setup is not None:
        coord, params, masses, csr, perm, pairs = setup
    base = matvec if matvec is not None else _kirchhoff_operator(
        coord, params, kernel=kernel, sparse=sparse, csr=csr, pairs=pairs,
        tile=tile, block=block)
    w = None if masses is None else 1.0 / torch.sqrt(masses)
    t = rigid.null_mode_gnm(n, masses=masses, dtype=dtype,
                            device=coord.device)
    vals, vecs, res = _chebfsi(
        _mass_weighted(base, w), t, n, lam_max, k=k, oversample=q,
        degree=degree, n_outer=n_outer, seed=seed, tol=tol,
        checkpoint=checkpoint, retries=retries)
    if perm is not None:
        vecs = vecs[:, torch.as_tensor(np.argsort(perm), device=vecs.device)]
    return vals, vecs, res


# ---------------------------------------------------------------------------
# Deflated, preconditioned conjugate gradients
# ---------------------------------------------------------------------------

def _pcg(op, deflate, precond, rhs, *, tol, max_iter):
    """Preconditioned CG on ``range(I - T T^t)`` with per-column step
    sizes; stops once every column's relative residual passes `tol`.
    Returns ``(x, iterations, residuals)``."""
    b = deflate(rhs)
    b_norm = torch.clamp(torch.linalg.vector_norm(b, dim=0), min=1e-30)
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = (r * z).sum(dim=0)
    active = torch.linalg.vector_norm(r, dim=0) / b_norm > tol
    i = 0
    while i < max_iter and bool(active.any()):
        # per-column freezing: converged columns stop, and columns whose
        # curvature or rz degenerate (CG pushed past the precision floor)
        # freeze at their last finite iterate instead of overflowing
        hp = deflate(op(p))
        denom = (p * hp).sum(dim=0)
        ok = active & torch.isfinite(denom) & (denom > 0) & (rz > 0)
        alpha = torch.where(ok, rz / torch.where(ok, denom, 1.0), 0.0)
        x = x + p * alpha[None, :]
        r = r - hp * alpha[None, :]
        z = precond(r)
        rz_new = (r * z).sum(dim=0)
        beta = torch.where(ok, rz_new / torch.where(ok, rz, 1.0), 0.0)
        p = torch.where(ok[None, :], z + p * beta[None, :], p)
        rz = rz_new
        active = ok & (torch.linalg.vector_norm(r, dim=0) / b_norm > tol)
        i += 1
    res = torch.linalg.vector_norm(r, dim=0) / b_norm
    return deflate(x), i, res


def _deflated_pcg(op, t, inv_blocks, rhs, n, *, tol, max_iter):
    """ANM CG: vectors ``(3n, k)`` in xyz layout, the per-atom inverse
    ``3 x 3`` diagonal blocks ``inv_blocks`` ``(n, 3, 3)`` as the
    preconditioner."""
    def deflate(x):
        return _deflate(t, x)

    def precond(r):
        rr = r.reshape(3, n, -1).transpose(0, 1)            # (n, 3, k)
        out = torch.bmm(inv_blocks, rr)
        return deflate(out.transpose(0, 1).reshape(3 * n, -1))

    return _pcg(op, deflate, precond, rhs, tol=tol, max_iter=max_iter)


def _deflated_pcg_gnm(op, t, inv_diag, rhs, n, *, tol, max_iter):
    """GNM CG: vectors ``(n, k)``, the inverse degree diagonal as the
    preconditioner."""
    def deflate(x):
        return _deflate(t, x)

    return _pcg(op, deflate, lambda r: deflate(inv_diag[:, None] * r), rhs,
                tol=tol, max_iter=max_iter)


def covariance_solve_matfree(coord, params, rhs, *, masses=None, tol=1e-6,
                             max_iter=1000, tile=256, block=512,
                             use_pallas=None, sparse=None,
                             dtype=torch.float32, matvec=None, device=None):
    """
    ``pinv(H) @ rhs`` without materializing the Hessian or its
    covariance: deflated, block-Jacobi-preconditioned CG on the implicit
    operator, each column with its own step sizes.  Requires a connected
    network.

    Parameters
    ----------
    coord : Tensor or ndarray, shape=(n, 3)
    rhs : Tensor or ndarray, shape=(3n, k) or (3n,)
        Right-hand sides in xyz plane layout.
    tol : float
        Relative residual target per column.
    max_iter : int
        CG iteration cap.
    use_pallas, sparse, matvec, device :
        As :func:`lowest_modes_matfree` (kernel route: float32 on CUDA).

    Returns
    -------
    x : Tensor, same shape as `rhs`
        ``pinv(H) @ rhs``, null-space component removed.
    n_iter : int
    residuals : Tensor, shape=(k,)
        ``|H x - P rhs| / |P rhs|`` as the recurrence carries it.
    """
    _check_params(params)
    coord = _coord(coord, dtype, device)
    check_use_pallas(use_pallas, coord.device)
    n = coord.shape[0]
    kernel, sparse = _route(coord, params, matvec, sparse, tile)
    rhs, squeeze = _columns(rhs, 3 * n, coord, "rhs")
    if masses is not None:
        masses = as_tensor(masses, dtype, coord.device)
    setup = _solver_setup(coord, params, masses, kernel=kernel,
                          sparse=sparse, matvec=matvec, tile=tile)

    # block-Jacobi preconditioner: off the pair CSR in its sorted order
    # on the kernel route, else by the O(n^2) pass over the original one
    if setup is not None and setup.pairs is not None:
        diag_blocks = _pair_diag_blocks(setup.coord, setup.params,
                                        setup.pairs, setup.csr.ids)
        m = setup.masses
    else:
        diag_blocks = hessian_diag_blocks(coord, params, block=block,
                                          dtype=dtype)
        m = masses
    if m is not None:
        diag_blocks = diag_blocks * (1.0 / m)[:, None, None]
    # regularized 3x3 inverses (isolated atoms would be singular)
    trace = diag_blocks.diagonal(dim1=1, dim2=2).sum(dim=-1)
    reg = 1e-6 * torch.clamp(trace, min=1e-30)[:, None, None] \
        * torch.eye(3, dtype=dtype, device=coord.device)
    inv_blocks = torch.linalg.inv(diag_blocks + reg)

    perm = csr = pairs = None
    if setup is not None:
        coord, params, masses, csr, perm, pairs = setup
        perm_t = torch.as_tensor(perm, device=coord.device)
        if pairs is None:
            inv_blocks = inv_blocks[perm_t]
        rhs = rhs[torch.cat([a * n + perm_t for a in range(3)])]
    base = matvec if matvec is not None else _hessian_operator(
        coord, params, kernel=kernel, sparse=sparse, csr=csr, pairs=pairs,
        tile=tile, block=block)
    w3 = None if masses is None else (1.0 / torch.sqrt(masses)).repeat(3)
    t = rigid.rigid_modes_anm(coord, masses=masses)
    x, n_it, res = _deflated_pcg(_mass_weighted(base, w3), t, inv_blocks,
                                 rhs, n, tol=tol, max_iter=max_iter)
    if perm is not None:
        inv = torch.as_tensor(np.argsort(perm), device=x.device)
        x = x[torch.cat([a * n + inv for a in range(3)])]
    return (x[:, 0] if squeeze else x), n_it, res


def covariance_solve_matfree_gnm(coord, params, rhs, *, masses=None,
                                 tol=1e-6, max_iter=1000, tile=256,
                                 block=512, use_pallas=None, sparse=None,
                                 dtype=torch.float32, precond=True,
                                 device=None):
    """
    ``pinv(K) @ rhs`` for the GNM Kirchhoff matrix without materializing
    it — the GNM twin of :func:`covariance_solve_matfree` (constant-mode
    deflation, degree Jacobi preconditioner, per-column CG step sizes).
    `rhs` is ``(n, k)`` or ``(n,)``; ``precond=False`` skips the degree
    pass (O(n^2) off the kernel route, read off the pair CSR on it);
    `use_pallas` as in :func:`lowest_modes_matfree`.
    Returns ``(x, n_iter, residuals)``.
    """
    _check_params(params)
    coord = _coord(coord, dtype, device)
    check_use_pallas(use_pallas, coord.device)
    n = coord.shape[0]
    kernel, sparse = _route(coord, params, None, sparse, tile)
    rhs, squeeze = _columns(rhs, n, coord, "rhs")
    if masses is not None:
        masses = as_tensor(masses, dtype, coord.device)
    setup = _solver_setup(coord, params, masses, kernel=kernel,
                          sparse=sparse, matvec=None, tile=tile)
    on_pairs = setup is not None and setup.pairs is not None

    if precond:
        # the degree off the pair CSR in its sorted order on the kernel
        # route, else by the O(n^2) pass over the original one
        if on_pairs:
            deg, m = _pair_degree(setup.coord, setup.params, setup.pairs,
                                  setup.csr.ids), setup.masses
        else:
            deg, m = kirchhoff_degree(coord, params, block=block,
                                      dtype=dtype), masses
        if m is not None:
            deg = deg * (1.0 / m)
        inv_diag = 1.0 / torch.clamp(deg, min=1e-30)
    else:
        inv_diag = torch.ones(n, dtype=dtype, device=coord.device)

    perm = csr = pairs = None
    if setup is not None:
        coord, params, masses, csr, perm, pairs = setup
        perm_t = torch.as_tensor(perm, device=coord.device)
        if not on_pairs:
            inv_diag = inv_diag[perm_t]
        rhs = rhs[perm_t]
    base = _kirchhoff_operator(coord, params, kernel=kernel, sparse=sparse,
                               csr=csr, pairs=pairs, tile=tile, block=block)
    w = None if masses is None else 1.0 / torch.sqrt(masses)
    t = rigid.null_mode_gnm(n, masses=masses, dtype=dtype,
                            device=coord.device)
    x, n_it, res = _deflated_pcg_gnm(_mass_weighted(base, w), t, inv_diag,
                                     rhs, n, tol=tol, max_iter=max_iter)
    if perm is not None:
        x = x[torch.as_tensor(np.argsort(perm), device=x.device)]
    return (x[:, 0] if squeeze else x), n_it, res


def linear_response_matfree(coord, params, force, *, dtype=torch.float32,
                            device=None, **options):
    """
    Linear response displacements ``pinv(H) @ force`` without the
    Hessian or covariance — `force` is ``(n, 3)`` or ``(3n,)`` (atom-major
    flat) or a batch ``(n, 3, k)``; returns displacements in the same
    shape, the CG iteration count and the residuals.  `options` go to
    :func:`covariance_solve_matfree`.
    """
    coord = _coord(coord, dtype, device)
    n = coord.shape[0]
    force = as_tensor(force, dtype, coord.device)
    if force.ndim == 1:
        if force.shape[0] != 3 * n:
            raise ValueError(
                f"force has {force.shape[0]} entries, expected {3 * n}")
        vec = force.reshape(n, 3).T.reshape(3 * n)          # -> xyz layout
        x, n_it, res = covariance_solve_matfree(coord, params, vec,
                                                dtype=dtype, **options)
        return x.reshape(3, n).T.reshape(3 * n), n_it, res
    if force.shape[:2] != (n, 3) or force.ndim > 3:
        raise ValueError(
            f"force has shape {tuple(force.shape)}, expected ({n}, 3[, k])")
    batched = force.ndim == 3
    f = force if batched else force[:, :, None]
    vec = f.permute(1, 0, 2).reshape(3 * n, -1)
    x, n_it, res = covariance_solve_matfree(coord, params, vec, dtype=dtype,
                                            **options)
    disp = x.reshape(3, n, -1).permute(1, 0, 2)
    return (disp if batched else disp[:, :, 0]), n_it, res


def _check_sites(sites, n):
    sites = np.asarray(sites, dtype=np.int64)
    if sites.ndim != 1 or np.any(sites < 0) or np.any(sites >= n):
        raise IndexError(f"sites must be flat indices in [0, {n})")
    return sites


def _site_columns(coord, params, sites, masses, dtype, options):
    """The three covariance columns ``pinv(H) @ e_(site, a)`` per site,
    site-major, as ``(3, n, n_sites, 3)`` ``[b, j, s, a]``; the one-hot
    right-hand sides are set on the device in one ``index_put_``."""
    n = coord.shape[0]
    site_t = torch.as_tensor(sites, device=coord.device)
    axis = torch.arange(3, device=coord.device)
    rhs = torch.zeros((3 * n, 3 * len(sites)), dtype=torch.float64,
                      device=coord.device)
    rhs.index_put_(((axis[None, :] * n + site_t[:, None]).reshape(-1),
                    torch.arange(3 * len(sites), device=coord.device)),
                   torch.ones((), dtype=torch.float64, device=coord.device))
    x, n_it, res = covariance_solve_matfree(
        coord, params, rhs, masses=masses, dtype=dtype, **options)
    return x.reshape(3, n, len(sites), 3), n_it, res


def _normalize_rows(rows, sites, msf):
    diag = as_tensor(msf, rows.dtype, rows.device)
    return rows / torch.sqrt(diag[None, :] * diag[torch.as_tensor(
        sites, device=rows.device)][:, None])


def prs_rows_matfree(coord, params, sites, *, norm=True, masses=None,
                     dtype=torch.float32, device=None, **options):
    """
    Perturbation-response-scanning rows for selected perturbation sites
    without the covariance: three covariance columns per site by the
    deflated CG (:func:`covariance_solve_matfree`), squared and folded;
    ``norm`` divides each row by its diagonal entry.

    Returns ``(prs_rows (len(sites), n), n_iter, residuals (3 len(sites),))``.
    """
    coord = _coord(coord, dtype, device)
    sites = _check_sites(sites, coord.shape[0])
    cols, n_it, res = _site_columns(coord, params, sites, masses, dtype,
                                    options)
    prs = (cols ** 2).sum(dim=(0, 3)).T
    if norm:
        diag = prs[torch.arange(len(sites), device=prs.device),
                   torch.as_tensor(sites, device=prs.device)]
        prs = prs / diag[:, None]
    return prs, n_it, res


def dcc_rows_matfree(coord, params, sites, *, norm=True, msf=None,
                     masses=None, dtype=torch.float32, device=None,
                     **options):
    """
    Dynamic cross-correlation rows for selected sites without the
    covariance: the ``3 x 3`` superelement traces of each site's three
    covariance columns (deflated CG) are the all-mode DCC row
    ``DCC[site, j] = tr C(site, j)``.  ``norm=True`` needs the per-atom
    covariance traces `msf` for ``DCC_ij / sqrt(DCC_ii DCC_jj)``.

    Returns ``(dcc_rows (len(sites), n), n_iter, residuals)``.
    """
    coord = _coord(coord, dtype, device)
    sites = _check_sites(sites, coord.shape[0])
    if norm and msf is None:
        raise ValueError(
            "norm=True needs the per-atom covariance traces for the DCC "
            "denominator: pass msf=(all-mode MSF; at mega scale the "
            "mode-sum MSF from lowest_modes_matfree), or use norm=False")
    cols, n_it, res = _site_columns(coord, params, sites, masses, dtype,
                                    options)
    rows = sum(cols[a, :, :, a] for a in range(3)).T
    if norm:
        rows = _normalize_rows(rows, sites, msf)
    return rows, n_it, res


def dcc_rows_matfree_gnm(coord, params, sites, *, norm=True, msf=None,
                         masses=None, dtype=torch.float32, device=None,
                         **options):
    """
    GNM DCC rows without the covariance: the all-mode GNM DCC is the
    covariance, so each row is one ``pinv(K) @ e_site`` solve
    (:func:`covariance_solve_matfree_gnm`).  `msf` (the covariance
    diagonal) is required for ``norm=True``.

    Returns ``(dcc_rows (len(sites), n), n_iter, residuals)``.
    """
    coord = _coord(coord, dtype, device)
    n = coord.shape[0]
    sites = _check_sites(sites, n)
    if norm and msf is None:
        raise ValueError(
            "norm=True needs the covariance diagonal: pass msf=(all-mode "
            "GNM MSF; at mega scale the mode-sum MSF from "
            "lowest_modes_matfree_gnm), or use norm=False")
    rhs = np.zeros((n, len(sites)), dtype=np.float64)
    rhs[sites, np.arange(len(sites))] = 1.0
    x, n_it, res = covariance_solve_matfree_gnm(
        coord, params, rhs, masses=masses, dtype=dtype, **options)
    rows = x.T
    if norm:
        rows = _normalize_rows(rows, sites, msf)
    return rows, n_it, res


# ---------------------------------------------------------------------------
# Effector/sensor profiles and the stochastic estimators
# ---------------------------------------------------------------------------
#
# Counterparts of the JAX package's estimators, whose float64 algebra runs
# in host NumPy: here it runs in float64 on the coordinates' device and the
# results stay there.  Only the CG runs in the working dtype.  The
# Rademacher probes are drawn as the JAX package draws them, from
# ``np.random.RandomState(seed)``, so that a seed gives the same probe
# matrix in both packages.

def _rademacher(seed, shape, device):
    """``(rows, cols)`` of +-1 in float64 on `device`, the JAX package's
    draw: ``RandomState(seed).randint(0, 2, size=shape) * 2 - 1``."""
    z = np.random.RandomState(seed).randint(0, 2, size=shape)
    return torch.as_tensor(z.astype(np.float64) * 2.0 - 1.0, device=device)


def _mode_planes(vectors, n, layout):
    """Modes in rows ``(k, 3n)`` as planes ``(k, 3, n)`` of the xyz
    components."""
    k = vectors.shape[0]
    if layout == "xyz":
        return vectors.reshape(k, 3, n)
    if layout == "atom":
        return vectors.reshape(k, n, 3).transpose(1, 2)
    raise ValueError(f"Unknown layout '{layout}'")


def _mode_tensors(eig_values, eig_vectors, device):
    """Modes as float64 tensors: a tensor keeps its device, anything else
    goes to `device` (by default the current CUDA device)."""
    vecs = as_tensor(eig_vectors, torch.float64, device)
    return as_tensor(eig_values, torch.float64, vecs.device), vecs


def _rank_k_planes(modes, n, layout, device):
    """Non-trivial mode set ``(values, vectors)`` -> float64 ``(vals,
    planes (k, 3, n), v_xyz (k, 3n))`` in xyz plane layout, on
    `device`."""
    vals, vecs = _mode_tensors(modes[0], modes[1], device)
    planes = _mode_planes(vecs, n, layout)
    return vals, planes, planes.reshape(-1, 3 * n)


def _deflated(x, z, vals, v_xyz):
    """The CG solution `x` in float64 less the exact rank-k response
    ``C_k z``: ``C_rest z``."""
    return x.double() - v_xyz.T @ ((v_xyz @ z) / vals[:, None])


def _mean_and_sem(samples):
    """Mean over the last axis and its standard error (sample std with
    ``ddof=1`` over sqrt(count))."""
    m = samples.shape[-1]
    return samples.mean(dim=-1), \
        samples.std(dim=-1, correction=1) / np.sqrt(m)


def prs_diag_from_modes(eig_values, eig_vectors, *, layout="xyz",
                        device=None):
    """
    The folded-PRS diagonal ``P_ii = ||C_ii||_F^2`` (squared Frobenius
    norm of each atom's diagonal 3x3 covariance block) from a truncated
    mode set — the normalizer of the reference's row-normalized PRS
    matrix (``nma.py:520-523``), the mode-sum converging as
    ``1/lambda^2``.

    ``eig_vectors``: ``(k, 3n)`` modes in rows (a tensor keeps its
    device, anything else goes to `device`); returns ``(n,)`` float64.
    """
    vals, vecs = _mode_tensors(eig_values, eig_vectors, device)
    planes = _mode_planes(vecs, vecs.shape[1] // 3, layout)
    # C_ii[a, b] = sum_k v[k, a, i] v[k, b, i] / lambda_k
    blocks = torch.einsum("kai,kbi->abi", planes / vals[:, None, None],
                          planes)
    return (blocks ** 2).sum(dim=(0, 1))


def effector_sensor_from_modes(eig_values, eig_vectors, *, norm=True,
                               layout="xyz", device=None):
    """
    Effector and sensor profiles over **all** atoms from a truncated
    mode set — O(n k^2) flops, no covariance matrix and no CG sweep:
    the exact profiles of the rank-k covariance ``sum_k v_k v_k^T /
    lambda_k`` (the standard mode-truncated PRS; with the complete
    non-trivial set equal to the dense path).  Writing the
    1/sqrt(lambda)-scaled modes as planes ``R_a (k, n)``, the folded PRS
    is ``P_ij = sum_kl S_kl(i) S_kl(j)``, ``S_kl(i) = sum_a R_a[k, i]
    R_a[l, i]``, and every profile is a quadratic form in the k x k
    mode-overlap space (``springcraft_tpu.ops.matfree``).  Under
    truncation the sensor especially is a low-mode-subspace quantity:
    :func:`effector_sensor_stochastic` gives unbiased all-mode
    profiles, :func:`effector_sensor_matfree` exact ones at sites.

    Parameters
    ----------
    eig_values, eig_vectors : shapes ``(k,)`` / ``(k, 3n)``
        Non-trivial modes in rows (a tensor keeps its device, anything
        else goes to `device`).
    norm : bool
        Row-normalize by the diagonal before averaging (``nma.py:520-523``).
    layout : {"xyz", "atom"}
        Eigenvector component layout.

    Returns
    -------
    effector, sensor : Tensor, shape=(n,), float64
    """
    vals, vecs = _mode_tensors(eig_values, eig_vectors, device)
    if vals.ndim != 1 or vecs.ndim != 2 or vecs.shape[0] != vals.shape[0]:
        raise ValueError(
            f"expected (k,) values and (k, 3n) modes in rows, got "
            f"{tuple(vals.shape)} and {tuple(vecs.shape)}")
    n = vecs.shape[1] // 3
    planes = _mode_planes(vecs, n, layout)
    r = planes / torch.sqrt(vals)[:, None, None]            # (k, 3, n)

    # diagonal P_ii = ||C_ii||_F^2 from the 3x3 blocks (O(n k))
    blocks = torch.einsum("kai,kbi->abi", planes / vals[:, None, None],
                          planes)
    diag = (blocks ** 2).sum(dim=(0, 1))

    t = torch.einsum("kai,lai->kl", r, r)
    rowsum = torch.einsum("kl,kai,lai->i", t, r, r)
    if norm:
        u = torch.einsum("kai,i,lai->kl", r, 1.0 / diag, r)
        wcolsum = torch.einsum("kl,kai,lai->i", u, r, r)
        effector = (rowsum - diag) / ((n - 1) * diag)
        # P_ii / P_ii == 1 is the excluded diagonal term
        sensor = (wcolsum - 1.0) / (n - 1)
    else:
        # the folded PRS is symmetric: raw column means == row means
        effector = (rowsum - diag) / (n - 1)
        sensor = effector.clone()
    return effector, sensor


def effector_sensor_matfree(coord, params, sites, *, prs_diag=None,
                            norm=True, masses=None, dtype=torch.float32,
                            return_diag=False, device=None, **options):
    """
    Effector and sensor profile values at selected sites without the
    covariance matrix — the large-scale route to the reference's
    ``effector_sensor`` (``nma.py:527-569``).  Three covariance columns
    per site by the deflated CG (:func:`covariance_solve_matfree`, one
    batched call); by symmetry a site's columns give its PRS row
    (effector numerators) and column (sensor numerators).  With
    ``norm=True`` the sensor average needs ``P_ii`` for every atom:
    pass `prs_diag` ``(n,)`` (e.g. :func:`prs_diag_from_modes`).

    Returns
    -------
    effector, sensor : Tensor, shape=(len(sites),), float64
        ``mean_{j != i} P_ij / P_ii`` at each site ``i``, and
        ``mean_{i != j} P_ij / P_ii`` at each site ``j``.
    n_iter : int
    residuals : Tensor, shape=(3 * len(sites),)
    self_diag : Tensor, shape=(len(sites),)
        Only with ``return_diag=True``: the exact all-mode ``P_ss``.
    """
    coord = _coord(coord, dtype, device)
    n = coord.shape[0]
    sites = _check_sites(sites, n)
    if norm and prs_diag is None:
        raise ValueError(
            "effector_sensor_matfree(norm=True) needs prs_diag=<(n,) "
            "folded-PRS diagonal>: the sensor column average divides "
            "each perturbing row i by its self-response P_ii, which "
            "the site columns alone cannot produce — compute it from "
            "a truncated mode set via prs_diag_from_modes")
    if norm:
        prs_diag = as_tensor(prs_diag, torch.float64, coord.device)
        if prs_diag.shape != (n,):
            raise ValueError(f"prs_diag has shape {tuple(prs_diag.shape)}, "
                             f"expected ({n},)")
    n_sites = len(sites)
    cols, n_it, res = _site_columns(coord, params, sites, masses, dtype,
                                    options)
    p_col = (cols.double() ** 2).sum(dim=(0, 3))    # (n, s): P[i, site]
    site_t = torch.as_tensor(sites, device=coord.device)
    each = torch.arange(n_sites, device=coord.device)
    self_p = p_col[site_t, each]                    # P_ss
    col_sums = p_col.sum(dim=0) - self_p            # sum_{i != s}
    if norm:
        effector = col_sums / ((n - 1) * self_p)
        weighted = p_col / prs_diag[:, None]
        sensor = (weighted.sum(dim=0) - weighted[site_t, each]) / (n - 1)
    else:
        effector = col_sums / (n - 1)
        sensor = effector.clone()
    if return_diag:
        return effector, sensor, n_it, res, self_p
    return effector, sensor, n_it, res


def prs_diag_stochastic(coord, params, modes, *, probes=64, seed=0,
                        layout="xyz", masses=None, dtype=torch.float32,
                        device=None, **options):
    """
    Unbiased **all-mode** folded-PRS diagonal ``P_ii = ||C_ii||_F^2``
    over all atoms: Rademacher probes ``z`` of the deflated covariance
    ``C_rest = C - C_k`` through one batched deflated-CG solve (``E[z_ib
    (C_rest z)_ia] = (C_rest)_ii[a, b]``), split into two independent
    halves A/B for the product estimator ``<C_k,ii + B_A, C_k,ii +
    B_B>_F`` (no squared-noise bias), clamped from below by the exact
    rank-k value (both blocks PSD).

    Parameters
    ----------
    coord : Tensor or ndarray, shape=(n, 3)
    params : FFParams
    modes : (eig_values, eig_vectors)
        Non-trivial modes in rows, ``(k,)`` / ``(k, 3n)``.
    probes : int
        Rademacher probe columns (at least 4).
    seed : int
        ``np.random.RandomState`` seed of the probes (the JAX package's
        draw).
    layout : {"xyz", "atom"}
    options
        Forwarded to :func:`covariance_solve_matfree`.

    Returns
    -------
    diag, stderr : Tensor, shape=(n,), float64
        The estimate, clamped from below by the rank-k mode-sum, and its
        first-order propagated standard error.
    n_iter : int
    residuals : Tensor, shape=(probes,)
    """
    coord = _coord(coord, dtype, device)
    n = coord.shape[0]
    if probes < 4:
        raise ValueError("probes must be >= 4 (two independent "
                         "halves, each with a sample variance)")
    vals, planes, v_xyz = _rank_k_planes(modes, n, layout, coord.device)
    # exact rank-k diagonal blocks
    blk_k = torch.einsum("kai,kbi->iab", planes / vals[:, None, None],
                         planes)                                # (n, 3, 3)
    z = _rademacher(seed, (3 * n, probes), coord.device)
    x, n_it, res = covariance_solve_matfree(
        coord, params, z, masses=masses, dtype=dtype, **options)
    xp = _deflated(x, z, vals, v_xyz).reshape(3, n, probes)
    zp = z.reshape(3, n, probes)

    h = probes // 2
    halves, variances = [], []
    for sl in (slice(0, h), slice(h, probes)):
        t = torch.einsum("bip,aip->iabp", zp[:, :, sl], xp[:, :, sl])
        t = 0.5 * (t + t.transpose(1, 2))
        m = sl.stop - sl.start
        halves.append(blk_k + t.mean(dim=-1))
        variances.append(t.var(dim=-1, correction=1) / m)   # (n, 3, 3)
    m_a, m_b = halves
    raw = (m_a * m_b).sum(dim=(1, 2))
    # first-order stderr of <M_A, M_B> around M = (M_A + M_B) / 2
    m_mid = 0.5 * (m_a + m_b)
    var = (m_mid ** 2 * (variances[0] + variances[1])).sum(dim=(1, 2))
    stderr = torch.sqrt(torch.clamp(var, min=0.0))
    floor = (blk_k ** 2).sum(dim=(1, 2))
    return torch.maximum(raw, floor), stderr, n_it, res


def msf_stochastic(coord, params, modes, *, probes=64, seed=0,
                   layout="xyz", masses=None, dtype=torch.float32,
                   device=None, **options):
    """
    Unbiased **all-mode** mean-square fluctuation over all atoms without
    the covariance: deflated Hutchinson estimation of ``tr C_ii``.
    Rademacher probes ``z`` of ``C_rest = C - C_k`` through one batched
    deflated-CG solve (``E[z_r (C_rest z)_r] = (C_rest)_rr``), the three
    components folded per atom, the exact rank-k mode-sum added back and
    the residual clamped at zero (the diagonal of a PSD matrix).

    Parameters
    ----------
    coord : Tensor or ndarray, shape=(n, 3)
    params : FFParams
    modes : (eig_values, eig_vectors)
        Non-trivial modes in rows, ``(k,)`` / ``(k, 3n)``: the deflation
        subspace (``lowest_modes_matfree`` output).
    probes, seed, layout, options
        As :func:`prs_diag_stochastic` (at least 2 probes).

    Returns
    -------
    msf, stderr : Tensor, shape=(n,), float64
    n_iter : int
    residuals : Tensor, shape=(probes,)
    """
    coord = _coord(coord, dtype, device)
    n = coord.shape[0]
    if probes < 2:
        raise ValueError("probes must be >= 2 (stderr needs a sample "
                         "variance)")
    vals, planes, v_xyz = _rank_k_planes(modes, n, layout, coord.device)
    msf_k = torch.einsum("kai,kai->i", planes / vals[:, None, None], planes)
    z = _rademacher(seed, (3 * n, probes), coord.device)
    x, n_it, res = covariance_solve_matfree(
        coord, params, z, masses=masses, dtype=dtype, **options)
    x = _deflated(x, z, vals, v_xyz)
    # fold the three components per atom, per probe
    samples = (z.reshape(3, n, probes) * x.reshape(3, n, probes)).sum(0)
    rest, stderr = _mean_and_sem(samples)
    return msf_k + torch.clamp(rest, min=0.0), stderr, int(n_it), res


def msf_stochastic_gnm(coord, params, modes, *, probes=64, seed=0,
                       masses=None, dtype=torch.float32, device=None,
                       **options):
    """GNM counterpart of :func:`msf_stochastic`: unbiased all-mode
    ``diag(pinv(K))`` by deflated Hutchinson probes through
    :func:`covariance_solve_matfree_gnm`.  Same contract; mode vectors
    are ``(k, n)``."""
    coord = _coord(coord, dtype, device)
    n = coord.shape[0]
    if probes < 2:
        raise ValueError("probes must be >= 2 (stderr needs a sample "
                         "variance)")
    vals, vecs = _mode_tensors(modes[0], modes[1], coord.device)
    msf_k = torch.einsum("ki,ki->i", vecs / vals[:, None], vecs)
    z = _rademacher(seed, (n, probes), coord.device)
    x, n_it, res = covariance_solve_matfree_gnm(
        coord, params, z, masses=masses, dtype=dtype, **options)
    rest, stderr = _mean_and_sem(z * _deflated(x, z, vals, vecs))
    return msf_k + torch.clamp(rest, min=0.0), stderr, int(n_it), res


def effector_sensor_stochastic(coord, params, prs_diag, *, probes=64,
                               norm=True, masses=None, seed=0,
                               modes=None, layout="xyz",
                               dtype=torch.float32, device=None, **options):
    """
    **All-mode** effector/sensor profiles over **all** atoms without the
    covariance: Hutchinson estimation of the two profile numerators,
    ``fold diag(C^2)`` (effector) and ``fold diag(C W C)`` with ``W =
    diag(repeat(1 / P_ii, 3))`` (sensor), from ONE batched deflated-CG
    solve over ``2 * probes`` Rademacher columns (``probes`` with
    ``norm=False``), ``~sqrt(2 / probes)`` relative standard error.

    With `modes` the rank-k part is an exact control variate: ``C_k
    C_rest = 0`` makes ``diag(C^2) = diag(C_k^2) + diag(C_rest^2)`` and
    only the residual second moment is sampled; the sensor's ``W`` breaks
    that orthogonality, so with `norm` the ``k`` columns ``W v_k`` join
    the same solve and close its cross term ``2 diag(C_k W C_rest)``
    exactly (``2 * probes + k`` columns).

    Parameters
    ----------
    coord : Tensor or ndarray, shape=(n, 3)
    params : FFParams
    prs_diag : shape=(n,)
        The folded-PRS diagonal ``P_ii`` (the excluded self term and,
        with `norm`, the row normalizer), e.g.
        :func:`prs_diag_from_modes` or :func:`prs_diag_stochastic`.
    probes : int
        Rademacher probes per profile (at least 2).
    norm : bool
        Reference-standard row normalization ``P_ij / P_ii``.
    seed : int
        ``np.random.RandomState`` seed of the probes.
    modes : (eig_values, eig_vectors), optional
        Non-trivial modes for the exact rank-k control variate.
    layout : {"xyz", "atom"}
        `modes` eigenvector component layout.
    options
        Forwarded to :func:`covariance_solve_matfree`.

    Returns
    -------
    effector, sensor : Tensor, shape=(n,), float64
    effector_stderr, sensor_stderr : Tensor, shape=(n,), float64
    n_iter : int
    residuals : Tensor, shape=(2 * probes [+ k],) or (probes,)
    """
    coord = _coord(coord, dtype, device)
    n = coord.shape[0]
    if prs_diag is None:
        raise ValueError(
            "effector_sensor_stochastic needs prs_diag=<(n,) "
            "folded-PRS diagonal>: the excluded self term P_ii "
            "cannot be estimated from probe solves — compute it from "
            "a truncated mode set via prs_diag_from_modes")
    prs_diag = as_tensor(prs_diag, torch.float64, coord.device)
    if prs_diag.shape != (n,):
        raise ValueError(
            f"prs_diag has shape {tuple(prs_diag.shape)}, expected ({n},)")
    if probes < 2:
        raise ValueError("probes must be >= 2 (stderr needs a sample "
                         "variance)")
    if modes is not None:
        vals_k, planes_k, v_xyz = _rank_k_planes(modes, n, layout,
                                                 coord.device)
    n_cols = 2 * probes if norm else probes
    # with deflation and norm, k extra columns W v_k in the same solve
    # make the sensor's C_k W C_rest cross diagonal exact
    n_extra = v_xyz.shape[0] if (modes is not None and norm) else 0
    z = _rademacher(seed, (3 * n, n_cols + n_extra), coord.device)
    if norm:
        # sensor probes scaled by W^(1/2) (component (a, i) at row a n + i)
        w_half = (1.0 / torch.sqrt(prs_diag)).repeat(3)
        z[:, probes:n_cols] *= w_half[:, None]
    if n_extra:
        w_full = (1.0 / prs_diag).repeat(3)
        z[:, n_cols:] = w_full[:, None] * v_xyz.T

    x, n_it, res = covariance_solve_matfree(
        coord, params, z, masses=masses, dtype=dtype, **options)
    x = x.double()

    if modes is not None:
        # the exact rank-k response per probe removed
        v = _deflated(x[:, :n_cols], z[:, :n_cols], vals_k, v_xyz)\
            .reshape(3, n, n_cols)
        # exact fold diag(C_k^2) per atom
        e_k2 = torch.einsum("kai,kai,k->i", planes_k, planes_k,
                            1.0 / vals_k ** 2)
        # effector: C_k C_rest == 0, only the residual second moment
        e_mean, e_sem = _mean_and_sem((v[:, :, :probes] ** 2).sum(dim=0))
        e_num = e_k2 + e_mean
        if norm:
            # exact fold diag(C_k W C_k): S = L^-1 (V W V^T) L^-1
            s_mat = (v_xyz * w_full[None, :]) @ v_xyz.T \
                / torch.outer(vals_k, vals_k)
            s_k2 = (v_xyz * (s_mat @ v_xyz)).sum(dim=0)
            # 2 diag(C_k W C_rest)_r = 2 sum_k (v_k,r / lambda_k)
            # (C_rest W v_k)_r, from the extra columns
            y_rest = _deflated(x[:, n_cols:], z[:, n_cols:], vals_k, v_xyz)
            s_cross = 2.0 * ((v_xyz.T / vals_k[None, :]) * y_rest).sum(dim=1)
            s_mean, s_sem = _mean_and_sem(
                (v[:, :, probes:] ** 2).sum(dim=0))
            s_num = (s_k2 + s_cross).reshape(3, n).sum(dim=0) + s_mean
    else:
        # per-probe per-atom samples: fold the three components
        samples = (x.reshape(3, n, n_cols) ** 2).sum(dim=0)   # (n, cols)
        e_num, e_sem = _mean_and_sem(samples[:, :probes])     # row sums
        if norm:
            s_num, s_sem = _mean_and_sem(samples[:, probes:])  # sum w P_ij

    if norm:
        effector = (e_num - prs_diag) / ((n - 1) * prs_diag)
        sensor = (s_num - 1.0) / (n - 1)
        effector_stderr = e_sem / ((n - 1) * prs_diag)
        sensor_stderr = s_sem / (n - 1)
    else:
        # the raw folded PRS is symmetric: both profiles are the
        # diagonal-excluded row means
        effector = (e_num - prs_diag) / (n - 1)
        sensor = effector.clone()
        effector_stderr = e_sem / (n - 1)
        sensor_stderr = effector_stderr.clone()
    return (effector, sensor, effector_stderr, sensor_stderr, n_it, res)
