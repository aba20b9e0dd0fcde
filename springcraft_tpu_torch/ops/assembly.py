"""
Dense ANM Hessian and GNM Kirchhoff assembly.

Counterpart of ``springcraft_tpu/ops/assembly.py:43-325`` for
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

The JAX package's single-structure functions, on one ``(n, 3)``
structure in any float dtype: :func:`kirchhoff_matrix` and
:func:`hessian_matrix` (``layout="atom"``, the reference's interleaved
components, or ``"xyz"``, the component planes), and the row panels
:func:`kirchhoff_rows` and :func:`hessian_rows` (atom layout) that the
float64 refinement of :mod:`.modes` streams without a resident matrix;
:func:`atom_to_xyz_permutation` and :func:`mass_weights`.
"""

from __future__ import annotations

import torch

from .ffparams import (_bin_indices, _within_cutoff, force_constant_matrix,
                       force_constants, overlay_pair_delta,
                       pairwise_sq_distance, rect_base_constants,
                       squared_norm)

__all__ = [
    "kirchhoff_matrix",
    "kirchhoff_rows",
    "hessian_matrix",
    "hessian_rows",
    "atom_to_xyz_permutation",
    "mass_weights",
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


# ---------------------------------------------------------------------------
# Single structures: dense matrices and row panels
# ---------------------------------------------------------------------------

def _as_coord(coord, dtype):
    coord = torch.as_tensor(coord)
    return coord if dtype is None else coord.to(dtype)


def kirchhoff_matrix(coord, params, dtype=None):
    """Dense Kirchhoff matrix ``(n, n)`` of one structure ``(n, 3)``:
    ``-k_ij`` off the diagonal, the column sums of ``k`` on it
    (reference ``interaction.py:14-54``)."""
    coord = _as_coord(coord, dtype)
    _, sq = pairwise_sq_distance(coord)
    k = force_constant_matrix(sq, params, dtype=coord.dtype)
    return torch.diag(k.sum(dim=0)) - k


def _row_force_constants(sq, params, row_start, block):
    """Masked spring constants ``(block, n)`` of the rows ``row_start``
    ... ``row_start + block - 1``: an analytic family or a table, no
    overlays (their O(n^2) masks go through the dense functions)."""
    if params.overlays:
        raise NotImplementedError(
            "Blocked assembly does not support patch overlays; use the "
            "dense path")
    n = sq.shape[-1]
    params._check_atoms(n)
    rows = torch.arange(row_start, row_start + block, device=sq.device)
    cols = torch.arange(n, device=sq.device)
    if params.kind == "table_pair":
        dev = params.device_tables(sq.device, sq.dtype)
        table = dev["pair_table"][row_start:row_start + block]
        bins = _bin_indices(sq, params, dev["edges"])
        k = table[..., 0] if bins is None else torch.gather(
            table, -1, bins[..., None])[..., 0]
    else:
        k = rect_base_constants(params, sq, rows, cols)
    adj = rows[:, None] != cols[None, :]
    if params.has_cutoff:
        adj = adj & _within_cutoff(sq, params)
    return torch.where(adj, k, torch.zeros_like(k))


def _row_geometry(coord, row_start, block):
    rows = coord[row_start:row_start + block]
    disp = rows[:, None, :] - coord[None, :, :]
    return disp, squared_norm(disp)


def _row_diagonal_mask(row_start, block, n, device):
    rows = torch.arange(row_start, row_start + block, device=device)
    return rows[:, None] == torch.arange(n, device=device)[None, :]


def kirchhoff_rows(coord, params, row_start, block, dtype=None):
    """Rows ``row_start`` ... ``row_start + block - 1`` ``(block, n)`` of
    the Kirchhoff matrix without the rest of it: each row's diagonal is
    its own row sum of spring constants."""
    coord = _as_coord(coord, dtype)
    _, sq = _row_geometry(coord, row_start, block)
    k = _row_force_constants(sq, params, row_start, block)
    eye = _row_diagonal_mask(row_start, block, coord.shape[0], coord.device)
    return torch.where(eye, k.sum(dim=1)[:, None], -k)


def _superelements(g, disp):
    """``g d d^T`` as ``(..., 3, 3)`` superelements, ``d`` the pair
    displacements ``(..., 3)``."""
    return g[..., None, None] * disp[..., :, None] * disp[..., None, :]


def hessian_matrix(coord, params, dtype=None, layout="atom"):
    """Dense ``(3n, 3n)`` Hessian of one structure ``(n, 3)``: ``-k / d^2
    d d^T`` superelements off the diagonal, the negated column sums on it
    (reference ``interaction.py:57-111``).  `layout` ``"atom"``
    interleaves the components per atom (the reference's layout),
    ``"xyz"`` groups them in component planes (the kernels' layout)."""
    if layout not in ("atom", "xyz"):
        raise ValueError(f"Unknown layout '{layout}'")
    coord = _as_coord(coord, dtype)
    n = coord.shape[0]
    disp, sq = pairwise_sq_distance(coord)
    k = force_constant_matrix(sq, params, dtype=coord.dtype)
    off = _superelements(-k / torch.where(sq == 0, torch.ones_like(sq), sq),
                         disp)
    eye = torch.eye(n, dtype=torch.bool, device=coord.device)[..., None, None]
    full = torch.where(eye, -off.sum(dim=0)[:, None], off)
    perm = (0, 2, 1, 3) if layout == "atom" else (2, 0, 3, 1)
    return full.permute(perm).reshape(3 * n, 3 * n)


def hessian_rows(coord, params, row_start, block, dtype=None):
    """Atom rows ``row_start`` ... ``row_start + block - 1`` of the
    atom-layout Hessian, ``(3 block, 3n)``, without the rest of it: the
    diagonal superelement of a row is the negated sum of its own row's
    superelements (equal to the column sum by symmetry)."""
    coord = _as_coord(coord, dtype)
    n = coord.shape[0]
    disp, sq = _row_geometry(coord, row_start, block)
    k = _row_force_constants(sq, params, row_start, block)
    off = _superelements(-k / torch.where(sq == 0, torch.ones_like(sq), sq),
                         disp)
    eye = _row_diagonal_mask(row_start, block, n, coord.device)
    full = torch.where(eye[..., None, None], -off.sum(dim=1)[:, None], off)
    return full.permute(0, 2, 1, 3).reshape(3 * block, 3 * n)


def atom_to_xyz_permutation(n, device=None):
    """Permutation ``p`` with ``H_xyz = H_atom[p][:, p]``: index ``(a,
    i)`` of the xyz layout is ``3 i + a`` of the atom layout."""
    return (torch.arange(3, device=device)[:, None]
            + 3 * torch.arange(n, device=device)[None, :]).reshape(-1)


def mass_weights(masses, repeat3=False):
    """Mass-weight matrix ``outer(1/sqrt(m), 1/sqrt(m))``, each weight
    repeated three times for a Hessian with `repeat3` (reference
    ``anm.py:89-96``, ``gnm.py:85-89``)."""
    w = 1.0 / torch.sqrt(torch.as_tensor(masses))
    if repeat3:
        w = w.repeat_interleave(3)
    return torch.outer(w, w)
