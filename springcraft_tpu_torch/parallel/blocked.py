"""
Distributed blocked Cholesky and triangular solves for mega-assembly
all-mode covariance.

Counterpart of ``springcraft_tpu/parallel/blocked.py``, in plain torch
as the JAX package is plain XLA there: per panel a ``b x b``
``torch.linalg.cholesky``, ``torch.linalg.solve_triangular`` and one
rank-``b`` matrix product.  Without a sharding every function works on
one tensor.  With a :class:`.mesh.Sharding` the matrix being factored
is kept as row shards (``Sharding(mesh, 0)``) and the right-hand side of
the solves as column shards (``Sharding(mesh, 1)``), each on its device:
a step gathers the ``(n, b)`` panel it needs on the first shard's device
and copies it to the devices, so no device holds more than its
``n^2 / R`` of the matrix, its ``n^2 / R`` of the solution and ``O(n b)``
of panels (the JAX package's bound; there GSPMD inserts the copies).

Algorithms (right-looking, panel width ``b``):

* :func:`blocked_cholesky` — per panel: factor the ``b x b`` diagonal
  block, triangular-solve the panel column, one symmetric rank-``b``
  update of the trailing rows and columns (the JAX package updates the
  whole matrix with a zero-padded panel; the entries it changes are
  these).
* :func:`blocked_solve_lower` / :func:`blocked_solve_lower_t` —
  forward/backward substitution in row panels; each step is one
  ``(n, b) @ (b, m)`` product a column shard.

Sharded inputs and outputs are :class:`.mesh.ShardedTensor`; the
functions take a plain tensor too and split it by the sharding.
"""

from __future__ import annotations

import torch

from ..ops import nma_core, rigid
from .mesh import Sharding, ShardedTensor
from .sharded import _copies, _replicate, sharded_hessian

__all__ = [
    "blocked_cholesky",
    "blocked_solve_lower",
    "blocked_solve_lower_t",
    "sharded_covariance_blocked",
    "sharded_all_mode_msf",
]


def _shards(x, sharding, dim, copy):
    """`x` as a list of tensors split along `dim` (one tensor without a
    sharding), copies of them with `copy`, and whether it is sharded."""
    if sharding is not None and sharding.dim != dim:
        what = "rows (Sharding(mesh, 0))" if dim == 0 else \
            "columns (Sharding(mesh, 1))"
        raise ValueError(f"this operand is split by {what}, got "
                         f"dim={sharding.dim}")
    if isinstance(x, ShardedTensor):
        if x.dim != dim:
            raise ValueError(f"a ShardedTensor split along dim {x.dim} "
                             f"where dim {dim} is expected")
        return [s.clone() if copy else s for s in x.shards], True
    if sharding is not None:
        return list(sharding.split(x).shards), True
    return [x.clone() if copy else x], False


def _devices(shards):
    return [s.device for s in shards]


def _starts(shards, dim):
    starts, total = [], 0
    for s in shards:
        starts.append(total)
        total += s.shape[dim]
    return starts


def _row_panel(shards, starts, r0, r1, device):
    """Rows ``r0`` ... ``r1 - 1`` of row shards, gathered on `device`."""
    parts = [s[max(r0 - a, 0):min(r1 - a, s.shape[0])].to(device)
             for a, s in zip(starts, shards)
             if a < r1 and a + s.shape[0] > r0]
    return torch.cat(parts)


def _col_panel(shards, starts, r0, c0, c1, device):
    """Columns ``c0`` ... ``c1 - 1`` of the rows from ``r0`` on of row
    shards, gathered on `device`."""
    return torch.cat([s[max(r0 - a, 0):, c0:c1].to(device)
                      for a, s in zip(starts, shards)
                      if a + s.shape[0] > r0])


def _cholesky_in_place(shards, block):
    """Right-looking blocked Cholesky of the row shards, in place; the
    lower factor stays in their lower triangle (the rest is left as it
    was)."""
    starts = _starts(shards, 0)
    n = shards[0].shape[1]
    if n % block != 0:
        raise ValueError(f"block={block} must divide n={n}")
    first = shards[0].device
    for c in range(0, n, block):
        e = c + block
        panel = _col_panel(shards, starts, c, c, e, first)  # rows c ...
        lkk = torch.linalg.cholesky(panel[:block])
        # x = panel @ inv(lkk)^T below the diagonal block
        x = torch.linalg.solve_triangular(lkk, panel[block:].T,
                                          upper=False).T
        lpanel = torch.cat([lkk, x])       # rows c ... n - 1 of L's panel
        copies = _copies((lpanel,), _devices(shards))
        for a, s in zip(starts, shards):
            (lp,) = copies[s.device]
            rows = s.shape[0]
            # the finished L panel (zeros above the diagonal block)
            lo, hi = max(c - a, 0), rows
            s[:lo, c:e] = 0
            if lo < hi:
                s[lo:hi, c:e] = lp[a + lo - c:a + hi - c]
            # rank-b trailing update of rows and columns >= e
            lo = max(e - a, 0)
            if lo < rows:
                xr = lp[a + lo - c:a + rows - c]
                s[lo:, e:] -= xr @ lp[block:].T
    for a, s in zip(starts, shards):
        s.tril_(a)
    return shards


def _result(shards, dim, sharded):
    return ShardedTensor(tuple(shards), dim) if sharded else shards[0]


def blocked_cholesky(a, block, sharding=None):
    """
    Lower Cholesky factor of a symmetric positive-definite matrix by
    right-looking panel factorization.

    Parameters
    ----------
    a : Tensor or ShardedTensor, shape=(n, n)
        SPD matrix; ``n`` must be divisible by `block`.  Only its lower
        triangle and the diagonal blocks are read.
    block : int
        Panel width.
    sharding : Sharding, optional
        Row sharding (``Sharding(mesh, 0)``) to keep the work matrix in
        throughout the factorization; a row-sharded `a` keeps its own.

    Returns
    -------
    l : Tensor, or ShardedTensor of row shards, shape=(n, n)
        Lower-triangular factor with ``l @ l.T == a``.
    """
    shards, sharded = _shards(a, sharding, 0, copy=True)
    return _result(_cholesky_in_place(shards, block), 0, sharded)


def _solve_in_place(l, ys, block, transpose):
    """Forward (``L Y = B``) or, `transpose`, backward (``L^T X = B``)
    substitution over the column shards `ys`, in place."""
    lshards, _ = _shards(l, None, 0, copy=False)
    starts = _starts(lshards, 0)
    n = lshards[0].shape[1]
    if n % block != 0:
        raise ValueError(f"block={block} must divide n={n}")
    first = lshards[0].device
    panels = range(0, n, block)
    for c in (reversed(panels) if transpose else panels):
        e = c + block
        if transpose:
            lrow = _row_panel(lshards, starts, c, e, first)   # (b, n)
            lkk, rest = lrow[:, c:e], lrow[:, :c].T
        else:
            lcol = _col_panel(lshards, starts, c, c, e, first)  # rows c ...
            lkk, rest = lcol[:block], lcol[block:]
        copies = _copies((lkk, rest), _devices(ys))
        for y in ys:
            lkk_d, rest_d = copies[y.device]
            if transpose:
                xk = torch.linalg.solve_triangular(lkk_d.T, y[c:e],
                                                   upper=True)
                y[c:e] = xk
                y[:c] -= rest_d @ xk
            else:
                xk = torch.linalg.solve_triangular(lkk_d, y[c:e],
                                                   upper=False)
                y[c:e] = xk
                y[e:] -= rest_d @ xk
    return ys


def blocked_solve_lower(l, rhs, block, sharding=None):
    """
    Solve ``L Y = rhs`` (forward substitution) in row panels.  `l` is a
    tensor or the row shards of :func:`blocked_cholesky`; `rhs` may be
    column-sharded (``Sharding(mesh, 1)``, or a column-sharded
    ShardedTensor) — each panel step is one ``(n, b) @ (b, m)`` product
    a column shard.
    """
    ys, sharded = _shards(rhs, sharding, 1, copy=True)
    return _result(_solve_in_place(l, ys, block, False), 1, sharded)


def blocked_solve_lower_t(l, rhs, block, sharding=None):
    """Solve ``L^T X = rhs`` (backward substitution) in row panels;
    arguments as :func:`blocked_solve_lower`."""
    ys, sharded = _shards(rhs, sharding, 1, copy=True)
    return _result(_solve_in_place(l, ys, block, True), 1, sharded)


def _reshard_rows(x, sharding):
    """Row shards `x` resplit over the flat order of `sharding`'s mesh,
    one target shard at a time (a shard already in place is kept)."""
    starts = _starts(x.shards, 0)
    out = []
    for (r0, r1), dev in zip(sharding.bounds(x.shape[0]),
                             sharding.mesh.flat):
        same = [s for a, s in zip(starts, x.shards)
                if a == r0 and s.shape[0] == r1 - r0 and s.device == dev]
        out.append(same[0] if same else
                   _row_panel(x.shards, starts, r0, r1, dev))
    return ShardedTensor(tuple(out), 0)


def _prepare(coord, params, mesh, dtype):
    first = mesh.flat[0]
    coord = _replicate(coord, dtype, first)
    hessian = sharded_hessian(coord, params, mesh, dtype=dtype)
    basis = rigid.rigid_modes_anm(coord, layout="atom").to(dtype)
    starts = _starts(hessian.shards, 0)
    diag = torch.cat([torch.diagonal(s, offset=a).to(first)
                      for a, s in zip(starts, hessian.shards)])
    return hessian, basis, diag.mean()


def _blocked_msf(hessian, t, sig, mesh, block, full_cov):
    """The regularized, equilibrated Hessian factored by the blocked
    Cholesky in row shards over the whole mesh, then ``L^{-1}`` of the
    column-sharded identity: ``(covariance column shards or None, its
    diagonal)``, the diagonal on the first device."""
    first = mesh.flat[0]
    row_sh, col_sh = Sharding(mesh, 0), Sharding(mesh, 1)
    # reg = H + sig T T^T, equilibrated; in place on the row shards (the
    # resplit Hessian is this function's own)
    reg = _reshard_rows(hessian, row_sh)
    del hessian
    starts = _starts(reg.shards, 0)
    copies = _copies((t, sig), _devices(reg.shards))
    for a, s in zip(starts, reg.shards):
        t_d, sig_d = copies[s.device]
        s += sig_d * (t_d[a:a + s.shape[0]] @ t_d.T)
    scale = 1.0 / torch.sqrt(torch.cat([
        torch.diagonal(s, offset=a).to(first)
        for a, s in zip(starts, reg.shards)]))
    copies = _copies((scale,), _devices(reg.shards))
    for a, s in zip(starts, reg.shards):
        (scale_d,) = copies[s.device]
        s *= scale_d[a:a + s.shape[0], None] * scale_d[None, :]
    chol = ShardedTensor(tuple(_cholesky_in_place(list(reg.shards), block)),
                         0)

    n3 = chol.shape[0]
    bounds = col_sh.bounds(n3)
    eye = []
    for (c0, c1), dev in zip(bounds, mesh.flat):
        cols = torch.zeros((n3, c1 - c0), dtype=chol.dtype, device=dev)
        cols[c0:c1] = torch.eye(c1 - c0, dtype=chol.dtype, device=dev)
        eye.append(cols)
    y = _solve_in_place(chol, eye, block, False)
    copies = _copies((t, sig, scale), _devices(y))
    if full_cov:
        z = _solve_in_place(chol, y, block, True)
        cov, diag = [], []
        for (c0, c1), zs in zip(bounds, z):
            t_d, sig_d, scale_d = copies[zs.device]
            zs *= scale_d[:, None] * scale_d[None, c0:c1]
            zs -= (t_d @ t_d[c0:c1].T) / sig_d
            cov.append(zs)
            diag.append(torch.diagonal(zs, offset=-c0).to(first))
        return ShardedTensor(tuple(cov), 1), torch.cat(diag)
    # inv(reg_scaled) = Y^T Y -> its diagonal is the squared column norms
    # of Y; undo the equilibration, subtract the null-space term
    diag_inv = torch.cat([
        ((ys * ys).sum(dim=0) * copies[ys.device][2][c0:c1] ** 2).to(first)
        for (c0, c1), ys in zip(bounds, y)])
    return None, diag_inv - (t * t).sum(dim=1) / sig


def sharded_covariance_blocked(coord, params, mesh, block=1024,
                               dtype=torch.float32):
    """
    Mega-assembly all-mode covariance (atom layout, reference
    ``pinv(hessian, rcond=1e-6)`` semantics via the regularized
    null-space Cholesky) with **no replicated factor**: the Hessian is
    born row-sharded, the blocked Cholesky keeps it row-sharded over the
    whole mesh, and both triangular solves run on a column-sharded
    identity.  Returns the covariance's column shards (a
    :class:`.mesh.ShardedTensor` over the flat order).
    """
    hessian, basis, sig = _prepare(coord, params, mesh, dtype)
    cov, _ = _blocked_msf(hessian, basis, sig, mesh, block, True)
    return cov


def sharded_all_mode_msf(coord, params, mesh, block=1024,
                         dtype=torch.float32):
    """
    All-mode MSF + B-factors of a mega-assembly ANM on a mesh, via one
    distributed triangular solve (the covariance diagonal equals the
    squared column norms of ``L^{-1}``) — half the work and none of the
    replication of the full-covariance path.  ``{"msf", "bfactor"}`` on
    the mesh's first device.
    """
    hessian, basis, sig = _prepare(coord, params, mesh, dtype)
    _, diag_cov = _blocked_msf(hessian, basis, sig, mesh, block, False)
    n = diag_cov.shape[0] // 3
    msf = diag_cov.reshape(n, 3).sum(dim=1)  # atom layout
    return {"msf": msf, "bfactor": nma_core.bfactor_from_msf(msf)}
