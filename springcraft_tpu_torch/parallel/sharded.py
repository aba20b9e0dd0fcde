"""
Mesh-sharded execution: data-parallel ensemble NMA and row-sharded
mega-assembly Hessians.

Counterpart of ``springcraft_tpu/parallel/sharded.py``, on a
:class:`.mesh.Mesh` driven by one process: each shard is a tensor on its
own device, and the copies between devices that XLA inserted there are
explicit here.

* **Ensemble NMA** (``sharded_ensemble_*``, :func:`ensemble_mean_msf`):
  the conformer batch is split over the whole mesh, and each shard runs
  the single-device entry point of :mod:`.pipeline` with the shard's
  ``device=``, so its kernels run exactly as the unsharded call runs
  them.  Outputs are gathered on the mesh's first device.
* **Row-sharded Hessian** (:func:`sharded_hessian`): the ``"row"`` index
  ``r`` computes atom rows ``[r n/R, (r + 1) n/R)`` from the replicated
  coordinates with the plain :func:`..ops.assembly.hessian_rows` on
  ``mesh.devices[0][r]`` (each atom's diagonal superelement is the
  negated sum of its own row, so no shard needs another's rows).
* **Matrix-free operator** (:func:`sharded_hessian_apply`): device ``d``
  of the flat order computes its atom rows of ``H @ X`` against every
  column atom — in float32 on CUDA kernel K12 over the row range
  (``csrc/matfree_hessian.cu``; its plain version on the CPU), in
  float64 the plain row blocks of :func:`..ops.matfree.hessian_apply` —
  then the rows are gathered.  Patch overlays add their sparse
  correction's rows of each shard.  (The JAX package's sharded operator
  drops overlays: it rebuilds the parameters from the kind, the cutoff
  and the bins only.)
* :func:`sharded_lowest_modes` runs LOBPCG over the row shards (one
  product a shard, the Gershgorin bound from each shard's rows) without
  gathering the matrix; :func:`sharded_covariance` factors once on the
  first device and solves each device's identity columns there;
  :func:`sharded_anm_pipeline` gathers the Hessian for
  ``torch.linalg.eigh``, as XLA gathers it for its dense solver.

Tensor outputs lie on the mesh's first device (the counterpart of
reading a global ``jax.Array``); matrices the JAX package returns
sharded come back as a :class:`.mesh.ShardedTensor`.  A ``device=``
option is refused: the mesh places the shards.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import assembly, matfree, modes, nma_core, rigid
from . import pipeline
from .mesh import ShardedTensor, ensemble_sharding

__all__ = [
    "sharded_ensemble_anm",
    "sharded_ensemble_gnm",
    "sharded_ensemble_anm_banded",
    "sharded_ensemble_anm_fluctuations",
    "sharded_ensemble_gnm_banded",
    "sharded_hessian",
    "sharded_hessian_apply",
    "sharded_lowest_modes",
    "sharded_lowest_modes_matfree",
    "sharded_covariance",
    "ensemble_mean_msf",
]


def _refuse_device(options):
    if "device" in options:
        raise ValueError("device= is not taken here: the mesh places the "
                         "shards (build the mesh over the devices wanted)")


def _replicate(x, dtype, device):
    """`x` (a tensor on any device, or array-like) as a tensor of `dtype`
    on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _copies(tensors, devices):
    """``{device: copies of tensors}`` over the distinct `devices`: one
    copy a device, however often a mesh names it."""
    return {dev: tuple(t.to(dev) for t in tensors)
            for dev in dict.fromkeys(devices)}


def _shard_batch(run, coords, mesh, masses):
    """``run(chunk, masses, device)`` on each device's equal share of the
    conformers (``(B, n, 3)``, B divisible by the mesh size), its outputs
    concatenated on the mesh's first device."""
    if not isinstance(coords, torch.Tensor):
        coords = np.asarray(coords)
    bounds = ensemble_sharding(mesh).bounds(coords.shape[0])
    outs = []
    for (start, stop), dev in zip(bounds, mesh.flat):
        chunk = coords[start:stop]
        if isinstance(chunk, torch.Tensor):
            chunk = chunk.to(dev)
        shard_masses = (masses.to(dev) if isinstance(masses, torch.Tensor)
                        else masses)
        outs.append(run(chunk, shard_masses, dev))
    first = mesh.flat[0]
    return {key: torch.cat([out[key].to(first) for out in outs])
            for key in outs[0]}


def _ensemble(entry, coords, params, mesh, masses, options):
    _refuse_device(options)
    return _shard_batch(
        lambda chunk, m, dev: entry(chunk, params, masses=m, device=dev,
                                    **options), coords, mesh, masses)


def sharded_ensemble_anm(coords, params, mesh, masses=None, **options):
    """
    Data-parallel ensemble ANM over `mesh`: the conformer batch is
    sharded across all devices and each device runs complete NMA solves
    for its shard (:func:`.pipeline.ensemble_anm` with its `options`).

    `coords` has shape ``(b, n, 3)`` with ``b`` divisible by the mesh
    size.
    """
    return _ensemble(pipeline.ensemble_anm, coords, params, mesh, masses,
                     options)


def sharded_ensemble_gnm(coords, params, mesh, masses=None, **options):
    """Data-parallel ensemble GNM (see :func:`sharded_ensemble_anm`)."""
    return _ensemble(pipeline.ensemble_gnm, coords, params, mesh, masses,
                     options)


def sharded_ensemble_anm_fluctuations(coords, params, mesh, masses=None,
                                      **options):
    """Data-parallel fast-covariance ensemble ANM over `mesh`
    (see :func:`sharded_ensemble_anm`).

    Defaults to the ``cho_solve`` covariance engine, as the JAX package
    does; ``inverse="blocked"`` (the kernels) runs the same per-shard
    call that its ``shard_map`` ran."""
    options.setdefault("inverse", "cho_solve")
    return _ensemble(pipeline.ensemble_anm_fluctuations, coords, params,
                     mesh, masses, options)


def sharded_ensemble_anm_banded(coords, params, mesh, masses=None,
                                **options):
    """Banded full-eigensystem ensemble ANM
    (:func:`.pipeline.ensemble_anm_banded`) with the conformer batch
    sharded over the whole mesh: each device runs the two-stage banded
    solver (band reduction, bisection, inverse iteration) on its
    shard."""
    return _ensemble(pipeline.ensemble_anm_banded, coords, params, mesh,
                     masses, options)


def sharded_ensemble_gnm_banded(coords, params, mesh, masses=None,
                                **options):
    """GNM counterpart of :func:`sharded_ensemble_anm_banded`."""
    return _ensemble(pipeline.ensemble_gnm_banded, coords, params, mesh,
                     masses, options)


def ensemble_mean_msf(coords, params, mesh, kind="anm"):
    """
    Mean MSF profile over a sharded conformer ensemble: each device sums
    its shard's MSF profiles (the default float32
    :func:`.pipeline.ensemble_anm` / :func:`.pipeline.ensemble_gnm`), and
    the sums are reduced on the mesh's first device.
    """
    run = pipeline.ensemble_anm if kind == "anm" else pipeline.ensemble_gnm
    sums = _shard_batch(
        lambda chunk, _, dev: {"msf": run(chunk, params, device=dev)["msf"]
                               .sum(dim=0, keepdim=True)},
        coords, mesh, None)["msf"]
    return sums.sum(dim=0) / len(coords)


def sharded_hessian(coord, params, mesh, dtype=torch.float32):
    """
    Row-sharded ``(3n, 3n)`` Hessian (atom layout): the ``"row"`` index
    ``r`` computes atom rows ``[r * n/R, (r+1) * n/R)`` on
    ``mesh.devices[0][r]``; no copies between devices are needed (see
    module docstring).

    ``n`` must be divisible by the size of the ``"row"`` axis.  Returns a
    :class:`.mesh.ShardedTensor` of the row blocks.  Patch overlays raise
    ``NotImplementedError``, as in the JAX package.
    """
    coord = _replicate(coord, dtype, mesh.flat[0])
    n = coord.shape[0]
    n_row = mesh.shape["row"]
    if n % n_row != 0:
        raise ValueError(
            f"n={n} must be divisible by the row axis size {n_row}"
        )
    block = n // n_row
    return ShardedTensor(tuple(
        assembly.hessian_rows(coord.to(dev), params, r * block, block,
                              dtype=dtype)
        for r, dev in enumerate(mesh.devices[0])), 0)


def _rows_of_apply(coord, x, params, start, n_rows, block):
    """Rows ``start`` ... ``start + n_rows - 1`` of each plane of ``H @
    x`` (`x` ``(3n, k)``), ``(3, n_rows, k)``: K12 over the range in
    float32 (its plain version on the CPU), the plain row blocks in any
    other dtype; the overlays' rows of their sparse correction added."""
    n, k = coord.shape[0], x.shape[1]
    if coord.dtype == torch.float32:
        y = matfree._launch_dense(coord, x, params, 256, start, n_rows)
    else:
        y = matfree._hessian_apply_rows(coord, x, params, block, start,
                                        start + n_rows)
        y = y.reshape(3 * n_rows, k)
        if params.overlays:
            y = y + matfree._plane_rows(
                matfree.overlay_apply_hessian(coord, x, params,
                                              dtype=coord.dtype),
                n, start, n_rows)
    return y.reshape(3, n_rows, k)


def sharded_hessian_apply(coord, x, params, mesh, *, block=512,
                          dtype=torch.float32):
    """
    Matrix-free ``H @ x`` with the atom rows sharded over the whole
    mesh: each device computes its row block against the replicated
    coordinates and vectors (K12 over the row range in float32 on CUDA),
    and the blocks are gathered on the mesh's first device.

    Memory per device is O(k n) plus the kernel's (or, in float64, the
    row blocks' O(block n)) workspace, never O(n^2).  ``n`` must be
    divisible by the mesh size.  Patch overlays are applied (the JAX
    package's sharded operator drops them).
    """
    matfree._check_params(params)
    first = mesh.flat[0]
    coord = matfree._coord(_replicate(coord, dtype, first), dtype, None)
    n = coord.shape[0]
    if n % mesh.size != 0:
        raise ValueError(
            f"n={n} must be divisible by the mesh size {mesh.size}")
    xb, squeeze = matfree._columns(_replicate(x, dtype, first), 3 * n,
                                   coord)
    xb = xb.contiguous()
    n_local = n // mesh.size
    block = min(block, n_local)
    copies = _copies((coord, xb), mesh.flat)
    parts = [_rows_of_apply(*copies[dev], params, d * n_local, n_local,
                            block).to(first)
             for d, dev in enumerate(mesh.flat)]
    y = torch.cat(parts, dim=1).reshape(3 * n, xb.shape[1])
    return y[:, 0] if squeeze else y


def sharded_lowest_modes_matfree(coord, params, mesh, k, *, masses=None,
                                 block=512, dtype=torch.float32, **options):
    """
    Lowest non-trivial ANM modes of a system whose Hessian fits no
    single device: Chebyshev-filtered subspace iteration over the
    mesh-sharded matrix-free operator (see
    :func:`..ops.matfree.lowest_modes_matfree` for the algorithm and
    options; returns ``(values, modes, residuals)`` on the mesh's first
    device).  With a ``matvec`` the solver's default `oversample` is
    ``max(k, 8)``.
    """
    _refuse_device(options)
    first = mesh.flat[0]
    coord = _replicate(coord, dtype, first)
    if masses is not None:
        masses = _replicate(masses, dtype, first)
    matvec = functools.partial(sharded_hessian_apply, coord,
                               params=params, mesh=mesh, block=block,
                               dtype=dtype)
    return matfree.lowest_modes_matfree(
        coord, params, k, masses=masses, dtype=dtype, matvec=matvec,
        **options)


def sharded_lowest_modes(coord, params, mesh, k, dtype=torch.float32,
                         n_iter=200):
    """
    Lowest non-trivial ANM modes of a mega-assembly on a mesh: the
    Hessian is built row-sharded (:func:`sharded_hessian`) and stays
    sharded through the LOBPCG iteration of
    :func:`..ops.modes.lowest_modes` — each product ``H @ X`` one
    product a row shard, its rows gathered on the mesh's first device,
    the Gershgorin bound the largest of the shards' row sums.  Below
    ``m = 5 k`` a dense ``eigh`` of the gathered matrix, as there.
    """
    hessian = sharded_hessian(coord, params, mesh, dtype=dtype)
    first = mesh.flat[0]
    coord = _replicate(coord, dtype, first)
    basis = rigid.rigid_modes_anm(coord, layout="atom")
    m = hessian.shape[0]
    if 5 * k >= m:
        return modes.lowest_modes(hessian.full(first), k, null_basis=basis,
                                  n_iter=n_iter)

    def matvec(x):
        return torch.cat([shard @ x.to(shard.device)
                          for shard in hessian.shards]).to(first)

    upper = torch.stack([shard.abs().sum(dim=1).max().to(first)
                         for shard in hessian.shards]).max()
    return modes._lobpcg_lowest(matvec, upper, m, k, basis, n_iter, seed=0)


def sharded_covariance(coord, params, mesh, dtype=torch.float32,
                       sigma=None):
    """
    Mega-assembly pseudo-inverse covariance on a mesh: the regularized,
    equilibrated Hessian is factored once on the mesh's first device,
    the factor is copied to each device, and each device solves its own
    block of identity columns — the covariance comes back column-sharded
    (a :class:`.mesh.ShardedTensor` over the flat order).
    """
    first = mesh.flat[0]
    coord = _replicate(coord, dtype, first)
    n3 = 3 * coord.shape[0]
    n_dev = mesh.size
    if n3 % n_dev != 0:
        raise ValueError(f"3n={n3} must be divisible by the mesh size "
                         f"{n_dev}")

    hessian = sharded_hessian(coord, params, mesh, dtype=dtype).full(first)
    basis = rigid.rigid_modes_anm(coord, layout="atom")
    sig = (torch.diagonal(hessian).mean() if sigma is None
           else torch.as_tensor(sigma, dtype=hessian.dtype, device=first))
    reg = hessian + sig * (basis @ basis.T)
    del hessian
    scale = 1.0 / torch.sqrt(torch.diagonal(reg))
    reg = reg * scale[:, None] * scale[None, :]
    chol = torch.linalg.cholesky(reg)
    del reg
    copies = _copies((chol, basis, scale, sig), mesh.flat)
    block = n3 // n_dev
    shards = []
    for d, dev in enumerate(mesh.flat):
        chol_d, t_d, scale_d, sig_d = copies[dev]
        cols = slice(d * block, (d + 1) * block)
        rhs = torch.zeros((n3, block), dtype=chol_d.dtype, device=dev)
        rhs[cols] = torch.eye(block, dtype=chol_d.dtype, device=dev)
        sol = torch.cholesky_solve(rhs, chol_d)
        sol = sol * scale_d[:, None] * scale_d[cols][None, :]
        shards.append(sol - (t_d @ t_d[cols].T) / sig_d)
    return ShardedTensor(tuple(shards), 1)


def sharded_anm_pipeline(coord, params, mesh, dtype=torch.float32,
                         n_modes=None):
    """
    Mega-assembly ANM: build the Hessian row-sharded across the mesh,
    then gather it on the mesh's first device for ``torch.linalg.eigh``
    (as XLA gathers it for its dense solver) and reduce to observables
    (``eig_values``, ``msf``, ``bfactor``).
    """
    first = mesh.flat[0]
    hessian = sharded_hessian(coord, params, mesh, dtype=dtype).full(first)
    m = hessian.shape[0]
    if n_modes is not None and not (0 < n_modes <= m - 6):
        raise ValueError(
            f"n_modes={n_modes} must be in [1, {m - 6}]"
        )
    vals, vecs = torch.linalg.eigh(hessian)
    stop = m if n_modes is None else 6 + n_modes
    msf = nma_core.mean_square_fluctuation(
        vals, vecs.T, torch.arange(6, stop, device=first), num_dim=3,
        layout="atom")
    return {"eig_values": vals, "msf": msf,
            "bfactor": nma_core.bfactor_from_msf(msf)}
