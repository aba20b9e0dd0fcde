"""
Fluctuation NMA from coordinates, without an eigendecomposition.

Counterpart of ``springcraft_tpu/parallel/pipeline.py:40-46, 199-265,
605-701, 704-748, 797-847, 854-931``:

* :func:`ensemble_anm_fluctuations` and :func:`ensemble_gnm_fluctuations`
  go over a conformer ensemble with the ``"blocked"`` engine (the main
  path) or the ``"cho_solve"`` engine;
* :func:`anm_fluctuations` and :func:`gnm_fluctuations` solve one
  structure with the Cholesky engine.

The ANM blocked engine runs per chunk of conformers:

1. rigid-body bases (``torch.linalg.qr``);
2. raw Hessian planes — kernel ``hessian_planes.cu``;
3. regularized, equilibrated, identity-padded factor input — kernel
   ``regularize_stitch.cu``;
4. divide-and-conquer inverse factor — ``torch.matmul`` nodes, kernel
   ``panel_inverse.cu`` at the 64-wide leaves;
5. blockwise plane-trace Grams or, with ``with_covariance``, the Gram of
   the whole column-scaled factor (``torch.matmul``);
6. observables.

The GNM blocked engine assembles Kirchhoff matrices (kernel
``kirchhoff.cu``), regularizes them with the shared constant null mode in
plain PyTorch (the JAX package has no stitch kernel for GNM) and runs
steps 4 to 6.  The ``cho_solve`` engines and the single-structure entry
points assemble dense matrices with the kernels in float32
(``hessian_planes.cu``'s xyz-layout store, ``kirchhoff.cu``) and with
their plain versions in any other dtype — the JAX package's rule
(``_resolve_use_pallas``: the kernels are float32-only) — then factor
with ``torch.linalg``.

The JAX package maps chunks inside one device program to pay a relay's
per-call dispatch floor once; here chunks exist only to bound device
memory, and a Python loop writes each chunk's results into preallocated
outputs.
"""

from __future__ import annotations

import torch

from ..ops import nma_core, rigid
from ..ops.assembly import hessian_xyz_plain, kirchhoff_plain
from ..ops.assembly_kernels import (hessian_planes_ensemble,
                                    hessian_xyz_ensemble,
                                    kirchhoff_ensemble)
from ..ops.ffparams import FFParams
from ..utils.config import as_tensor

__all__ = [
    "anm_fluctuations",
    "gnm_fluctuations",
    "ensemble_anm_fluctuations",
    "ensemble_gnm_fluctuations",
]

_ENGINES = ("blocked", "cho_solve")


def _mass_weight(matrix, masses, xyz=False):
    """``W M W`` with ``W = diag(1 / sqrt(masses))``; `xyz` tiles the
    weights over the three component blocks of an xyz-layout Hessian
    (``pipeline.py:199-204``)."""
    if masses is None:
        return matrix
    w = 1.0 / torch.sqrt(masses)
    if xyz:
        w = w.repeat(3)
    return matrix * (w[:, None] * w[None, :])


def _assemble_by_dtype(kernel, plain, coords, params):
    """`kernel` (its wrapper launches on CUDA, or runs its plain version
    on the CPU) for float32 coordinates; `plain` for any other dtype."""
    fn = kernel if coords.dtype == torch.float32 else plain
    return fn(coords, params)


def _build_hessians_batched(coords, params, masses):
    """Dense xyz-layout Hessians ``(B, 3n, 3n)``, mass-weighted."""
    hessians = _assemble_by_dtype(hessian_xyz_ensemble, hessian_xyz_plain,
                                  coords, params)
    return _mass_weight(hessians, masses, xyz=True)


def _build_kirchhoffs_batched(coords, params, masses):
    """Kirchhoff matrices ``(B, n, n)``, mass-weighted."""
    kirchhoffs = _assemble_by_dtype(kirchhoff_ensemble, kirchhoff_plain,
                                    coords, params)
    return _mass_weight(kirchhoffs, masses)


def _anm_trace_observables(traces, with_dcc):
    """Observables of a batch of plane-trace matrices ``(B, n, n)``."""
    msf = torch.diagonal(traces, dim1=-2, dim2=-1)
    out = {"msf": msf, "bfactor": nma_core.bfactor_from_msf(msf)}
    if with_dcc:
        out["dcc"] = nma_core.normalize_dcc(traces)
    return out


def _anm_cov_observables(cov, n, with_dcc, with_prs):
    """Observables of xyz-layout ANM covariances ``(B, 3n, 3n)``; the
    plane traces sum the diagonal component blocks."""
    planes = cov.reshape(cov.shape[:-2] + (3, n, 3, n))
    traces = sum(planes[..., a, :, a, :] for a in range(3))
    out = {"covariance": cov, **_anm_trace_observables(traces, with_dcc)}
    if with_prs:
        prs = nma_core.prs_matrix(cov, layout="xyz")
        out["prs"] = prs
        out["effector"], out["sensor"] = \
            nma_core.effector_sensor_profiles(prs)
    return out


def _gnm_cov_observables(cov, with_dcc):
    """Observables of GNM covariances ``(B, n, n)``, which play the part
    of the ANM plane traces."""
    return {"covariance": cov, **_anm_trace_observables(cov, with_dcc)}


def _anm_chunk(coords, params, masses, inverse, with_covariance,
               with_dcc, with_prs):
    n = coords.shape[1]
    bases = rigid.rigid_modes_anm(coords, masses=masses)
    if inverse == "blocked":
        planes = hessian_planes_ensemble(coords, params)
        if not with_covariance:
            return _anm_trace_observables(
                rigid.covariance_plane_traces_from_planes(
                    planes, n, bases, masses=masses), with_dcc)
        cov = rigid.covariance_cholesky_from_planes(planes, n, bases,
                                                    masses=masses)
    else:
        hessians = _build_hessians_batched(coords, params, masses)
        if not with_covariance:
            return _anm_trace_observables(
                rigid.covariance_plane_traces(hessians, bases), with_dcc)
        cov = rigid.covariance_cholesky(hessians, bases)
    return _anm_cov_observables(cov, n, with_dcc, with_prs)


def _gnm_chunk(coords, params, masses, inverse, with_dcc):
    kirchhoffs = _build_kirchhoffs_batched(coords, params, masses)
    basis = rigid.null_mode_gnm(coords.shape[1], masses=masses,
                                dtype=coords.dtype, device=coords.device)
    cov = rigid.covariance_cholesky(kirchhoffs, basis, inverse=inverse)
    return _gnm_cov_observables(cov, with_dcc)


def _check_engine(inverse):
    if inverse not in _ENGINES:
        raise ValueError(f"inverse must be one of {_ENGINES}, got "
                         f"{inverse!r}")


def _check_prs(with_covariance, with_prs):
    if with_prs and not with_covariance:
        raise ValueError(
            "with_prs=True requires with_covariance=True — PRS consumes "
            "all nine covariance plane blocks, not just the traces")


def _prepare(coords, params, masses, dtype, device, ndim):
    """Coordinates (``(B, n, 3)`` for ``ndim=3``, ``(n, 3)`` for 2) and
    masses as contiguous tensors of `dtype` on one device."""
    if not isinstance(params, FFParams):
        raise TypeError("params must be springcraft_tpu_torch FFParams "
                        "(see ops.ffparams.from_numpy_params)")
    coords = as_tensor(coords, dtype, device).contiguous()
    if coords.ndim != ndim or coords.shape[-1] != 3:
        shape = "(B, n, 3)" if ndim == 3 else "(n, 3)"
        raise ValueError(f"coords must be {shape}, got "
                         f"{tuple(coords.shape)}")
    if masses is not None:
        masses = as_tensor(masses, dtype, coords.device)
    return coords, masses


def _run_chunked(run, coords, chunk):
    """``run`` over chunks of `chunk` conformers, its outputs written
    into tensors preallocated from the first chunk's."""
    batch = coords.shape[0]
    if chunk is None or batch <= chunk:
        return run(coords)
    if batch % chunk:
        raise ValueError(f"ensemble of {batch} conformers must divide "
                         f"into chunks of {chunk}")
    out = None
    for start in range(0, batch, chunk):
        part = run(coords[start:start + chunk])
        if out is None:
            out = {key: value.new_empty((batch,) + value.shape[1:])
                   for key, value in part.items()}
        for key, value in part.items():
            out[key][start:start + chunk] = value
    return out


def ensemble_anm_fluctuations(coords, params, masses=None, *, inverse,
                              with_covariance=False, with_dcc=True,
                              dtype=torch.float32, chunk=None,
                              device=None, with_prs=False, prep="planes"):
    """Fast-covariance ANM fluctuation observables of a conformer
    ensemble.

    Parameters
    ----------
    coords : Tensor or ndarray, shape=(B, n, 3)
        Conformers of one protein.  A tensor keeps its device; anything
        else needs `device`.
    params : FFParams
        Analytic force field (see :func:`.ops.ffparams.from_numpy_params`
        to carry one across from the JAX package).
    masses : Tensor or ndarray, shape=(n,), optional
        Mass-weights the Hessian (``W H W``, ``W = diag(1/sqrt(m))``).
    inverse : {"blocked", "cho_solve"}
        ``"blocked"``: the main path through the port's kernels
        (float32 on CUDA).  ``"cho_solve"``: dense assembly, Cholesky
        and a solve against the identity in any dtype — the float64
        reference.
    with_covariance : bool
        Also return the ``(B, 3n, 3n)`` covariance (xyz layout).  The
        default ``False`` computes only the ``(B, n, n)`` plane traces,
        the cheaper main path (the JAX package defaults to ``True``).
    with_dcc : bool
        Also return the normalized DCC ``(B, n, n)``.
    dtype : torch.dtype
    chunk : int, optional
        Conformers per pass; ``B`` must divide into chunks.  Bounds
        device memory only.
    device : str or torch.device, optional
        Required for a non-tensor `coords`.
    with_prs : bool
        Also return the PRS matrix ``prs`` ``(B, n, n)`` and its
        ``effector`` and ``sensor`` profiles ``(B, n)``; needs
        `with_covariance`.
    prep : {"planes"}
        ``"direct"`` needs kernel K7, which is not ported yet.

    Returns
    -------
    dict with ``msf`` ``(B, n)``, ``bfactor`` ``(B, n)`` and, as asked
    for, ``dcc``, ``covariance``, ``prs``, ``effector`` and ``sensor``.
    A disconnected network gives non-finite values by design.
    """
    if prep != "planes":
        raise NotImplementedError(
            f"prep={prep!r} needs the assembly-fused stitch kernel K7, "
            f"which is not ported yet (ROADMAP.md, kernel table)")
    _check_engine(inverse)
    _check_prs(with_covariance, with_prs)
    coords, masses = _prepare(coords, params, masses, dtype, device, 3)
    return _run_chunked(
        lambda c: _anm_chunk(c, params, masses, inverse, with_covariance,
                             with_dcc, with_prs), coords, chunk)


def ensemble_gnm_fluctuations(coords, params, masses=None, *, inverse,
                              with_dcc=True, dtype=torch.float32,
                              chunk=None, device=None):
    """GNM twin of :func:`ensemble_anm_fluctuations`: covariance
    ``(B, n, n)``, ``msf``, ``bfactor`` and, with `with_dcc`, ``dcc``
    of each conformer's Kirchhoff matrix, whose null space is the
    (mass-scaled) constant mode.  ``inverse="blocked"`` runs the kernels
    (float32 on CUDA); ``"cho_solve"`` runs in any dtype."""
    _check_engine(inverse)
    coords, masses = _prepare(coords, params, masses, dtype, device, 3)
    return _run_chunked(
        lambda c: _gnm_chunk(c, params, masses, inverse, with_dcc), coords,
        chunk)


def anm_fluctuations(coord, params, masses=None, *, with_dcc=True,
                     with_prs=False, with_covariance=True,
                     dtype=torch.float32, device=None):
    """Covariance-derived ANM observables of one structure ``(n, 3)``
    through a regularized Cholesky solve, no eigendecomposition: the
    keys of :func:`ensemble_anm_fluctuations` without the batch axis.
    With ``with_covariance=False`` only the plane traces are formed (no
    ``covariance``, and no PRS).  A float32 structure on CUDA is
    assembled by the Hessian kernel."""
    _check_prs(with_covariance, with_prs)
    coord, masses = _prepare(coord, params, masses, dtype, device, 2)
    out = _anm_chunk(coord[None], params, masses, "cho_solve",
                     with_covariance, with_dcc, with_prs)
    return {key: value[0] for key, value in out.items()}


def gnm_fluctuations(coord, params, masses=None, *, with_dcc=True,
                     dtype=torch.float32, device=None):
    """GNM twin of :func:`anm_fluctuations`: covariance ``(n, n)``,
    ``msf``, ``bfactor`` and ``dcc`` of one structure."""
    coord, masses = _prepare(coord, params, masses, dtype, device, 2)
    out = _gnm_chunk(coord[None], params, masses, "cho_solve", with_dcc)
    return {key: value[0] for key, value in out.items()}
