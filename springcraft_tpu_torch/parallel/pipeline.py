"""
Batched fluctuation NMA over a conformer ensemble.

Counterpart of ``springcraft_tpu/parallel/pipeline.py:645-652, 704-783,
854-931, 951-983``: :func:`ensemble_anm_fluctuations` goes from
coordinates to MSF, B-factors and normalized DCC per conformer without
an eigendecomposition.

The blocked engine (the main path) runs per chunk of conformers:

1. rigid-body bases (``torch.linalg.qr``);
2. raw Hessian planes — kernel ``hessian_planes.cu``;
3. regularized, equilibrated, identity-padded factor input — kernel
   ``regularize_stitch.cu``;
4. divide-and-conquer inverse factor — ``torch.matmul`` nodes, kernel
   ``panel_inverse.cu`` at the 64-wide leaves;
5. blockwise plane-trace Grams (``torch.matmul``);
6. observables.

The JAX package maps chunks inside one device program to pay a relay's
per-call dispatch floor once; here chunks exist only to bound device
memory, and a Python loop writes each chunk's results into preallocated
outputs.
"""

from __future__ import annotations

import torch

from ..ops import nma_core, rigid
from ..ops.assembly import hessian_xyz_plain
from ..ops.assembly_kernels import hessian_planes_ensemble
from ..ops.ffparams import FFParams
from ..utils.config import as_tensor

__all__ = ["ensemble_anm_fluctuations", "ensemble_gnm_fluctuations"]

_ENGINES = ("blocked", "cho_solve")


def _anm_trace_observables(traces, with_dcc):
    """Observables of a batch of plane-trace matrices ``(B, n, n)``."""
    msf = torch.diagonal(traces, dim1=-2, dim2=-1)
    out = {"msf": msf, "bfactor": nma_core.bfactor_from_msf(msf)}
    if with_dcc:
        out["dcc"] = nma_core.normalize_dcc(traces)
    return out


def _blocked_chunk(coords, params, masses, with_dcc):
    n = coords.shape[1]
    bases = rigid.rigid_modes_anm(coords, masses=masses)
    planes = hessian_planes_ensemble(coords, params)
    traces = rigid.covariance_plane_traces_from_planes(
        planes, n, bases, masses=masses)
    return _anm_trace_observables(traces, with_dcc)


def _cho_solve_chunk(coords, params, masses, with_dcc):
    # Plain dense assembly in the working dtype: this engine is the
    # float64 reference, and the assembly kernel is float32-only.
    hessians = hessian_xyz_plain(coords, params)
    if masses is not None:
        w3 = (1.0 / torch.sqrt(masses)).repeat(3)
        hessians = hessians * (w3[:, None] * w3[None, :])
    bases = rigid.rigid_modes_anm(coords, masses=masses)
    traces = rigid.covariance_plane_traces(hessians, bases,
                                           inverse="cho_solve")
    return _anm_trace_observables(traces, with_dcc)


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
        and a triangular solve in any dtype — the float64 reference.
    with_covariance : bool
        Only ``False`` is ported: the pipeline computes the ``(n, n)``
        plane traces and never the ``(3n, 3n)`` covariance.
    with_dcc : bool
        Also return the normalized DCC ``(B, n, n)``.
    dtype : torch.dtype
    chunk : int, optional
        Conformers per pass; ``B`` must divide into chunks.  Bounds
        device memory only.
    device : str or torch.device, optional
        Required for a non-tensor `coords`.
    with_prs, prep
        Only the defaults are ported.

    Returns
    -------
    dict with ``msf`` ``(B, n)``, ``bfactor`` ``(B, n)`` and, with
    `with_dcc`, ``dcc`` ``(B, n, n)``.  A disconnected network gives
    non-finite values by design.
    """
    if with_covariance:
        raise NotImplementedError(
            "with_covariance=True is not ported yet (ROADMAP.md, next "
            "slices: GNM ensemble and with_covariance via _gram_lower)")
    if with_prs:
        raise NotImplementedError(
            "with_prs needs with_covariance=True, which is not ported yet "
            "(ROADMAP.md, next slices: with_covariance via _gram_lower)")
    if prep != "planes":
        raise NotImplementedError(
            f"prep={prep!r} needs the assembly-fused stitch kernel K7, "
            f"which is not ported yet (ROADMAP.md, kernel table)")
    if inverse not in _ENGINES:
        raise ValueError(f"inverse must be one of {_ENGINES}, got "
                         f"{inverse!r}")
    if not isinstance(params, FFParams):
        raise TypeError("params must be springcraft_tpu_torch FFParams "
                        "(see ops.ffparams.from_numpy_params)")
    coords = as_tensor(coords, dtype, device).contiguous()
    if coords.ndim != 3 or coords.shape[-1] != 3:
        raise ValueError(f"coords must be (B, n, 3), got "
                         f"{tuple(coords.shape)}")
    if masses is not None:
        masses = as_tensor(masses, dtype, coords.device)
    run = _blocked_chunk if inverse == "blocked" else _cho_solve_chunk

    batch, n, _ = coords.shape
    if chunk is None or batch <= chunk:
        return run(coords, params, masses, with_dcc)
    if batch % chunk:
        raise ValueError(f"ensemble of {batch} conformers must divide "
                         f"into chunks of {chunk}")
    out = {"msf": coords.new_empty((batch, n)),
           "bfactor": coords.new_empty((batch, n))}
    if with_dcc:
        out["dcc"] = coords.new_empty((batch, n, n))
    for start in range(0, batch, chunk):
        part = run(coords[start:start + chunk], params, masses, with_dcc)
        for key, value in part.items():
            out[key][start:start + chunk] = value
    return out


def ensemble_gnm_fluctuations(coords, params, masses=None, **options):
    """GNM twin of :func:`ensemble_anm_fluctuations`; not ported yet."""
    raise NotImplementedError(
        "ensemble_gnm_fluctuations needs the batched Kirchhoff kernel K4, "
        "which is not ported yet (ROADMAP.md, next slices: GNM ensemble)")
