"""
NMA pipelines from coordinates to observables.

Counterpart of ``springcraft_tpu/parallel/pipeline.py``.

**Fluctuations without an eigendecomposition** (``:40-46, 199-265,
605-701, 704-748, 797-847, 854-931``):

* :func:`ensemble_anm_fluctuations` and :func:`ensemble_gnm_fluctuations`
  go over a conformer ensemble with the ``"blocked"`` engine (the main
  path) or the ``"cho_solve"`` engine;
* :func:`anm_fluctuations` and :func:`gnm_fluctuations` solve one
  structure with the Cholesky engine.

The ANM blocked engine runs per chunk of conformers:

1. rigid-body bases (``torch.linalg.qr``);
2. raw Hessian planes — kernel ``hessian_planes.cu``;
3. regularized, equilibrated, identity-padded factor input — kernel
   ``regularize_stitch.cu`` (with ``prep="direct"`` steps 2 and 3 are
   one kernel, ``assembly_stitch.cu``, for the analytic families);
4. divide-and-conquer inverse factor — ``torch.matmul`` nodes, kernel
   ``panel_inverse.cu`` at the 64-wide leaves;
5. blockwise plane-trace Grams or, with ``with_covariance``, the Gram of
   the whole column-scaled factor (``torch.matmul``);
6. observables.

With a ``torch.profiler`` running, each of these stages lies in a
``springcraft::`` span (:func:`..utils.profiling.span`: ``rigid_bases``,
``assembly``, ``prep``, ``inverse_factor``, ``grams``, ``observables``),
each chunk in ``springcraft::chunk`` and each call of the two ensemble
fluctuation entry points in a span of its own name.

The GNM blocked engine assembles Kirchhoff matrices (kernel
``kirchhoff.cu``), regularizes them with the shared constant null mode in
plain PyTorch (the JAX package has no stitch kernel for GNM) and runs
steps 4 to 6.  The ``cho_solve`` engines and the single-structure entry
points assemble dense matrices with the kernels in float32
(``hessian_planes.cu``'s xyz-layout store, ``kirchhoff.cu``) and with
their plain versions in any other dtype — the JAX package's rule
(``_resolve_use_pallas``: the kernels are float32-only) — then factor
with ``torch.linalg``.  The single-structure entry points factor and
solve in float64 whatever the working dtype (a float32 matrix is cast
up and the covariance cast back): float32 ``cholesky_ex`` alone cost
1.7e-4 of a 1776-residue structure's MSF.  Every entry point takes an
``FFParams`` or a force-field object (:mod:`..models.forcefield`), which
is lowered to its
compact parameters where it has them (``:985-1000``); the tabulated
``table_compact`` family runs through the same kernels, the
position-specific ``table_pair`` through the plain assembly in every
dtype (as the JAX package leaves it to XLA).  Patch overlays
(``PatchedForceField``, or overlay parameters) ride on every path: the
kernels assemble the base family and a sparse correction follows, before
any mass weighting; the planes form and ``prep="direct"`` do not apply,
so the blocked engine then takes dense Hessians (``:942, 957-960``).
``inverse="auto"`` takes
``"blocked"`` for float32 on CUDA and ``"cho_solve"`` otherwise
(``:785-794``, the TPU read as CUDA).  Every entry point takes the JAX
package's ``use_pallas=`` (default ``"auto"``, ``:49-61``): ``"auto"``,
``None`` and ``True`` run as above; ``False`` (the plain versions) is
taken on the CPU and refused on CUDA
(:func:`..utils.config.check_use_pallas`).

**Spectral pipelines** (``:74-196, 268-598, 1003-1032``), over dense
Hessians or Kirchhoff matrices from the same assembly:

* :func:`ensemble_anm_spectral`, :func:`ensemble_gnm_spectral`,
  :func:`anm_spectral`, :func:`gnm_spectral` — all eigenvalues by the
  two-stage banded solver (band reduction, bisection kernel
  ``banded_bisect.cu``), the covariance observables from the Cholesky
  covariance, and optionally the lowest mode shapes by subspace iteration
  on that covariance;
* :func:`ensemble_anm_banded`, :func:`ensemble_gnm_banded` — the full
  eigensystem from the two-stage solver (plus the inverse-iteration kernel
  ``banded_eigvec.cu``), then the mode observables;
* :func:`anm_observables`, :func:`gnm_observables`, :func:`ensemble_anm`,
  :func:`ensemble_gnm` — the same observables from ``torch.linalg.eigh``:
  the dense baseline, and in float64 the reference.

The JAX package maps chunks inside one device program to pay a relay's
per-call dispatch floor once; here chunks exist only to bound device
memory, and a Python loop writes each chunk's results into preallocated
outputs.  On CUDA in float32 the blocked engines of the two ensemble
fluctuation entry points run that loop on a CUDA graph
(:func:`_run_graphed`): a chunk issues about 2,000 launches of a few
microseconds each, more than eager PyTorch issues in the time the card
runs them, and every chunk of a call runs the same launches on buffers of
the same shapes without a host readback.  In a call of more than one
chunk, the first chunk of a configuration runs eagerly, the second is
captured on its device and every later one copies its conformers into
the graph's inputs and replays it, each replay in a
``springcraft::graph_replay`` span; the outputs are bit for bit the
eager loop's.  The gain needs the configuration to repeat from chunk to
chunk and from call to call: one that changes every call captures every
call.  The routes beside the main one (patch overlays,
``prep="direct"``, ``table_pair``'s plain assembly), a GNM whose
Kirchhoff matrices the factor pads, and the other entry points keep the
eager loop.
"""

from __future__ import annotations

import threading

import torch

from ..ops import modes, nma_core, rigid, spd_linalg, spectrum
from ..ops.assembly import hessian_xyz_plain, kirchhoff_plain
from ..ops.assembly_kernels import (hessian_planes_ensemble,
                                    hessian_xyz_ensemble,
                                    kirchhoff_ensemble)
from ..ops.ffparams import KERNEL_KINDS, FFParams
from ..utils.config import as_tensor, check_use_pallas
from ..utils.profiling import span

__all__ = [
    "anm_fluctuations",
    "gnm_fluctuations",
    "ensemble_anm_fluctuations",
    "ensemble_gnm_fluctuations",
    "anm_observables",
    "gnm_observables",
    "ensemble_anm",
    "ensemble_gnm",
    "anm_spectral",
    "gnm_spectral",
    "ensemble_anm_spectral",
    "ensemble_gnm_spectral",
    "ensemble_anm_banded",
    "ensemble_gnm_banded",
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
    on the CPU) for float32 coordinates of a family the kernels take;
    `plain` for any other dtype and for ``table_pair``."""
    fn = kernel if coords.dtype == torch.float32 \
        and params.kind in KERNEL_KINDS else plain
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


def _kernel_assembled(params):
    """Whether the assembly kernels build the whole matrix of `params`:
    a family they take and no patch overlay, whose sparse correction
    runs on the host between launches."""
    return params.kind in KERNEL_KINDS and not params.overlays


def _gnm_graphable(params, n):
    """Whether a blocked GNM chunk can be captured: its family
    kernel-assembled and its Kirchhoff matrices the factor's padded size
    (``_regularize_equilibrated`` writes a padded diagonal through a host
    scalar, which a capture refuses)."""
    return _kernel_assembled(params) and spd_linalg.padded_size(n) == n


def _anm_route(params, inverse, prep, n):
    """The route of :func:`_anm_chunk`: ``"direct"`` (the
    assembly-fused prep), ``"planes"`` (the raw planes kernel, then the
    stitch) or ``"dense"`` (dense Hessians: ``cho_solve``, or the
    blocked engine on what the planes kernel does not take)."""
    if inverse != "blocked":
        return "dense"
    if prep == "direct" and rigid.direct_prep_applies(params, n):
        return "direct"
    return "planes" if _kernel_assembled(params) else "dense"


def _anm_chunk(coords, params, masses, inverse, with_covariance,
               with_dcc, with_prs, prep="planes", factor_dtype=None):
    """One chunk of the ANM fluctuation pipeline, each stage in its
    :func:`span`; the covariance functions of :mod:`..ops.rigid` name
    their prep, inverse factor and Grams themselves."""
    n = coords.shape[1]
    with span("rigid_bases"):
        bases = rigid.rigid_modes_anm(coords, masses=masses)
    route = _anm_route(params, inverse, prep, n)
    if route == "direct":
        # assembly-fused prep (opt-in): coordinates to factor input in
        # one kernel, the planes never reach device memory
        if not with_covariance:
            traces = rigid.covariance_plane_traces_direct(
                coords, params, bases, masses=masses)
        else:
            cov = rigid.covariance_cholesky_direct(coords, params, bases,
                                                   masses=masses)
    elif route == "planes":
        with span("assembly"):
            planes = hessian_planes_ensemble(coords, params)
        if not with_covariance:
            traces = rigid.covariance_plane_traces_from_planes(
                planes, n, bases, masses=masses)
        else:
            cov = rigid.covariance_cholesky_from_planes(planes, n, bases,
                                                        masses=masses)
    else:
        # cho_solve, or the blocked engine on dense Hessians for what
        # the planes kernel does not take (table_pair, patch overlays)
        with span("assembly"):
            hessians = _build_hessians_batched(coords, params, masses)
        if not with_covariance:
            traces = rigid.covariance_plane_traces(
                hessians, bases, inverse=inverse, factor_dtype=factor_dtype)
        else:
            cov = rigid.covariance_cholesky(hessians, bases, inverse=inverse,
                                            factor_dtype=factor_dtype)
    with span("observables"):
        if not with_covariance:
            return _anm_trace_observables(traces, with_dcc)
        return _anm_cov_observables(cov, n, with_dcc, with_prs)


def _gnm_chunk(coords, params, masses, inverse, with_dcc,
               factor_dtype=None):
    """One chunk of the GNM fluctuation pipeline, each stage in its
    :func:`span`."""
    with span("assembly"):
        kirchhoffs = _build_kirchhoffs_batched(coords, params, masses)
    with span("rigid_bases"):
        basis = rigid.null_mode_gnm(coords.shape[1], masses=masses,
                                    dtype=coords.dtype, device=coords.device)
    cov = rigid.covariance_cholesky(kirchhoffs, basis, inverse=inverse,
                                    factor_dtype=factor_dtype)
    with span("observables"):
        return _gnm_cov_observables(cov, with_dcc)


def _resolve_inverse(inverse, coords):
    """The covariance engine: ``"auto"`` is ``"blocked"`` for float32 on
    CUDA (the kernels' dtype and device) and ``"cho_solve"`` otherwise,
    decided from the prepared coordinates before any work."""
    if inverse == "auto":
        return ("blocked" if coords.dtype == torch.float32
                and coords.device.type == "cuda" else "cho_solve")
    if inverse not in _ENGINES:
        raise ValueError(f"inverse must be 'auto' or one of {_ENGINES}, "
                         f"got {inverse!r}")
    return inverse


def _check_prs(with_covariance, with_prs):
    if with_prs and not with_covariance:
        raise ValueError(
            "with_prs=True requires with_covariance=True — PRS consumes "
            "all nine covariance plane blocks, not just the traces")


def _resolve_params(params, natoms=None):
    """An :class:`FFParams`, given as such or as a force-field object,
    which is lowered to its compact parameters where it has them and to
    its ``to_params()`` otherwise (``pipeline.py:985-1000``); `natoms`
    sizes the overlay of a ``PatchedForceField`` around a field without
    an atom count of its own."""
    if isinstance(params, FFParams):
        return params
    to_compact = getattr(params, "to_compact_params", None)
    if to_compact is not None:
        return to_compact()
    to_params = getattr(params, "to_params", None)
    if to_params is not None and not hasattr(params, "kind"):
        lowered = to_params(natoms=natoms)
        if lowered is None:
            raise ValueError("This force field has no device "
                             "parameterization")
        return lowered
    raise TypeError("params must be springcraft_tpu_torch FFParams (see "
                    "ops.ffparams.from_numpy_params) or a force field of "
                    "springcraft_tpu_torch.models")


def _prepare(coords, params, masses, dtype, device, ndim):
    """Coordinates (``(B, n, 3)`` for ``ndim=3``, ``(n, 3)`` for 2) and
    masses as contiguous tensors of `dtype` on one device, and the
    lowered :class:`FFParams`."""
    coords = as_tensor(coords, dtype, device).contiguous()
    if coords.ndim != ndim or coords.shape[-1] != 3:
        shape = "(B, n, 3)" if ndim == 3 else "(n, 3)"
        raise ValueError(f"coords must be {shape}, got "
                         f"{tuple(coords.shape)}")
    params = _resolve_params(params, coords.shape[-2])
    if masses is not None:
        masses = as_tensor(masses, dtype, coords.device)
    return coords, params, masses


def _run_chunked(run, coords, chunk):
    """``run`` over chunks of `chunk` conformers, each in a ``chunk``
    :func:`span`, its outputs written into tensors preallocated from the
    first chunk's."""
    batch = coords.shape[0]
    if chunk is None or batch <= chunk:
        with span("chunk"):
            return run(coords)
    if batch % chunk:
        raise ValueError(f"ensemble of {batch} conformers must divide "
                         f"into chunks of {chunk}")
    out = None
    for start in range(0, batch, chunk):
        with span("chunk"):
            part = run(coords[start:start + chunk])
        if out is None:
            out = {key: value.new_empty((batch,) + value.shape[1:])
                   for key, value in part.items()}
        for key, value in part.items():
            out[key][start:start + chunk] = value
    return out


class _ChunkGraph:
    """The chunk of one entry point on one device as a CUDA graph: the
    configuration it was captured for (`key`, and `refs`, what the key
    names by identity, kept alive), its static inputs and outputs, and
    the kernel launch counts of one chunk, recorded while capturing."""

    def __init__(self, key, refs):
        self.key, self.refs = key, refs
        self.graph = self.coords = self.masses = self.out = None
        self.launches = {}


#: The chunk graph of each graphed entry point on each device,
#: ``{(entry, device index): graph}``: a new configuration frees the
#: slot's old graph and its memory pool first.
_CHUNK_GRAPHS = {}
#: A lock a slot of ``_CHUNK_GRAPHS``, held through a graphed call: the
#: slot's static tensors are shared by every caller in the process.
_GRAPH_LOCKS = {}


def _launch_counters():
    """``{(wrapper, counter): count}`` of every kernel wrapper's launch
    counters (``.launches``, ``.table_launches``, ...), by name."""
    from .. import kernel_wrappers

    return {(name, counter): count
            for name, wrapper in kernel_wrappers().items()
            for counter, count in vars(wrapper).items()
            if counter.endswith("launches")}


def _graph_key(entry, shape, dtype, device, stream, params, with_masses,
               options):
    """Everything a captured chunk bakes in: the entry point, the chunk's
    shape, dtype, device and stream (a call on another stream must not
    share the static tensors of one still running), the family's scalars
    and (``table_compact``) the identity of its device tables, whether
    masses weigh the Hessian, the entry point's `options`, and the
    float32 matmul precision and linear-algebra library in force.
    Returns ``(key, refs)``, `refs` what the key names by identity."""
    refs = ()
    if params.kind == "table_compact":
        refs = (params.device_tables(device, torch.float32),)
    key = (entry, tuple(shape), dtype, device.type, device.index, stream,
           params._scalars(), len(params.overlays),
           tuple(map(id, refs)), with_masses, options,
           torch.backends.cuda.matmul.allow_tf32,
           torch.get_float32_matmul_precision(),
           torch.backends.cuda.preferred_linalg_library())
    return key, refs


def _graphs_apply(coords, inverse, chunk):
    """Whether an ensemble fluctuation call runs its chunks on a CUDA
    graph: the blocked engine on CUDA in float32, over more than one
    chunk (a single chunk would only hold the graph's memory)."""
    return (inverse == "blocked" and coords.device.type == "cuda"
            and coords.dtype == torch.float32 and chunk is not None
            and coords.shape[0] > chunk)


def _capture(graph, run, coords, masses):
    """Capture ``run`` on static copies of `coords` and `masses` into
    `graph` (a :class:`_ChunkGraph`) on a stream of their own device,
    and replay it once."""
    graph.coords = coords.clone()
    graph.masses = None if masses is None else masses.clone()
    before = _launch_counters()
    cuda_graph = torch.cuda.CUDAGraph()
    # thread_local: CUDA calls of other threads do not void the capture
    with torch.cuda.graph(cuda_graph, stream=torch.cuda.Stream(coords.device),
                          capture_error_mode="thread_local"):
        graph.out = run(graph.coords, graph.masses)
    graph.launches = {counter: count - before[counter]
                      for counter, count in _launch_counters().items()
                      if count != before[counter]}
    cuda_graph.replay()
    graph.graph = cuda_graph
    _run_graphed.captures += 1
    return graph.out


def _replay(graph, coords):
    """Copy `coords` into `graph`'s static input and replay it.  The
    kernel wrappers count no launch: ``_run_graphed.replayed_launches``
    adds the counts recorded at capture."""
    graph.coords.copy_(coords)
    with span("graph_replay"):
        graph.graph.replay()
    replayed = _run_graphed.replayed_launches
    for counter, count in graph.launches.items():
        replayed[counter] = replayed.get(counter, 0) + count
    _run_graphed.replays += 1
    return graph.out


def _run_graphed(run, coords, masses, chunk, entry, params, options):
    """:func:`_run_chunked` on a CUDA graph, ``run(coords, masses)`` a
    chunk, for a call of more than one chunk.  The first chunk of a
    configuration (:func:`_graph_key`) runs eagerly, which loads every
    kernel and library it launches; the next is captured
    (``_run_graphed.captures``) and every later one replays the graph
    (``_run_graphed.replays``, each in a ``graph_replay`` :func:`span`).
    One graph an entry point and device (``_CHUNK_GRAPHS``)."""
    device = coords.device
    slot = (entry, device.index)
    with torch.cuda.device(device):
        key, refs = _graph_key(
            entry, (chunk,) + coords.shape[1:], coords.dtype, device,
            torch.cuda.current_stream(device).cuda_stream, params,
            masses is not None, options)

        def step(part_coords):
            graph = _CHUNK_GRAPHS.get(slot)
            if graph is None:
                part = run(part_coords, masses)
                _CHUNK_GRAPHS[slot] = _ChunkGraph(key, refs)
                return part
            if graph.graph is None:
                try:
                    return _capture(graph, run, part_coords, masses)
                except BaseException:
                    del _CHUNK_GRAPHS[slot]
                    raise
            return _replay(graph, part_coords)

        with _GRAPH_LOCKS.setdefault(slot, threading.Lock()):
            graph = _CHUNK_GRAPHS.get(slot)
            if graph is not None and graph.key != key:
                del _CHUNK_GRAPHS[slot]
            elif graph is not None and graph.masses is not None:
                graph.masses.copy_(masses)
            return _run_chunked(step, coords, chunk)


_run_graphed.captures = 0
_run_graphed.replays = 0
#: ``{(wrapper, counter): count}``: the kernel launches that replays ran,
#: as recorded at capture; the wrappers' own counters leave them out.
_run_graphed.replayed_launches = {}


def _single(run, coord):
    """``run`` on one structure ``(n, 3)`` as a batch of one, without the
    batch axis in its outputs."""
    return {key: value[0] for key, value in run(coord[None]).items()}


def ensemble_anm_fluctuations(coords, params, masses=None, *,
                              inverse="auto", with_covariance=True,
                              with_dcc=True, dtype=torch.float32,
                              chunk=None, device=None,
                              use_pallas="auto", with_prs=False,
                              prep="planes"):
    """Fast-covariance ANM fluctuation observables of a conformer
    ensemble.

    Parameters
    ----------
    coords : Tensor or ndarray, shape=(B, n, 3)
        Conformers of one protein.  A tensor keeps its device; anything
        else goes to `device`.
    params : FFParams or force field
        An analytic or tabulated family (see
        :func:`.ops.ffparams.from_numpy_params` to carry one across
        from the JAX package), or a force-field object of
        :mod:`..models.forcefield`, lowered to its compact parameters.
    masses : Tensor or ndarray, shape=(n,), optional
        Mass-weights the Hessian (``W H W``, ``W = diag(1/sqrt(m))``).
    inverse : {"auto", "blocked", "cho_solve"}
        ``"blocked"``: the main path through the port's kernels
        (float32 on CUDA).  ``"cho_solve"``: dense assembly, Cholesky
        and a solve against the identity in any dtype — the float64
        reference.  ``"auto"``: ``"blocked"`` for float32 on CUDA, else
        ``"cho_solve"``.
    with_covariance : bool
        Also return the ``(B, 3n, 3n)`` covariance (xyz layout), as the
        JAX package does by default.  ``False`` computes only the
        ``(B, n, n)`` plane traces, the cheaper main path.
    with_dcc : bool
        Also return the normalized DCC ``(B, n, n)``.
    dtype : torch.dtype
    chunk : int, optional
        Conformers per pass; ``B`` must divide into chunks.  Bounds
        device memory only.
    device : str or torch.device, optional
        Where a non-tensor `coords` goes; by default the current CUDA
        device (``"cpu"`` to run on the CPU).
    use_pallas : {"auto", None, True, False}
        The JAX package's switch: the kernels on CUDA, their plain
        versions on the CPU; ``False`` raises on CUDA.
    with_prs : bool
        Also return the PRS matrix ``prs`` ``(B, n, n)`` and its
        ``effector`` and ``sensor`` profiles ``(B, n)``; needs
        `with_covariance`.
    prep : {"planes", "direct"}
        Blocked engine only.  ``"planes"`` assembles the raw Hessian
        planes and stitches them into the factor input; ``"direct"``
        recomputes the planes inside the stitch kernel so that they
        never reach device memory (analytic families; a tabulated
        family takes the planes path all the same, as in the JAX
        package).  Equal to float32 summation order.

    Returns
    -------
    dict with ``msf`` ``(B, n)``, ``bfactor`` ``(B, n)`` and, as asked
    for, ``dcc``, ``covariance``, ``prs``, ``effector`` and ``sensor``.
    A disconnected network gives non-finite values by design.
    """
    if prep not in ("planes", "direct"):
        raise ValueError(f"prep must be 'planes' or 'direct', got {prep!r}")
    _check_prs(with_covariance, with_prs)
    with span("ensemble_anm_fluctuations"):
        coords, params, masses = _prepare(coords, params, masses, dtype,
                                          device, 3)
        check_use_pallas(use_pallas, coords.device)
        inverse = _resolve_inverse(inverse, coords)

        def run(c, m):
            return _anm_chunk(c, params, m, inverse, with_covariance,
                              with_dcc, with_prs, prep)

        if _graphs_apply(coords, inverse, chunk) and _anm_route(
                params, inverse, prep, coords.shape[1]) == "planes":
            return _run_graphed(
                run, coords, masses, chunk, "ensemble_anm_fluctuations",
                params, (with_covariance, with_dcc, with_prs, prep, chunk))
        return _run_chunked(lambda c: run(c, masses), coords, chunk)


def ensemble_gnm_fluctuations(coords, params, masses=None, *,
                              inverse="auto", with_dcc=True,
                              dtype=torch.float32, chunk=None, device=None,
                              use_pallas="auto"):
    """GNM twin of :func:`ensemble_anm_fluctuations`: covariance
    ``(B, n, n)``, ``msf``, ``bfactor`` and, with `with_dcc`, ``dcc``
    of each conformer's Kirchhoff matrix, whose null space is the
    (mass-scaled) constant mode.  ``inverse="blocked"`` runs the kernels
    (float32 on CUDA); ``"cho_solve"`` runs in any dtype; ``"auto"``
    picks as :func:`ensemble_anm_fluctuations` does."""
    with span("ensemble_gnm_fluctuations"):
        coords, params, masses = _prepare(coords, params, masses, dtype,
                                          device, 3)
        check_use_pallas(use_pallas, coords.device)
        inverse = _resolve_inverse(inverse, coords)

        def run(c, m):
            return _gnm_chunk(c, params, m, inverse, with_dcc)

        if _graphs_apply(coords, inverse, chunk) \
                and _gnm_graphable(params, coords.shape[1]):
            return _run_graphed(run, coords, masses, chunk,
                                "ensemble_gnm_fluctuations", params,
                                (with_dcc, chunk))
        return _run_chunked(lambda c: run(c, masses), coords, chunk)


def anm_fluctuations(coord, params, masses=None, *, with_dcc=True,
                     with_prs=False, with_covariance=True,
                     dtype=torch.float32, device=None,
                     use_pallas="auto"):
    """Covariance-derived ANM observables of one structure ``(n, 3)``
    through a regularized Cholesky solve, no eigendecomposition: the
    keys of :func:`ensemble_anm_fluctuations` without the batch axis.
    With ``with_covariance=False`` only the plane traces are formed (no
    ``covariance``, and no PRS).  A float32 structure on CUDA is
    assembled by the Hessian kernel; the factorization and the solve run
    in float64 and the result comes back in `dtype`."""
    _check_prs(with_covariance, with_prs)
    coord, params, masses = _prepare(coord, params, masses, dtype, device, 2)
    check_use_pallas(use_pallas, coord.device)
    return _single(lambda c: _anm_chunk(
        c, params, masses, "cho_solve", with_covariance, with_dcc, with_prs,
        factor_dtype=torch.float64), coord)


def gnm_fluctuations(coord, params, masses=None, *, with_dcc=True,
                     dtype=torch.float32, device=None,
                     use_pallas="auto"):
    """GNM twin of :func:`anm_fluctuations`: covariance ``(n, n)``,
    ``msf``, ``bfactor`` and ``dcc`` of one structure."""
    coord, params, masses = _prepare(coord, params, masses, dtype, device, 2)
    check_use_pallas(use_pallas, coord.device)
    return _single(lambda c: _gnm_chunk(c, params, masses, "cho_solve",
                                        with_dcc, torch.float64), coord)


# ---------------------------------------------------------------------------
# Eigensystem observables: dense eigh and the two-stage banded solver
# ---------------------------------------------------------------------------


def _eigensystem_observables(vals, vecs, n_trivial, num_dim, *, with_dcc,
                             with_covariance, n_modes, tem, tem_factors):
    """Observables of eigensystems ``vals`` ``(B, m)``, ``vecs`` ``(B, m,
    m)`` (modes in rows, xyz layout) with `n_trivial` null modes left
    out (``pipeline.py:121-158`` for ANM, ``:289-315`` for GNM)."""
    m = vals.shape[-1]
    if n_modes is not None and not 0 < n_modes <= m - n_trivial:
        raise ValueError(f"n_modes={n_modes} must be in "
                         f"[1, {m - n_trivial}]")
    stop = m if n_modes is None else n_trivial + n_modes
    idx = torch.arange(n_trivial, stop, device=vals.device)
    msf = nma_core.mean_square_fluctuation(
        vals, vecs, idx, num_dim=num_dim, layout="xyz", tem=tem,
        tem_factors=tem_factors)
    out = {
        "eig_values": vals,
        "eig_vectors": vecs,
        "frequencies": nma_core.frequencies_from_eigenvalues(vals,
                                                             n_trivial),
        "msf": msf,
        "bfactor": nma_core.bfactor_from_msf(msf),
    }
    if with_dcc:
        out["dcc"] = nma_core.normalize_dcc(nma_core.dcc_from_modes(
            vals, vecs, idx, num_dim=num_dim, layout="xyz"))
    if with_covariance:
        inv_vals = torch.zeros_like(vals)
        inv_vals[..., idx] = 1.0 / vals[..., idx]
        out["covariance"] = torch.einsum("...ki,...k,...kj->...ij", vecs,
                                         inv_vals, vecs)
    return out


def _dense_eigh(matrices):
    """``torch.linalg.eigh`` with the modes in rows."""
    vals, vecs = torch.linalg.eigh(matrices)
    return vals, vecs.transpose(-1, -2)


def _banded_eigh(bandwidth, n_iter_bisect):
    return lambda matrices: spectrum.eigh_banded(
        matrices, bandwidth=bandwidth, n_iter=n_iter_bisect)


def _anm_eigen_chunk(coords, params, masses, solver, options):
    vals, vecs = solver(_build_hessians_batched(coords, params, masses))
    return _eigensystem_observables(vals, vecs, 6, 3, **options)


def _gnm_eigen_chunk(coords, params, masses, solver, options):
    vals, vecs = solver(_build_kirchhoffs_batched(coords, params, masses))
    return _eigensystem_observables(vals, vecs, 1, 1, with_covariance=False,
                                    **options)


def anm_observables(coord, params, masses=None, *, with_dcc=False,
                    with_covariance=False, n_modes=None,
                    dtype=torch.float32, tem=None,
                    tem_factors=nma_core.K_B, device=None,
                    use_pallas="auto"):
    """
    ANM of one structure ``(n, 3)`` by a dense ``torch.linalg.eigh`` of
    its (mass-weighted) xyz-layout Hessian, the six trivial modes left
    out of the observables.

    Returns
    -------
    dict with ``eig_values`` ``(3n,)``, ``eig_vectors`` ``(3n, 3n)``
    (modes in rows, xyz layout), ``frequencies``, ``msf``, ``bfactor``
    and, as asked for, ``dcc`` and ``covariance``; `n_modes` restricts
    the observables to the lowest non-trivial modes.
    """
    coord, params, masses = _prepare(coord, params, masses, dtype, device, 2)
    check_use_pallas(use_pallas, coord.device)
    options = dict(with_dcc=with_dcc, with_covariance=with_covariance,
                   n_modes=n_modes, tem=tem, tem_factors=tem_factors)
    return _single(lambda c: _anm_eigen_chunk(c, params, masses,
                                              _dense_eigh, options), coord)


def gnm_observables(coord, params, masses=None, *, with_dcc=False,
                    n_modes=None, dtype=torch.float32, tem=None,
                    tem_factors=nma_core.K_B, device=None,
                    use_pallas="auto"):
    """GNM twin of :func:`anm_observables` over the Kirchhoff matrix
    (one trivial mode, no ``covariance``)."""
    coord, params, masses = _prepare(coord, params, masses, dtype, device, 2)
    check_use_pallas(use_pallas, coord.device)
    options = dict(with_dcc=with_dcc, n_modes=n_modes, tem=tem,
                   tem_factors=tem_factors)
    return _single(lambda c: _gnm_eigen_chunk(c, params, masses,
                                              _dense_eigh, options), coord)


def ensemble_anm(coords, params, masses=None, *, with_dcc=False,
                 with_covariance=False, n_modes=None, dtype=torch.float32,
                 tem=None, tem_factors=nma_core.K_B, chunk=None,
                 device=None,
                 use_pallas="auto"):
    """:func:`anm_observables` over a conformer ensemble ``(B, n, 3)``
    (batched ``eigh``); `chunk` and `device` as in
    :func:`ensemble_anm_fluctuations`."""
    coords, params, masses = _prepare(coords, params, masses, dtype, device,
                                      3)
    check_use_pallas(use_pallas, coords.device)
    options = dict(with_dcc=with_dcc, with_covariance=with_covariance,
                   n_modes=n_modes, tem=tem, tem_factors=tem_factors)
    return _run_chunked(lambda c: _anm_eigen_chunk(
        c, params, masses, _dense_eigh, options), coords, chunk)


def ensemble_gnm(coords, params, masses=None, *, with_dcc=False,
                 n_modes=None, dtype=torch.float32, tem=None,
                 tem_factors=nma_core.K_B, chunk=None, device=None,
                 use_pallas="auto"):
    """:func:`gnm_observables` over a conformer ensemble ``(B, n, 3)``."""
    coords, params, masses = _prepare(coords, params, masses, dtype, device,
                                      3)
    check_use_pallas(use_pallas, coords.device)
    options = dict(with_dcc=with_dcc, n_modes=n_modes, tem=tem,
                   tem_factors=tem_factors)
    return _run_chunked(lambda c: _gnm_eigen_chunk(
        c, params, masses, _dense_eigh, options), coords, chunk)


def ensemble_anm_banded(coords, params, masses=None, *, with_dcc=False,
                        with_covariance=False, n_modes=None,
                        dtype=torch.float32, bandwidth=8, n_iter_bisect=40,
                        tem=None, tem_factors=nma_core.K_B, chunk=None,
                        device=None,
                        use_pallas="auto"):
    """
    :func:`ensemble_anm` with the full eigensystem from the two-stage
    banded solver (:func:`.ops.spectrum.eigh_banded`, no dense ``eigh``):
    in float32 with ``bandwidth <= 8`` its bisection and inverse-iteration
    kernels run on CUDA.  Same outputs; float32 accuracy is that of an
    iterative solver, about 1e-5 relative residuals after the built-in
    polish and windowed Rayleigh-Ritz.
    """
    coords, params, masses = _prepare(coords, params, masses, dtype, device,
                                      3)
    check_use_pallas(use_pallas, coords.device)
    options = dict(with_dcc=with_dcc, with_covariance=with_covariance,
                   n_modes=n_modes, tem=tem, tem_factors=tem_factors)
    solver = _banded_eigh(bandwidth, n_iter_bisect)
    return _run_chunked(lambda c: _anm_eigen_chunk(
        c, params, masses, solver, options), coords, chunk)


def ensemble_gnm_banded(coords, params, masses=None, *, with_dcc=False,
                        n_modes=None, dtype=torch.float32, bandwidth=8,
                        n_iter_bisect=40, tem=None, tem_factors=nma_core.K_B,
                        chunk=None, device=None,
                        use_pallas="auto"):
    """GNM twin of :func:`ensemble_anm_banded` over the Kirchhoff
    matrices."""
    coords, params, masses = _prepare(coords, params, masses, dtype, device,
                                      3)
    check_use_pallas(use_pallas, coords.device)
    options = dict(with_dcc=with_dcc, n_modes=n_modes, tem=tem,
                   tem_factors=tem_factors)
    solver = _banded_eigh(bandwidth, n_iter_bisect)
    return _run_chunked(lambda c: _gnm_eigen_chunk(
        c, params, masses, solver, options), coords, chunk)


# ---------------------------------------------------------------------------
# Spectral pipelines: banded eigenvalues + the Cholesky covariance
# ---------------------------------------------------------------------------


def _anm_spectral_chunk(coords, params, masses, inverse, n_modes, with_dcc,
                        bandwidth, n_iter_bisect, n_iter_modes):
    hessians = _build_hessians_batched(coords, params, masses)
    bases = rigid.rigid_modes_anm(coords, masses=masses)
    cov = rigid.covariance_cholesky(hessians, bases, inverse=inverse)
    vals = spectrum.eigvalsh_banded(hessians, bandwidth=bandwidth,
                                    n_iter=n_iter_bisect)
    out = {"eig_values": vals,
           "frequencies": nma_core.frequencies_from_eigenvalues(vals, 6),
           **_anm_cov_observables(cov, coords.shape[1], with_dcc, False)}
    if n_modes is not None:
        # subspace iteration on the covariance in hand: products only
        out["mode_values"], out["mode_vectors"] = \
            modes.modes_from_covariance(cov, hessians, bases, k=n_modes,
                                        n_iter=n_iter_modes)
    return out


def _gnm_spectral_chunk(coords, params, masses, inverse, n_modes, with_dcc,
                        bandwidth, n_iter_bisect, n_iter_modes):
    kirchhoffs = _build_kirchhoffs_batched(coords, params, masses)
    basis = rigid.null_mode_gnm(coords.shape[1], masses=masses,
                                dtype=coords.dtype, device=coords.device)
    cov = rigid.covariance_cholesky(kirchhoffs, basis, inverse=inverse)
    vals = spectrum.eigvalsh_banded(kirchhoffs, bandwidth=bandwidth,
                                    n_iter=n_iter_bisect)
    out = {"eig_values": vals,
           "frequencies": nma_core.frequencies_from_eigenvalues(vals, 1),
           **_gnm_cov_observables(cov, with_dcc)}
    if n_modes is not None:
        out["mode_values"], out["mode_vectors"] = \
            modes.modes_from_covariance(cov, kirchhoffs, basis, k=n_modes,
                                        n_iter=n_iter_modes)
    return out


def ensemble_anm_spectral(coords, params, masses=None, *, n_modes=None,
                          with_dcc=True, dtype=torch.float32, bandwidth=8,
                          n_iter_bisect=40, n_iter_modes=16, inverse="auto",
                          chunk=None, device=None,
                          use_pallas="auto"):
    """
    Spectral ANM of a conformer ensemble without a dense ``eigh``
    (``pipeline.py:416-492``): all eigenvalues and frequencies from the
    two-stage banded solver (bisection kernel on CUDA in float32), the
    covariance, MSF, B-factors and DCC from the regularized Cholesky
    covariance (`inverse` as in :func:`ensemble_anm_fluctuations`), and
    with `n_modes` the lowest non-trivial ``mode_values`` ``(B, k)`` and
    ``mode_vectors`` ``(B, k, 3n)`` by subspace iteration on that
    covariance.  Needs a connected network.
    """
    coords, params, masses = _prepare(coords, params, masses, dtype, device,
                                      3)
    check_use_pallas(use_pallas, coords.device)
    inverse = _resolve_inverse(inverse, coords)
    return _run_chunked(lambda c: _anm_spectral_chunk(
        c, params, masses, inverse, n_modes, with_dcc, bandwidth,
        n_iter_bisect, n_iter_modes), coords, chunk)


def ensemble_gnm_spectral(coords, params, masses=None, *, n_modes=None,
                          with_dcc=True, dtype=torch.float32, bandwidth=8,
                          n_iter_bisect=40, n_iter_modes=16, inverse="auto",
                          chunk=None, device=None,
                          use_pallas="auto"):
    """GNM twin of :func:`ensemble_anm_spectral` over the Kirchhoff
    matrices (``pipeline.py:535-598``)."""
    coords, params, masses = _prepare(coords, params, masses, dtype, device,
                                      3)
    check_use_pallas(use_pallas, coords.device)
    inverse = _resolve_inverse(inverse, coords)
    return _run_chunked(lambda c: _gnm_spectral_chunk(
        c, params, masses, inverse, n_modes, with_dcc, bandwidth,
        n_iter_bisect, n_iter_modes), coords, chunk)


def anm_spectral(coord, params, masses=None, *, n_modes=None, with_dcc=True,
                 dtype=torch.float32, bandwidth=8, n_iter_bisect=40,
                 n_iter_modes=24, device=None,
                 use_pallas="auto"):
    """:func:`ensemble_anm_spectral` for one structure ``(n, 3)``, with the
    Cholesky engine (``pipeline.py:347-413``)."""
    coord, params, masses = _prepare(coord, params, masses, dtype, device, 2)
    check_use_pallas(use_pallas, coord.device)
    return _single(lambda c: _anm_spectral_chunk(
        c, params, masses, "cho_solve", n_modes, with_dcc, bandwidth,
        n_iter_bisect, n_iter_modes), coord)


def gnm_spectral(coord, params, masses=None, *, with_dcc=True,
                 dtype=torch.float32, bandwidth=8, n_iter_bisect=40,
                 device=None,
                 use_pallas="auto"):
    """GNM twin of :func:`anm_spectral`, without mode shapes
    (``pipeline.py:495-532``)."""
    coord, params, masses = _prepare(coord, params, masses, dtype, device, 2)
    check_use_pallas(use_pallas, coord.device)
    return _single(lambda c: _gnm_spectral_chunk(
        c, params, masses, "cho_solve", None, with_dcc, bandwidth,
        n_iter_bisect, None), coord)
