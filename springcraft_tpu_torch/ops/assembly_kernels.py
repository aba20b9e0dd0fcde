"""
Wrappers of the assembly and prep kernels, with their plain versions.

Counterpart of ``springcraft_tpu/ops/pallas_kernels.py:191-554``
(single-structure Hessian and Kirchhoff assembly), ``:688-1040``
(ensemble assembly), ``:1046-1165, 1344-1386`` (the regularize/stitch
prep) and ``:1167-1341`` (the assembly-fused prep); the assembly
wrappers take the analytic families and ``table_compact``, at any number
of atoms.  With patch overlays :func:`hessian_xyz_ensemble` and
:func:`kirchhoff_ensemble` run on the base family and add the sparse
correction of :mod:`.assembly` (``:284-295, 476-484, 913-927, 988-996``);
the planes layout and the assembly-fused prep refuse overlays, as their
TPU kernels do.

* :func:`hessian_planes_ensemble` — kernel ``csrc/hessian_planes.cu``
  (entry ``sc_hessian_planes``); plain version
  :func:`.assembly.hessian_planes_plain`.
* :func:`hessian_xyz_ensemble` — the same kernel with the xyz-layout
  store (entry ``sc_hessian_xyz``); plain version
  :func:`.assembly.hessian_xyz_plain`.
* :func:`kirchhoff_ensemble` — kernel ``csrc/kirchhoff.cu``; plain
  version :func:`.assembly.kirchhoff_plain`.
* :func:`regularize_stitch` — kernel ``csrc/regularize_stitch.cu``;
  plain version :func:`regularize_stitch_plain`.
* :func:`assembly_stitch` — kernel ``csrc/assembly_stitch.cu``: the same
  factor input straight from the coordinates; plain version
  :func:`assembly_stitch_plain`.  Its first pass,
  :func:`assembly_row_sums` (entry ``sc_assembly_row_sums``), writes the
  Hessian's diagonal superelements, whose diagonal the prep needs for its
  scale; plain version :func:`assembly_row_sums_plain`.

A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches its kernel (float32 only) or raises.  It never falls back
from one to the other.  ``<wrapper>.launches`` counts kernel launches;
the three assembly wrappers also count in ``.table_launches`` those that
took the kernel's table branch (a ``table_compact`` family), and
:func:`assembly_stitch` counts its row-sum pass in
``.row_sum_launches``.
"""

from __future__ import annotations

import torch

from .. import _build
from .assembly import (_pair_geometry, hessian_planes_plain,
                       hessian_xyz_plain, kirchhoff_plain,
                       overlay_correction_hessian_xyz,
                       overlay_correction_kirchhoff, planes_to_xyz)
from .ffparams import ANALYTIC_KINDS, strip_overlays

__all__ = [
    "hessian_planes_ensemble",
    "hessian_xyz_ensemble",
    "kirchhoff_ensemble",
    "regularize_stitch",
    "regularize_stitch_plain",
    "assembly_stitch",
    "assembly_stitch_plain",
    "assembly_row_sums",
    "assembly_row_sums_plain",
    "MAX_ATOMS_STITCH",
]

#: Most atoms of an assembly kernel: its row and column indices and
#: ``3 n`` are ints.  (The kernels read column atoms straight from device
#: memory, so a conformer of any size assembles.)
_MAX_ATOMS = 2**29
#: Largest conformer :func:`assembly_stitch` takes: its store pass
#: stages the column side (coordinates, scale and basis, 96 n bytes) in
#: shared memory, the JAX package's plan limit.
MAX_ATOMS_STITCH = 2048
_MAX_GRID_YZ = 65535


def _table_args(params, n, device):
    """The table branch's kernel arguments ``(tables, edges_sq,
    atom_code, n_bins, n_edges)``: pointers to the family's float32
    device tensors, or nulls for an analytic family."""
    if params.kind != "table_compact":
        return None, None, None, 0, 0
    params._check_atoms(n)
    dev = params.device_tables(device, torch.float32)
    return (dev["tables"].data_ptr(), dev["edges"].data_ptr(),
            dev["code"].data_ptr(), params.n_bins, dev["edges"].numel())


def _assemble(wrapper, entry, plain, out_shape, coords, params,
              correction=None):
    """Run an assembly kernel (C entry `entry`, output `out_shape` given
    ``(B, n)``) on `coords`, or its plain version on a CPU tensor.  With
    patch overlays the base family is assembled and `correction` adds
    the overlays' sparse part."""
    name = wrapper.__name__
    if coords.ndim != 3 or coords.shape[-1] != 3:
        raise ValueError(f"{name}: coords must be (B, n, 3), got "
                         f"{tuple(coords.shape)}")
    if params.overlays:
        if correction is None:
            raise ValueError(
                f"{name} takes no patch overlays: their sparse correction "
                f"applies to the assembled matrix (hessian_xyz_ensemble, "
                f"kirchhoff_ensemble)")
        params._check_atoms(coords.shape[1])
        base = _assemble(wrapper, entry, plain, out_shape, coords,
                         strip_overlays(params))
        return correction(base, coords, params)
    if _build.route(name, coords) == "cpu":
        return plain(coords, params)
    _build.require_cuda_f32(name, coords=coords)
    batch, n, _ = coords.shape
    if n > _MAX_ATOMS or batch > _MAX_GRID_YZ:
        raise ValueError(f"{name}: (B, n) = ({batch}, {n}) exceeds the "
                         f"kernel's index range (B <= {_MAX_GRID_YZ}, n <= "
                         f"{_MAX_ATOMS})")
    out = torch.empty(out_shape(batch, n), dtype=torch.float32,
                      device=coords.device)
    _build.launch(
        entry, coords.device, coords.data_ptr(), out.data_ptr(), batch, n,
        params.kind_code,
        float(params.cutoff_sq) if params.has_cutoff else 0.0,
        int(params.has_cutoff), *_table_args(params, n, coords.device))
    wrapper.launches += 1
    wrapper.table_launches += params.kind == "table_compact"
    return out


def hessian_planes_ensemble(coords, params):
    """Nine xyz Hessian component planes of a conformer batch,
    ``(B, n, 3) -> (9, B, n, n)`` (see
    :func:`.assembly.hessian_planes_plain` for the layout).  Refuses
    patch overlays."""
    return _assemble(hessian_planes_ensemble, "sc_hessian_planes",
                     hessian_planes_plain, lambda b, n: (9, b, n, n),
                     coords, params)


def hessian_xyz_ensemble(coords, params):
    """Dense xyz-layout Hessians of a conformer batch,
    ``(B, n, 3) -> (B, 3n, 3n)``: the single-structure assembly at
    ``B = 1`` and the float32 ``cho_solve`` ensemble engine's."""
    return _assemble(hessian_xyz_ensemble, "sc_hessian_xyz",
                     hessian_xyz_plain, lambda b, n: (b, 3 * n, 3 * n),
                     coords, params, overlay_correction_hessian_xyz)


def kirchhoff_ensemble(coords, params):
    """GNM Kirchhoff matrices of a conformer batch,
    ``(B, n, 3) -> (B, n, n)``: the ensemble assembly and, at ``B = 1``,
    the single-structure one."""
    return _assemble(kirchhoff_ensemble, "sc_kirchhoff", kirchhoff_plain,
                     lambda b, n: (b, n, n), coords, params,
                     overlay_correction_kirchhoff)


for _wrapper in (hessian_planes_ensemble, hessian_xyz_ensemble,
                 kirchhoff_ensemble):
    _wrapper.launches = 0
    _wrapper.table_launches = 0


def regularize_stitch_plain(planes, scale_h, ts, mp):
    """Plain version of :func:`regularize_stitch`: concatenation,
    scaling, ``ts @ ts^T`` and an identity pad."""
    batch, m = scale_h.shape
    reg = (planes_to_xyz(planes) * scale_h[:, :, None]
           * scale_h[:, None, :] + ts @ ts.transpose(-1, -2))
    out = torch.zeros((batch, mp, mp), dtype=reg.dtype, device=reg.device)
    out[:, :m, :m] = reg
    idx = torch.arange(m, mp, device=reg.device)
    out[:, idx, idx] = 1.0
    return out


def regularize_stitch(planes, scale_h, ts, mp):
    """Identity-padded, regularized, equilibrated factor input from the
    raw Hessian planes:

        reg = S' H S' + ts ts^T   (top-left 3n x 3n),  I on the pad

    Parameters
    ----------
    planes : Tensor, shape=(9, B, n, n)
    scale_h : Tensor, shape=(B, 3n)
        Row/column scale ``S'`` (Jacobi scale with mass weights folded
        in).
    ts : Tensor, shape=(B, 3n, 6)
        Scaled null basis ``S T sqrt(sigma)``.
    mp : int
        Padded size, ``>= 3n``.

    Returns
    -------
    reg : Tensor, shape=(B, mp, mp)
    """
    if planes.ndim != 4 or planes.shape[0] != 9 \
            or planes.shape[-1] != planes.shape[-2]:
        raise ValueError(f"planes must be (9, B, n, n), got "
                         f"{tuple(planes.shape)}")
    _, batch, n, _ = planes.shape
    m = 3 * n
    if tuple(scale_h.shape) != (batch, m) \
            or tuple(ts.shape) != (batch, m, 6):
        raise ValueError(
            f"scale_h must be ({batch}, {m}) and ts ({batch}, {m}, 6), "
            f"got {tuple(scale_h.shape)} and {tuple(ts.shape)}")
    if mp < m:
        raise ValueError(f"mp={mp} must be >= 3n={m}")
    if _build.route("regularize_stitch", planes, scale_h, ts) == "cpu":
        return regularize_stitch_plain(planes, scale_h, ts, mp)
    _build.require_cuda_f32("regularize_stitch", planes=planes,
                            scale_h=scale_h, ts=ts)
    if mp > _MAX_GRID_YZ or batch > _MAX_GRID_YZ:
        raise ValueError(f"regularize_stitch: (B, mp) = ({batch}, {mp}) "
                         f"exceeds the kernel's grid limit {_MAX_GRID_YZ}")
    if mp % 4:
        raise ValueError(f"regularize_stitch: mp={mp} must be a multiple "
                         f"of 4 on CUDA (the kernel writes 16-byte groups)")
    out = torch.empty((batch, mp, mp), dtype=torch.float32,
                      device=planes.device)
    _build.launch("sc_regularize_stitch", planes.device, planes.data_ptr(),
                  scale_h.data_ptr(), ts.data_ptr(), out.data_ptr(), batch,
                  n, mp)
    regularize_stitch.launches += 1
    return out


regularize_stitch.launches = 0


def _check_stitch_family(name, coords, params):
    if params.kind not in ANALYTIC_KINDS or params.overlays:
        raise ValueError(f"{name} takes the analytic families "
                         f"{ANALYTIC_KINDS} without patch overlays, got "
                         f"kind={params.kind!r} with "
                         f"{len(params.overlays)} overlays")
    if coords.ndim != 3 or coords.shape[-1] != 3:
        raise ValueError(f"{name}: coords must be (B, n, 3), got "
                         f"{tuple(coords.shape)}")


def _check_stitch_size(name, batch, n):
    if n > MAX_ATOMS_STITCH or batch > _MAX_GRID_YZ:
        raise ValueError(f"{name}: (B, n) = ({batch}, {n}) exceeds the "
                         f"kernel's limits (B <= {_MAX_GRID_YZ}, n <= "
                         f"{MAX_ATOMS_STITCH})")


def _check_stitch_inputs(name, coords, params, scale_h, ts, mp,
                         row_sums=None):
    _check_stitch_family(name, coords, params)
    batch, n, _ = coords.shape
    m = 3 * n
    if tuple(scale_h.shape) != (batch, m) \
            or tuple(ts.shape) != (batch, m, 6):
        raise ValueError(
            f"{name}: scale_h must be ({batch}, {m}) and ts ({batch}, "
            f"{m}, 6), got {tuple(scale_h.shape)} and {tuple(ts.shape)}")
    if row_sums is not None and tuple(row_sums.shape) != (batch, n, 9):
        raise ValueError(f"{name}: row_sums must be ({batch}, {n}, 9), got "
                         f"{tuple(row_sums.shape)}")
    if mp < m:
        raise ValueError(f"{name}: mp={mp} must be >= 3n={m}")


def assembly_row_sums_plain(coords, params):
    """Plain version of :func:`assembly_row_sums`: the negated row sums
    of the nine plain Hessian planes, ``-sum_q (g d_a) d_e``."""
    disp, sq, k = _pair_geometry(coords, params)
    g = -k / torch.where(sq == 0, torch.ones_like(sq), sq)
    return -torch.stack([((g * disp[a]) * disp[e]).sum(dim=-1)
                         for a in range(3) for e in range(3)], dim=-1)


def assembly_row_sums(coords, params):
    """The diagonal superelements of the xyz-layout Hessians of a
    conformer batch, ``(B, n, 3) -> (B, n, 9)``: ``out[b, p, 3 a + e] =
    H[b, a n + p, e n + p]``, the first pass of :func:`assembly_stitch`
    (its ``a == e`` entries are the Hessian's diagonal).  Analytic
    families without overlays, ``n <= MAX_ATOMS_STITCH`` on CUDA."""
    _check_stitch_family("assembly_row_sums", coords, params)
    if _build.route("assembly_row_sums", coords) == "cpu":
        return assembly_row_sums_plain(coords, params)
    _build.require_cuda_f32("assembly_row_sums", coords=coords)
    batch, n, _ = coords.shape
    _check_stitch_size("assembly_row_sums", batch, n)
    out = torch.empty((batch, n, 9), dtype=torch.float32,
                      device=coords.device)
    _build.launch("sc_assembly_row_sums", coords.device, coords.data_ptr(),
                  out.data_ptr(), batch, n, params.kind_code,
                  float(params.cutoff_sq) if params.has_cutoff else 0.0,
                  int(params.has_cutoff))
    assembly_stitch.row_sum_launches += 1
    return out


def assembly_stitch_plain(coords, params, scale_h, ts, mp, row_sums=None):
    """Plain version of :func:`assembly_stitch`: the plain Hessian
    planes through the plain stitch, their diagonal superelements
    replaced by `row_sums` when given."""
    _check_stitch_inputs("assembly_stitch_plain", coords, params, scale_h,
                         ts, mp, row_sums)
    planes = hessian_planes_plain(coords, params)
    if row_sums is not None:
        idx = torch.arange(coords.shape[1], device=coords.device)
        planes[:, :, idx, idx] = row_sums.permute(2, 0, 1).to(planes.dtype)
    return regularize_stitch_plain(planes, scale_h, ts, mp)


def assembly_stitch(coords, params, scale_h, ts, mp, row_sums):
    """The factor input of :func:`regularize_stitch` straight from the
    coordinates: the nine Hessian planes are recomputed where they are
    scaled and never reach device memory.  Analytic families.

    Parameters
    ----------
    coords : Tensor, shape=(B, n, 3)
    params : FFParams
    scale_h : Tensor, shape=(B, 3n)
    ts : Tensor, shape=(B, 3n, 6)
    mp : int
        As for :func:`regularize_stitch` (a multiple of 4 on CUDA).
    row_sums : Tensor, shape=(B, n, 9)
        The diagonal superelements from :func:`assembly_row_sums`, the
        kernel's first pass, which the prep runs for its scale.

    Returns
    -------
    reg : Tensor, shape=(B, mp, mp)
    """
    _check_stitch_inputs("assembly_stitch", coords, params, scale_h, ts, mp,
                         row_sums)
    if _build.route("assembly_stitch", coords, scale_h, ts,
                    row_sums) == "cpu":
        return assembly_stitch_plain(coords, params, scale_h, ts, mp,
                                     row_sums)
    _build.require_cuda_f32("assembly_stitch", coords=coords,
                            scale_h=scale_h, ts=ts, row_sums=row_sums)
    batch, n, _ = coords.shape
    _check_stitch_size("assembly_stitch", batch, n)
    if mp % 4:
        raise ValueError(f"assembly_stitch: mp={mp} must be a multiple of "
                         f"4 on CUDA (the kernel writes 16-byte groups)")
    out = torch.empty((batch, mp, mp), dtype=torch.float32,
                      device=coords.device)
    _build.launch("sc_assembly_stitch", coords.device, coords.data_ptr(),
                  scale_h.data_ptr(), ts.data_ptr(), row_sums.data_ptr(),
                  out.data_ptr(), batch, n, mp, params.kind_code,
                  float(params.cutoff_sq) if params.has_cutoff else 0.0,
                  int(params.has_cutoff))
    assembly_stitch.launches += 1
    return out


assembly_stitch.launches = 0
assembly_stitch.row_sum_launches = 0
