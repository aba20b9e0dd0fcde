"""
Shared machinery for the GNM/ANM model classes: coordinate/mass intake,
lazily computed interaction-matrix / covariance duals with setters that
invalidate each other, and a cached eigensystem.

Counterpart of ``springcraft_tpu/models/base.py``.  The dual-cache
contract mirrors the reference (``anm.py:98-148``, ``gnm.py:91-143``);
the eigensystem is computed once per matrix state, as in the JAX
package.  The matrices, the covariance and the eigensystem are float64
tensors on the model's device (by default the current CUDA device); the
public properties and methods hand out writable NumPy arrays of their
own.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import assembly, linalg
from ..structure import info as struc_info
from ..structure.atoms import coord as as_coord
from ..utils.config import as_tensor, resolve_device

__all__ = ["ElasticNetworkModel"]


def _numpy(t):
    """A tensor as a writable NumPy array of its own."""
    out = t.cpu().numpy()
    return out.copy() if t.device.type == "cpu" else out


class ElasticNetworkModel:
    """Common base for :class:`GNM` and :class:`ANM`."""

    #: dimensions per atom in the interaction matrix (1 = GNM, 3 = ANM)
    _num_dim = 1

    def __init__(self, atoms, force_field, masses=None, use_cell_list=True,
                 device=None):
        self._coord = np.asarray(as_coord(atoms), dtype=np.float64)
        self._ff = force_field
        self._use_cell_list = use_cell_list
        self._device = resolve_device(device)
        self._masses = self._resolve_masses(atoms, masses)

        if self._masses is not None:
            self._mass_weight_matrix = assembly.mass_weights(
                torch.as_tensor(self._masses, device=self._device),
                repeat3=(self._num_dim == 3))
        else:
            self._mass_weight_matrix = None

        self._matrix = None
        self._covariance = None
        self._eigen_cache = None
        #: True once the user assigns hessian/kirchhoff/covariance —
        #: device solvers that rebuild from the force field must refuse
        self._matrix_user_set = False

    @staticmethod
    def _resolve_masses(atoms, masses):
        if masses is None or masses is False:
            return None
        if masses is True:
            # Duck-typed: anything exposing res_name (the port's
            # AtomArray, a biotite AtomArray, ...) supports automatic
            # mass inference.
            res_name = getattr(atoms, "res_name", None)
            if res_name is None:
                raise TypeError(
                    "An AtomArray is required to automatically infer masses"
                )
            return struc_info.residue_masses(np.asarray(res_name))
        masses = np.asarray(masses, dtype=float)
        n = atoms.array_length() if hasattr(atoms, "array_length") \
            else len(as_coord(atoms))
        if len(masses) != n:
            raise IndexError(f"{len(masses)} masses for {n} atoms given")
        if np.any(masses == 0):
            raise ValueError("Masses must not be 0")
        return masses

    # -- subclass hooks ------------------------------------------------------

    def _compute_matrix(self):
        """The float64 interaction matrix, a tensor on the model's
        device."""
        raise NotImplementedError

    @property
    def _matrix_dim(self):
        return len(self._coord) * self._num_dim

    # -- lazy dual caches ----------------------------------------------------

    def _require_force_field_matrix(self, what):
        """Guard for device solvers that rebuild the interaction matrix
        from the force field: a user-assigned matrix/covariance would be
        silently ignored."""
        if self._matrix_user_set:
            raise ValueError(
                f"{what} rebuilds the interaction matrix from the force "
                "field and would ignore the explicitly assigned "
                "hessian/kirchhoff/covariance — use the dense API "
                "instead")

    def _get_matrix(self):
        if self._matrix is None:
            if self._covariance is None:
                matrix = self._compute_matrix()
                if self._mass_weight_matrix is not None:
                    matrix = matrix * self._mass_weight_matrix
                self._matrix = matrix
            else:
                self._matrix = linalg.pinvh(self._covariance, rcond=1e-6)
        return self._matrix

    def _assigned(self, value, error_cls):
        """An assigned matrix as a float64 tensor on the model's device,
        its shape checked."""
        dim = self._matrix_dim
        shape = tuple(value.shape)
        if shape != (dim, dim):
            raise error_cls(f"Expected shape {(dim, dim)}, got {shape}")
        if isinstance(value, torch.Tensor):
            return value.to(device=self._device, dtype=torch.float64)
        return as_tensor(value, torch.float64, self._device)

    def _set_matrix(self, value, error_cls=IndexError):
        self._matrix = self._assigned(value, error_cls)
        self._covariance = None
        self._eigen_cache = None
        self._matrix_user_set = True

    def _get_covariance(self):
        if self._covariance is None:
            # from the cached eigensystem: the one decomposition serves both
            vals, modes = self._eigen()
            self._covariance = linalg.pinvh_from_eigh(
                vals, modes.transpose(-1, -2), rcond=1e-6)
        return self._covariance

    @property
    def covariance(self):
        """Pseudo-inverse of the interaction matrix
        (``rcond=1e-6``, Hermitian)."""
        return _numpy(self._get_covariance())

    @covariance.setter
    def covariance(self, value):
        self._covariance = self._assigned(value, IndexError)
        self._matrix = None
        self._eigen_cache = None
        self._matrix_user_set = True

    @property
    def masses(self):
        return self._masses

    def eigen(self):
        """
        Eigenvalues (ascending) and eigenvectors (modes in rows) of the
        interaction matrix; cached until the matrix changes.

        Each call returns fresh, mutable arrays (the reference contract):
        mutating a returned array does not corrupt subsequent calls.
        """
        vals, vecs = self._eigen()
        return _numpy(vals), _numpy(vecs)

    def _eigen(self):
        """Cached eigensystem, tensors on the model's device — internal
        use only (callers must not mutate)."""
        if self._eigen_cache is None:
            self._eigen_cache = linalg.eigensystem(self._get_matrix())
        return self._eigen_cache

    @staticmethod
    def _dense_path_rejects(method, options, **kwargs):
        """Fail fast when matrix-free-only arguments reach a dense
        (``matrix_free=False``) observable path: silently swallowing
        them would return a differently-shaped result than the
        stochastic surfaces document with no hint which path ran."""
        bad = sorted([name for name, val in kwargs.items()
                      if val is not None] + list(options))
        if bad:
            raise ValueError(
                f"{method}: argument(s) {', '.join(bad)} apply only to "
                f"matrix_free=True; the dense path computes from the "
                f"covariance directly (pass matrix_free=True, or drop "
                f"them)")

    def _params(self):
        from ..parallel.pipeline import _resolve_params

        return _resolve_params(self._ff, len(self._coord))

    @staticmethod
    def _check_converged(what, out, n_it, res, tol):
        """Raise unless the matrix-free result `out` is finite with every
        relative residual within ``10 tol``; returns `out` as NumPy."""
        out = _numpy(out)
        max_res = float(torch.as_tensor(res).max())
        if not np.all(np.isfinite(out)) or max_res > 10 * tol:
            raise ValueError(
                f"{what} did not converge: max relative residual "
                f"{max_res:.2e} after {int(n_it)} CG iterations (tol "
                f"{tol:.0e}) — raise max_iter, or check network "
                "connectivity")
        return out

    def _resolve_deflation_modes(self, modes, options, atom_layout,
                                 forward_all=False):
        """Resolve a ``modes=`` deflation-subspace argument of the
        stochastic matrix-free surfaces: an integer ``k`` runs
        :meth:`lowest_modes(k, matrix_free=True) <lowest_modes>` (solver
        options forwarded: only ``tile`` / ``use_pallas`` unless
        `forward_all`, the rest belong to the CG that follows) and guards
        the returned mode residuals against ``mode_residual_tol`` (popped
        from `options`, default 1e-2): a spuriously small unconverged
        eigenvalue would bias the rank-k control variate while the CG
        residual guard still passes.  Defaults the op-level ``layout`` to
        ``"atom"`` when `atom_layout` (what :meth:`lowest_modes` /
        :meth:`eigen` return; GNM vectors carry no component layout).
        Returns the ``(values, vectors)`` pair (or ``None`` untouched)."""
        mode_rtol = options.pop("mode_residual_tol", None)
        if isinstance(modes, bool):
            # bool is an int subclass: modes=True would silently run
            # lowest_modes(1), a likely typo for a matrix_free flag
            raise TypeError(
                "modes must be an integer mode count or a (values, "
                f"vectors) pair, got {modes!r} — did you mean "
                "matrix_free=True?")
        if mode_rtol is not None and not isinstance(modes,
                                                    (int, np.integer)):
            # the tolerance guards the internal lowest_modes solve, which
            # only runs for modes=<k>
            raise ValueError(
                "mode_residual_tol applies only to modes=<k> (it guards "
                "the internal lowest_modes solve); pre-converged "
                "modes=(values, vectors) carry their own residuals")
        if mode_rtol is None:
            mode_rtol = 1e-2
        if isinstance(modes, (int, np.integer)):
            fwd = (dict(options) if forward_all else
                   {k: v for k, v in options.items()
                    if k in ("tile", "use_pallas")})
            vals, vecs, res = self.lowest_modes(int(modes),
                                                matrix_free=True, **fwd)
            max_res = float(np.max(res)) if res.size else 0.0
            if not np.isfinite(max_res) or max_res > mode_rtol:
                raise ValueError(
                    f"deflation modes did not converge: max relative "
                    f"eigenpair residual {max_res:.2e} (tol "
                    f"{mode_rtol:.0e}) from lowest_modes(matrix_free="
                    f"True) — raise the solver budget (e.g. degree/"
                    f"n_iter), pass pre-converged modes=(values, "
                    f"vectors), or loosen mode_residual_tol")
            modes = (vals, vecs)
            if atom_layout:
                # lowest_modes returns atom-interleaved vectors
                options["layout"] = "atom"
        elif modes is not None and atom_layout:
            # the model's default: atom-interleaved (what lowest_modes /
            # eigen return); pass layout="xyz" for ops-level
            # lowest_modes_matfree output
            options.setdefault("layout", "atom")
        return modes

    def _matfree_dcc(self, mode_subset, norm, tem, tem_factors, sites,
                     msf, modes, probes, options, *, rows_op_name,
                     msf_op_name, atom_layout):
        """Shared matrix-free DCC implementation for ANM/GNM
        (``dcc(matrix_free=True)``): all-mode DCC rows for `sites` by
        deflated CG (``ops.matfree.dcc_rows_matfree[_gnm]``).  With
        ``norm=True`` and `msf` omitted, ``modes=<k | (values, vectors)>``
        (optionally ``probes=``) estimates the normalizer in place by the
        stochastic all-mode MSF, one more batched CG solve; its per-atom
        standard error ``sem`` enters row ``ij`` as a relative error of
        about ``(sem_i / msf_i + sem_j / msf_j) / 2``."""
        from ..ops import matfree

        if sites is None:
            raise ValueError(
                "dcc(matrix_free=True) needs sites=<atom indices>: the "
                "full (n, n) DCC requires the dense covariance")
        if mode_subset is not None:
            raise ValueError(
                "dcc(matrix_free=True) is an all-mode quantity; "
                "mode_subset is not supported")
        self._require_force_field_matrix("dcc(matrix_free=True)")
        if norm and msf is None:
            if modes is None:
                raise ValueError(
                    "dcc(matrix_free=True, norm=True) needs the "
                    "all-mode MSF normalizer: pass msf=<(n,) values> "
                    "(e.g. mean_square_fluctuation(matrix_free=True)), "
                    "or modes=<k | (values, vectors)> (optionally "
                    "probes=<p>) to estimate it in place via the "
                    "stochastic MSF")
            # the copy keeps the estimator's own keys (layout, seed) out
            # of the row solve below; CG options (tol, max_iter) are
            # shared
            est_options = dict(options)
            options.pop("layout", None)
            options.pop("seed", None)
            msf, _ = self._stochastic_msf(msf_op_name, None, None,
                                          tem_factors, modes, probes,
                                          est_options, atom_layout)
        elif modes is not None or probes is not None:
            raise ValueError(
                "dcc(matrix_free=True): modes=/probes= serve only to "
                "estimate the msf normalizer; with msf= given (or "
                "norm=False) they would be silently ignored")
        tol = options.setdefault("tol", 1e-6)
        rows, n_it, res = getattr(matfree, rows_op_name)(
            self._coord, self._params(), sites, norm=norm, msf=msf,
            masses=self._masses, device=self._device, **options)
        rows = self._check_converged("matrix-free DCC", rows, n_it, res,
                                     tol)
        if tem is not None:
            rows = rows * tem * tem_factors
        return rows

    def _stochastic_msf(self, op_name, mode_subset, tem, tem_factors,
                        modes, probes, options, atom_layout):
        """Shared matrix-free MSF implementation for ANM/GNM
        (``mean_square_fluctuation(matrix_free=True)``): resolve the
        deflation modes, run the deflated Hutchinson estimator
        (``ops.matfree.msf_stochastic[_gnm]``), guard convergence and
        apply the reference temperature scaling.  Returns ``(msf,
        stderr)`` as NumPy arrays.  `atom_layout` as in
        :meth:`_resolve_deflation_modes`."""
        from ..ops import matfree, nma_core

        if mode_subset is not None:
            raise ValueError(
                "mean_square_fluctuation(matrix_free=True) is an "
                "all-mode quantity; mode_subset is not supported")
        if modes is None:
            raise ValueError(
                "mean_square_fluctuation(matrix_free=True) needs "
                "modes=<k | (values, vectors)> as the deflation "
                "subspace (e.g. k=10 runs lowest_modes(10, "
                "matrix_free=True) first)")
        self._require_force_field_matrix(
            "mean_square_fluctuation(matrix_free=True)")
        modes = self._resolve_deflation_modes(modes, options, atom_layout)
        probes = 64 if probes is None else probes
        tol = options.setdefault("tol", 1e-6)
        msf, stderr, n_it, res = getattr(matfree, op_name)(
            self._coord, self._params(), modes, probes=probes,
            masses=self._masses, device=self._device, **options)
        msf = self._check_converged("stochastic MSF", msf, n_it, res, tol)
        scale = nma_core.temperature_scaling(tem, tem_factors)
        return msf * scale, _numpy(stderr) * scale
