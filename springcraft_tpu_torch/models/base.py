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

#: Where the matrix-free operations that the port still lacks stand.
_MISSING_MATFREE = "ROADMAP.md queue 1 item 3"


def not_ported(op):
    """Raise for a matrix-free operation of ``springcraft_tpu.ops.matfree``
    that the port does not have yet."""
    raise NotImplementedError(
        f"ops.matfree.{op} is not ported to springcraft_tpu_torch yet "
        f"({_MISSING_MATFREE}); use the dense path (matrix_free=False)")


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

    def _matfree_dcc(self, mode_subset, norm, tem, tem_factors, sites,
                     msf, modes, probes, options, *, rows_op_name,
                     msf_op_name):
        """Shared matrix-free DCC implementation for ANM/GNM
        (``dcc(matrix_free=True)``): all-mode DCC rows for `sites` by
        deflated CG (``ops.matfree.dcc_rows_matfree[_gnm]``).  With
        ``norm=True`` the normalizer comes from `msf`; estimating it in
        place from ``modes=`` needs the stochastic MSF, which the port
        does not have yet."""
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
                    "(e.g. the mode-sum MSF of lowest_modes), or "
                    "modes=<k | (values, vectors)> (optionally "
                    "probes=<p>) to estimate it in place via the "
                    "stochastic MSF")
            not_ported(msf_op_name)
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

    def _stochastic_msf(self, op_name, mode_subset, modes):
        """``mean_square_fluctuation(matrix_free=True)``: the deflated
        Hutchinson estimator (``ops.matfree.msf_stochastic[_gnm]``),
        which the port does not have yet; the arguments are checked as
        the JAX package checks them first."""
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
        not_ported(op_name)
