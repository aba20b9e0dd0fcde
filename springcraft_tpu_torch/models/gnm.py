"""
Gaussian Network Model.

Counterpart of ``springcraft_tpu/models/gnm.py``, API-compatible with
reference ``gnm.py``: lazy ``kirchhoff`` / ``covariance`` duals with
setters, optional mass weighting, and the NMA observable methods
(``eigen``, ``frequencies``, ``mean_square_fluctuation``, ``bfactor``,
``dcc``), plus ``lowest_modes``; float64 on the model's device.
"""

from __future__ import annotations

import torch

from ..ops.nma_core import bfactor_from_msf
from ..utils.config import as_tensor, check_use_pallas
from . import nma
from .base import ElasticNetworkModel, _numpy
from .interaction import _kirchhoff
from .nma import K_B

__all__ = ["GNM"]


class GNM(ElasticNetworkModel):
    """
    Gaussian Network Model: isotropic ENM over the ``(n, n)`` Kirchhoff
    matrix.

    Parameters
    ----------
    atoms : AtomArray, shape=(n,) or ndarray, shape=(n,3)
        Model atoms (usually CA) or their coordinates.
    force_field : ForceField
        Spring-constant rule.
    masses : bool or ndarray, shape=(n,), optional
        ``True`` infers per-residue masses from ``res_name``; an array
        gives explicit masses; default is no mass weighting.  The
        Kirchhoff matrix is weighted with ``outer(1/sqrt(m))``.
    use_cell_list : bool, optional
        Use a cell list for neighbor search on the host path.
    device : str or torch.device, optional
        Where the model's matrices live and its work runs; the current
        CUDA device by default.
    """

    _num_dim = 1

    def _compute_matrix(self):
        kirchhoff, _ = _kirchhoff(self._coord, self._ff, self._use_cell_list,
                                  False, self._device)
        return kirchhoff

    @property
    def kirchhoff(self):
        """The ``(n, n)`` Kirchhoff matrix (lazily computed; assignable —
        assigning invalidates the covariance)."""
        return _numpy(self._get_matrix())

    @kirchhoff.setter
    def kirchhoff(self, value):
        self._set_matrix(value, error_cls=ValueError)

    def frequencies(self):
        """Mode frequencies in ascending order (first mode trivial)."""
        return nma.frequencies(self)

    def mean_square_fluctuation(self, mode_subset=None, tem=None,
                                tem_factors=K_B, matrix_free=False,
                                modes=None, probes=None, **options):
        """MSF per node; equals the covariance diagonal when all
        non-trivial modes are included.

        ``matrix_free=True`` estimates the *all-mode* MSF over all atoms
        without the covariance (``ops.matfree.msf_stochastic_gnm``; K14
        on the card): deflated Hutchinson probes through one batched CG
        solve, unbiased at every atom, with ``modes`` (``k`` or a
        ``(values, vectors)`` pair) as the deflation subspace and exact
        rank-k floor.  Returns ``(msf, stderr)``; `mode_subset` is not
        supported there.  Extra `options` (``tol``, ``max_iter``,
        ``precond``, ...) pass through to the solver.
        """
        if not matrix_free:
            self._dense_path_rejects(
                "mean_square_fluctuation", options, modes=modes,
                probes=probes)
            return nma.mean_square_fluctuation(self, mode_subset, tem,
                                               tem_factors)
        return self._stochastic_msf(
            "msf_stochastic_gnm", mode_subset, tem, tem_factors, modes,
            probes, options, atom_layout=False)

    def bfactor(self, mode_subset=None, tem=None, tem_factors=K_B,
                matrix_free=False, **options):
        """Isotropic B-factors from the MSF.

        ``matrix_free=True`` scales the stochastic all-mode MSF estimate
        (see :meth:`mean_square_fluctuation`); returns ``(bfactor,
        stderr)``."""
        if not matrix_free:
            self._dense_path_rejects("bfactor", options)
            return nma.bfactor(self, mode_subset, tem, tem_factors)
        msf, stderr = self.mean_square_fluctuation(
            mode_subset, tem, tem_factors, matrix_free=True, **options)
        return bfactor_from_msf(msf), bfactor_from_msf(stderr)

    def dcc(self, mode_subset=None, norm=True, tem=None, tem_factors=K_B,
            matrix_free=False, sites=None, msf=None, modes=None,
            probes=None, **options):
        """Dynamic cross-correlation between nodes.

        ``matrix_free=True`` computes all-mode DCC *rows* for the given
        `sites` by deflated CG on the implicit Kirchhoff operator
        (``ops.matfree.dcc_rows_matfree_gnm``; K14 on the card) — for
        systems whose covariance exceeds device memory.  ``norm=True``
        takes the all-mode GNM MSF from `msf` or, with `msf` omitted,
        estimates it in place from ``modes=<k | (values, vectors)>``
        (optionally ``probes=<p>``, default 64) by the stochastic MSF.
        Extra `options` (``tol``, ``max_iter``, ``precond``, ...) pass
        through to the solver.
        """
        if not matrix_free:
            self._dense_path_rejects("dcc", options, sites=sites,
                                     msf=msf, modes=modes,
                                     probes=probes)
            return nma.dcc(self, mode_subset, norm, tem, tem_factors)
        return self._matfree_dcc(
            mode_subset, norm, tem, tem_factors, sites, msf, modes,
            probes, options, rows_op_name="dcc_rows_matfree_gnm",
            msf_op_name="msf_stochastic_gnm", atom_layout=False)

    def lowest_modes(self, k, matrix_free=False, refine=False,
                     **options):
        """
        The `k` lowest non-trivial GNM modes on the device without a full
        eigendecomposition (see :meth:`ANM.lowest_modes`): the dense
        Kirchhoff matrix and shift-invert subspace iteration
        (``ops.modes.lowest_modes_shift_invert``, the ``"invfactor"``
        engine with K3 at its leaves for float32 on the card) by default,
        or the matrix-free Chebyshev solver (`matrix_free=True`,
        ``ops.matfree.lowest_modes_matfree_gnm``, K14) when the Kirchhoff
        matrix exceeds device memory.  ``refine=True`` adds the float64
        Rayleigh-Ritz pass (``ops.modes.refine_modes_f64_gnm``;
        ``refine_buffer`` extra modes, default 4).
        Returns ``(values, modes (k, n), residuals)``.
        """
        from ..ops import assembly, matfree, modes, rigid

        self._require_force_field_matrix("lowest_modes")
        params = self._params()
        coord = self._coord
        masses = self._masses

        refine_block = options.pop("refine_block", 2048)
        buffer = options.pop("refine_buffer", 4) if refine else 0
        k_solve = k + buffer

        if matrix_free:
            vals, vecs, res = matfree.lowest_modes_matfree_gnm(
                coord, params, k_solve, masses=masses, device=self._device,
                **options)
        else:
            check_use_pallas(options.pop("use_pallas", None), self._device)
            dtype = options.pop("dtype", torch.float32)
            # assembled in float64 and rounded once (as in ANM)
            kirchhoff = assembly.kirchhoff_matrix(
                as_tensor(coord, torch.float64, self._device), params)
            m = None
            if masses is not None:
                w = 1.0 / torch.sqrt(as_tensor(masses, torch.float64,
                                               self._device))
                kirchhoff = kirchhoff * w[:, None] * w[None, :]
                m = as_tensor(masses, dtype, self._device)
            kirchhoff = kirchhoff.to(dtype)
            basis = rigid.null_mode_gnm(coord.shape[0], masses=m,
                                        dtype=dtype, device=self._device)
            if 2 * max(k_solve, 8) + 2 * k_solve >= kirchhoff.shape[0]:
                vals, vecs = modes._dense_lowest(kirchhoff, k_solve, basis)
            else:
                vals, vecs = modes.lowest_modes_shift_invert(
                    kirchhoff, basis, k=k_solve, **options)
            res = modes.mode_residuals(kirchhoff, vals, vecs)

        if refine:
            vals, vecs, res = modes.refine_modes_f64_gnm(
                coord, params, vecs, masses=masses, block=refine_block)
            vals, vecs, res = vals[:k], vecs[:k], res[:k]
        return _numpy(vals), _numpy(vecs), _numpy(res)
