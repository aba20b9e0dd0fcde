"""
Anisotropic Network Model.

Counterpart of ``springcraft_tpu/models/anm.py``, API-compatible with
reference ``anm.py``: lazy ``hessian`` / ``covariance`` duals with
setters, optional mass weighting, and the full NMA observable set
(``eigen``, ``frequencies``, ``normal_mode``, ``linear_response``,
``mean_square_fluctuation``, ``bfactor``, ``dcc``,
``prs_effector_sensor``), plus ``lowest_modes``; float64 on the model's
device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.nma_core import bfactor_from_msf
from ..utils.config import as_tensor, check_use_pallas
from . import nma
from .base import ElasticNetworkModel, _numpy
from .interaction import _hessian
from .nma import K_B

__all__ = ["ANM"]


class ANM(ElasticNetworkModel):
    """
    Anisotropic Network Model: directional ENM over the ``(3n, 3n)``
    Hessian matrix (atom-interleaved layout
    ``[x1, y1, z1, ..., xn, yn, zn]``).

    Parameters
    ----------
    atoms : AtomArray, shape=(n,) or ndarray, shape=(n,3)
        Model atoms (usually CA) or their coordinates.
    force_field : ForceField
        Spring-constant rule.
    masses : bool or ndarray, shape=(n,), optional
        ``True`` infers per-residue masses from ``res_name``; an array
        gives explicit masses; default is no mass weighting.  The Hessian
        is weighted with ``outer(1/sqrt(m))`` with each weight repeated
        three times.
    use_cell_list : bool, optional
        Use a cell list for neighbor search on the host path.
    device : str or torch.device, optional
        Where the model's matrices live and its work runs; the current
        CUDA device by default.
    """

    _num_dim = 3

    def _compute_matrix(self):
        hessian, _ = _hessian(self._coord, self._ff, self._use_cell_list,
                              False, self._device)
        return hessian

    @property
    def hessian(self):
        """The ``(3n, 3n)`` Hessian matrix (lazily computed; assignable —
        assigning invalidates the covariance)."""
        return _numpy(self._get_matrix())

    @hessian.setter
    def hessian(self, value):
        self._set_matrix(value, error_cls=IndexError)

    def normal_mode(self, index, amplitude, frames, movement="sine"):
        """Displacement trajectory ``(frames, n, 3)`` depicting normal
        mode `index` (the first six modes are rigid-body motions)."""
        return nma.normal_mode(self, index, amplitude, frames, movement)

    def linear_response(self, force, matrix_free=False, **options):
        """Displacements induced by `force` via linear response theory.

        ``matrix_free=True`` computes ``pinv(H) @ force`` by deflated
        preconditioned CG on the implicit operator
        (``ops.matfree.linear_response_matfree``; K13 on the card) — for
        systems whose covariance exceeds device memory; extra `options`
        (``tol``, ``max_iter``, ...) pass through.  The dense path
        matches the reference exactly (``nma.py:422-473``)."""
        if not matrix_free:
            self._dense_path_rejects("linear_response", options)
            return nma.linear_response(self, force)

        from ..ops import matfree

        self._require_force_field_matrix(
            "linear_response(matrix_free=True)")
        force = np.asarray(force)
        n = len(self._coord)
        tol = options.setdefault("tol", 1e-6)
        disp, n_it, res = matfree.linear_response_matfree(
            self._coord, self._params(), force, masses=self._masses,
            device=self._device, **options)
        disp = self._check_converged("matrix-free linear response", disp,
                                     n_it, res, tol)
        return disp.reshape(n, 3) if force.ndim == 1 else disp

    def frequencies(self):
        """Mode frequencies in ascending order (first six trivial)."""
        return nma.frequencies(self)

    def mean_square_fluctuation(self, mode_subset=None, tem=None,
                                tem_factors=K_B, matrix_free=False,
                                modes=None, probes=None, **options):
        """MSF per node; equals the superelement traces of the covariance
        when all non-trivial modes are included.

        ``matrix_free=True`` estimates the *all-mode* MSF over all atoms
        without the covariance (``ops.matfree.msf_stochastic``; K13 on
        the card): deflated Hutchinson probes through one batched CG
        solve, unbiased at every atom, with ``modes`` (``k`` for
        ``lowest_modes(k, matrix_free=True)``, or a ``(values,
        vectors)`` pair) as the deflation subspace and exact rank-k
        floor.  Returns ``(msf, stderr)``; `mode_subset` is not
        supported there; extra `options` (``tol``, ``max_iter``,
        ``seed``, ...) pass through.  Mode vectors default to the
        model's atom-interleaved layout; pass ``layout="xyz"`` for
        ops-level ``lowest_modes_matfree`` output.
        """
        if not matrix_free:
            self._dense_path_rejects(
                "mean_square_fluctuation", options, modes=modes,
                probes=probes)
            return nma.mean_square_fluctuation(self, mode_subset, tem,
                                               tem_factors)
        return self._stochastic_msf(
            "msf_stochastic", mode_subset, tem, tem_factors, modes,
            probes, options, atom_layout=True)

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
        `sites` by deflated CG on the implicit operator
        (``ops.matfree.dcc_rows_matfree``; K13 on the card) — for
        systems whose covariance exceeds device memory.  With
        ``norm=True`` the normalization diagonal (the all-mode MSF)
        comes from `msf` or, with `msf` omitted, is estimated in place
        from ``modes=<k | (values, vectors)>`` (optionally
        ``probes=<p>``, default 64) by the stochastic MSF.  Returns the
        ``(len(sites), n)`` row block; extra `options` (``tol``,
        ``max_iter``, ...) pass through to the CG solver.
        """
        if not matrix_free:
            self._dense_path_rejects("dcc", options, sites=sites,
                                     msf=msf, modes=modes,
                                     probes=probes)
            return nma.dcc(self, mode_subset, norm, tem, tem_factors)
        return self._matfree_dcc(
            mode_subset, norm, tem, tem_factors, sites, msf, modes,
            probes, options, rows_op_name="dcc_rows_matfree",
            msf_op_name="msf_stochastic", atom_layout=True)

    def prs_effector_sensor(self, norm=True, matrix_free=False,
                            sites=None, prs_diag=None, modes=None,
                            probes=None, **options):
        """
        Perturbation-response-scanning matrix plus the derived effector
        (row-average) and sensor (column-average) profiles.

        ``matrix_free=True`` avoids the dense covariance three ways (K13
        on the card):

        * ``sites=<atom indices>``: *exact* profile values at selected
          sites (``ops.matfree.effector_sensor_matfree``, three CG
          columns per site in one batched solve).  With ``norm=True`` the
          ``(n,)`` folded-PRS diagonal comes from `prs_diag` or, with it
          omitted, from ``modes=<k | (values, vectors)>`` by the rank-k
          mode sum (``ops.matfree.prs_diag_from_modes``, a truncated
          lower bound).
        * ``modes=k`` or ``modes=(values, vectors)``: profiles over
          **all** atoms by the O(n k^2) mode-sum contraction
          (``ops.matfree.effector_sensor_from_modes``), the exact
          profiles of the rank-k covariance; an integer solves the k
          lowest modes first (:meth:`lowest_modes(matrix_free=True)
          <lowest_modes>`, extra `options` pass through).
        * ``probes=p``: unbiased **all-mode** profiles over **all** atoms
          by Hutchinson estimation (``ops.matfree.
          effector_sensor_stochastic``, ``2 p`` Rademacher columns in one
          batched CG); with ``modes=`` the rank-k part is an exact
          control variate.  With `prs_diag` omitted the normalizer is
          estimated in place from `modes` by
          ``ops.matfree.prs_diag_stochastic`` (one more batched CG on the
          probe seed + 1).

        In every matrix-free mode the ``(n, n)`` PRS matrix is never
        formed and ``None`` stands in its place: ``(None, effector,
        sensor)``.
        """
        if not matrix_free:
            self._dense_path_rejects(
                "prs_effector_sensor", options, sites=sites,
                prs_diag=prs_diag, modes=modes, probes=probes)
            prs_mat = nma.prs(self, norm)
            eff, sens = nma.effector_sensor(prs_mat, device=self._device)
            return prs_mat, eff, sens

        from ..ops import matfree

        if sites is not None and probes is not None:
            raise ValueError(
                "prs_effector_sensor(matrix_free=True): sites= (exact "
                "CG profile values at selected sites) is exclusive "
                "with probes= (stochastic full-atom estimator) — the "
                "exact site path would silently ignore it")
        if sites is None and modes is None and probes is None:
            raise ValueError(
                "prs_effector_sensor(matrix_free=True) needs "
                "sites=<atom indices> (exact profile values at "
                "selected sites by batched CG), modes=<k | (values, "
                "vectors)> (rank-k mode-sum profiles over all atoms), "
                "or probes=<p> (stochastic all-mode profiles over all "
                "atoms): the full (n, n) PRS matrix requires the "
                "dense covariance")
        if probes is not None:
            return None, *self._stochastic_profiles(
                norm, prs_diag, modes, probes, options)
        if sites is None:
            if prs_diag is not None:
                # the mode sum computes its own rank-k diagonal: a
                # normalizer passed here would be silently ignored
                raise ValueError(
                    "prs_effector_sensor(matrix_free=True, modes=...): "
                    "prs_diag= applies to the sites=/probes= paths; "
                    "the mode-sum computes its own rank-k "
                    "normalization diagonal")
            layout = options.pop("layout", None)
            if isinstance(modes, (int, np.integer)) \
                    and not isinstance(modes, bool):
                if layout not in (None, "atom"):
                    raise ValueError(
                        "layout= applies to explicit modes=(values, "
                        "vectors); modes=<k> solves lowest_modes, "
                        "which returns atom-interleaved vectors")
            # no CG follows on this path: every remaining option belongs
            # to lowest_modes
            vals, vecs = self._resolve_deflation_modes(
                modes, options, atom_layout=False, forward_all=True)
            eff, sens = matfree.effector_sensor_from_modes(
                vals, vecs, norm=norm, layout=layout or "atom",
                device=self._device)
            return None, _numpy(eff), _numpy(sens)
        self._require_force_field_matrix(
            "prs_effector_sensor(matrix_free=True)")
        if modes is not None:
            if not (norm and prs_diag is None):
                raise ValueError(
                    "prs_effector_sensor(matrix_free=True, sites=...): "
                    "modes= serves only to build the prs_diag "
                    "normalizer (norm=True with prs_diag omitted); "
                    "here it would be silently ignored")
            vals, vecs = self._resolve_deflation_modes(modes, options,
                                                       atom_layout=True)
            prs_diag = matfree.prs_diag_from_modes(
                vals, vecs, layout=options.pop("layout", "atom"),
                device=self._device)
        tol = options.setdefault("tol", 1e-6)
        eff, sens, n_it, res = matfree.effector_sensor_matfree(
            self._coord, self._params(), sites, prs_diag=prs_diag,
            norm=norm, masses=self._masses, device=self._device, **options)
        eff, sens = self._check_converged(
            "matrix-free effector/sensor", torch.stack((eff, sens)), n_it,
            res, tol)
        return None, eff, sens

    def _stochastic_profiles(self, norm, prs_diag, modes, probes, options):
        """The ``probes=`` route of :meth:`prs_effector_sensor`: the
        stochastic effector and sensor profiles as NumPy arrays, the
        normalizer estimated in place when `prs_diag` is None."""
        from ..ops import matfree

        self._require_force_field_matrix(
            "prs_effector_sensor(matrix_free=True)")
        params = self._params()
        modes = self._resolve_deflation_modes(modes, options,
                                              atom_layout=True)
        tol = options.setdefault("tol", 1e-6)
        seed = options.pop("seed", 0)
        if prs_diag is None:
            # the unbiased stochastic P_ii, deflated on the same modes;
            # its own probe seed keeps its noise uncorrelated with the
            # profile probes
            if modes is None:
                raise ValueError(
                    "prs_effector_sensor(matrix_free=True, "
                    "probes=...) without prs_diag= needs modes=<k "
                    "| (values, vectors)> to estimate the "
                    "folded-PRS diagonal in place "
                    "(prs_diag_stochastic) — or pass prs_diag= "
                    "directly")
            prs_diag, _, n_it, res = matfree.prs_diag_stochastic(
                self._coord, params, modes, probes=probes,
                masses=self._masses, seed=seed + 1, device=self._device,
                **options)
            self._check_converged("stochastic prs_diag normalizer",
                                  prs_diag, n_it, res, tol)
        eff, sens, _, _, n_it, res = matfree.effector_sensor_stochastic(
            self._coord, params, prs_diag, probes=probes, norm=norm,
            masses=self._masses, modes=modes, seed=seed,
            device=self._device, **options)
        eff, sens = self._check_converged(
            "stochastic effector/sensor", torch.stack((eff, sens)), n_it,
            res, tol)
        return eff, sens

    def lowest_modes(self, k, matrix_free=False, refine=False,
                     **options):
        """
        The `k` lowest non-trivial modes on the device *without* a full
        eigendecomposition — beyond the reference, which always runs
        dense ``eigh`` (reference ``nma.py:61``).

        ``matrix_free=False`` (default): the dense xyz-layout Hessian
        (float32 unless ``dtype=`` says otherwise) and shift-invert
        subspace iteration (``ops.modes.lowest_modes_anm``, the
        ``"invfactor"`` engine with K3 at its leaves for float32 on the
        card).  ``matrix_free=True``: the block-sparse Chebyshev solver
        (``ops.matfree.lowest_modes_matfree``, K13); the Hessian is never
        formed.  Extra `options` pass through to the solver.  Requires a
        force field with a device parameterization.

        ``refine=True`` follows the float32 solve with a float64
        Rayleigh-Ritz pass on the device (``ops.modes.refine_modes_f64``);
        the solve is widened by ``refine_buffer`` (default 4) extra modes
        so the slow-converging subspace boundary stays outside the
        returned block.

        Returns
        -------
        eig_values : ndarray, shape=(k,)
            Smallest non-trivial eigenvalues, ascending.
        eig_vectors : ndarray, shape=(k, 3n)
            Modes in rows, atom-interleaved layout (as :meth:`eigen`).
        residuals : ndarray, shape=(k,)
            Relative eigenpair residuals — always check convergence.
        """
        from ..ops import assembly, matfree, modes

        self._require_force_field_matrix("lowest_modes")
        params = self._params()
        coord = self._coord
        n = coord.shape[0]
        masses = self._masses

        refine_block = options.pop("refine_block", 256)
        buffer = options.pop("refine_buffer", 4) if refine else 0
        k_solve = k + buffer
        if matrix_free:
            vals, vecs, res = matfree.lowest_modes_matfree(
                coord, params, k_solve, masses=masses, device=self._device,
                **options)
        else:
            check_use_pallas(options.pop("use_pallas", None), self._device)
            dtype = options.pop("dtype", torch.float32)
            # assembled in float64 and rounded once, so that the solve's
            # operator keeps every pair of the float64 one that the
            # refinement applies: float32 coordinates decide a pair
            # within an ulp of the cutoff by their rounding
            hessian = assembly.hessian_matrix(
                as_tensor(coord, torch.float64, self._device), params,
                layout="xyz")
            if masses is not None:
                w3 = (1.0 / torch.sqrt(as_tensor(
                    masses, torch.float64, self._device))).repeat(3)
                hessian = hessian * w3[:, None] * w3[None, :]
            hessian = hessian.to(dtype)
            vals, vecs = modes.lowest_modes_anm(
                hessian, as_tensor(coord, dtype, self._device), k_solve,
                masses=masses, **options)
            res = modes.mode_residuals(hessian, vals, vecs)

        if refine:
            vals, vecs, res = modes.refine_modes_f64(
                coord, params, vecs, masses=masses, layout="xyz",
                block=refine_block)
            vals, vecs, res = vals[:k], vecs[:k], res[:k]

        # xyz plane layout -> the model's atom-interleaved layout
        inv = (torch.arange(3)[None, :] * n
               + torch.arange(n)[:, None]).reshape(-1)
        return _numpy(vals), _numpy(vecs[:, inv.to(vecs.device)]), _numpy(res)
