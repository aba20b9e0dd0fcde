"""
springcraft_tpu_torch — the PyTorch/CUDA port of springcraft_tpu.

A second package beside the JAX one (``springcraft_tpu``, the reference
it is held against).  It imports ``torch`` and numpy, never ``jax`` and
never ``springcraft_tpu``.  It covers fluctuation NMA without an
eigendecomposition — over conformer ensembles
(:func:`ensemble_anm_fluctuations`, :func:`ensemble_gnm_fluctuations`)
and for one structure (:func:`anm_fluctuations`,
:func:`gnm_fluctuations`), with the covariance and PRS — for the analytic
force fields and the tabulated ones (:class:`TabulatedForceField` with
its named parameterizations sdENM, eANM and the others, built from a
structure read by :func:`load_structure`), each optionally wrapped in a
:class:`PatchedForceField` (contact shutdown, pairs switched off or on),
with hand-written CUDA kernels
for Hopper (``csrc/``) on its paths; and the spectral pipelines —
eigenvalues, frequencies and mode shapes from a two-stage banded eigensolver
(:func:`ensemble_anm_spectral`, :func:`ensemble_anm_banded`, their GNM
twins, :func:`anm_spectral`, :func:`gnm_spectral`) beside the dense
``torch.linalg.eigh`` route (:func:`ensemble_anm`, :func:`anm_observables`
and their GNM twins); and past the dense regime, the matrix-free path
(:mod:`.ops.matfree`, block-sparse and dense-grid ``H @ X`` and ``K @ X``
kernels): the lowest modes by Chebyshev-filtered subspace iteration
(:func:`lowest_modes_matfree`, :func:`lowest_modes_matfree_gnm`,
:func:`estimate_lambda_max`) and covariance applications by deflated,
preconditioned CG (:func:`covariance_solve_matfree`,
:func:`covariance_solve_matfree_gnm`, :func:`linear_response_matfree`,
:func:`prs_rows_matfree`, :func:`dcc_rows_matfree`,
:func:`dcc_rows_matfree_gnm`), with the effector/sensor profiles and the
stochastic all-mode estimators around them (:func:`msf_stochastic`,
:func:`msf_stochastic_gnm`, :func:`prs_diag_stochastic`,
:func:`effector_sensor_stochastic`, :func:`effector_sensor_matfree`,
:func:`prs_diag_from_modes`, :func:`effector_sensor_from_modes`); and
for one structure's lowest modes
without a full eigendecomposition, shift-invert subspace iteration
(:func:`lowest_modes_anm`, :func:`lowest_modes_shift_invert`, the inverse
factor's leaf kernel on CUDA) or LOBPCG (:func:`lowest_modes`), refined
in float64 on the card (:func:`refine_modes_f64`,
:func:`refine_modes_f64_gnm`).

The reference-compatible model API — :class:`ANM`, :class:`GNM`,
:func:`compute_hessian`, :func:`compute_kirchhoff` and the :mod:`nma`
functions — computes in float64 on the device and returns NumPy arrays,
as the JAX package's does.

Host layer: structures from PDB, mmCIF and BinaryCIF files
(:func:`load_structure`, :mod:`.structure`), models and results saved and
restored (:mod:`.io`), and the elastic loop that lets the long solvers
snapshot, retry and resume (:mod:`.utils.elastic`; ``checkpoint=``,
``retries=``).

Entry points run on the current CUDA device unless the caller passes a
tensor that lies elsewhere or ``device="cpu"``.

Importing the package turns TF32 off for float32 matrix products (see
:mod:`.utils.config`).
"""

__version__ = "0.1.0"

from .utils import config  # noqa: F401  (pins float32 precision)
from . import io, ops, parallel, structure, utils
from .ops.ffparams import (FFParams, PatchOverlay, from_numpy_params,
                           hinsen_params, invariant_params, pfenm_params,
                           strip_overlays, table_compact_params,
                           table_pair_params, with_overlay)
from .models import (ANM, GNM, ForceField, HinsenForceField,
                     InvariantForceField, ParameterFreeForceField,
                     PatchedForceField, TabulatedForceField, bfactor,
                     compute_hessian, compute_kirchhoff, dcc,
                     effector_sensor, eigen, frequencies, linear_response,
                     mean_square_fluctuation, nma, normal_mode, prs)
from .structure import AtomArray, BadStructureError, load_structure
from .ops.spd_linalg import (panel_cholesky_batched, panel_inverse_batched,
                             spd_inverse_blocked)
from .parallel.pipeline import (anm_fluctuations, anm_observables,
                                anm_spectral, ensemble_anm,
                                ensemble_anm_banded,
                                ensemble_anm_fluctuations,
                                ensemble_anm_spectral, ensemble_gnm,
                                ensemble_gnm_banded,
                                ensemble_gnm_fluctuations,
                                ensemble_gnm_spectral, gnm_fluctuations,
                                gnm_observables, gnm_spectral)
from .ops.matfree import (covariance_solve_matfree,
                          covariance_solve_matfree_gnm, dcc_rows_matfree,
                          dcc_rows_matfree_gnm, effector_sensor_from_modes,
                          effector_sensor_matfree,
                          effector_sensor_stochastic, estimate_lambda_max,
                          linear_response_matfree, lowest_modes_matfree,
                          lowest_modes_matfree_gnm, msf_stochastic,
                          msf_stochastic_gnm, prs_diag_from_modes,
                          prs_diag_stochastic, prs_rows_matfree)
from .ops.modes import (lowest_modes, lowest_modes_anm,
                        lowest_modes_shift_invert, refine_modes_f64,
                        refine_modes_f64_gnm)
from .utils.config import resolve_device
from .utils.profiling import synchronize

# Make `import springcraft_tpu_torch.nma` resolve to the models.nma module
# (the reference's flat module layout; the forcefield/anm/gnm/interaction
# aliases are real modules).
import sys as _sys

_sys.modules[__name__ + ".nma"] = nma

__all__ = [
    "__version__",
    "ANM",
    "GNM",
    "compute_kirchhoff",
    "compute_hessian",
    "eigen",
    "frequencies",
    "mean_square_fluctuation",
    "bfactor",
    "dcc",
    "normal_mode",
    "linear_response",
    "prs",
    "effector_sensor",
    "nma",
    "io",
    "ops",
    "parallel",
    "structure",
    "utils",
    "FFParams",
    "PatchOverlay",
    "with_overlay",
    "strip_overlays",
    "from_numpy_params",
    "invariant_params",
    "hinsen_params",
    "pfenm_params",
    "table_pair_params",
    "table_compact_params",
    "ForceField",
    "InvariantForceField",
    "HinsenForceField",
    "ParameterFreeForceField",
    "PatchedForceField",
    "TabulatedForceField",
    "AtomArray",
    "BadStructureError",
    "load_structure",
    "panel_cholesky_batched",
    "panel_inverse_batched",
    "spd_inverse_blocked",
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
    "lowest_modes_matfree",
    "lowest_modes_matfree_gnm",
    "estimate_lambda_max",
    "covariance_solve_matfree",
    "covariance_solve_matfree_gnm",
    "linear_response_matfree",
    "prs_rows_matfree",
    "dcc_rows_matfree",
    "dcc_rows_matfree_gnm",
    "prs_diag_from_modes",
    "effector_sensor_from_modes",
    "effector_sensor_matfree",
    "prs_diag_stochastic",
    "msf_stochastic",
    "msf_stochastic_gnm",
    "effector_sensor_stochastic",
    "lowest_modes",
    "lowest_modes_anm",
    "lowest_modes_shift_invert",
    "refine_modes_f64",
    "refine_modes_f64_gnm",
    "resolve_device",
    "synchronize",
    "kernel_wrappers",
]


def kernel_wrappers():
    """Every kernel wrapper of the port, by kernel name; each keeps its
    launch count in ``.launches``."""
    from .ops.assembly_kernels import (assembly_stitch,
                                       hessian_planes_ensemble,
                                       hessian_xyz_ensemble,
                                       kirchhoff_ensemble, regularize_stitch)
    from .ops.matfree import (hessian_apply_dense, hessian_apply_sparse,
                              kirchhoff_apply_sparse, pair_csr)
    from .ops.spd_linalg import (chol_solve, panel_cholesky,
                                 panel_inverse_batched, panel_inverse_full)
    from .ops.spectrum import banded_bisect, banded_eigvec

    return {
        "hessian_planes": hessian_planes_ensemble,
        "regularize_stitch": regularize_stitch,
        "panel_inverse": panel_inverse_batched,
        "kirchhoff": kirchhoff_ensemble,
        "hessian_xyz": hessian_xyz_ensemble,
        "banded_bisect": banded_bisect,
        "banded_eigvec": banded_eigvec,
        "hessian_apply_dense": hessian_apply_dense,
        "hessian_apply_sparse": hessian_apply_sparse,
        "kirchhoff_apply_sparse": kirchhoff_apply_sparse,
        "pair_csr": pair_csr,
        "assembly_stitch": assembly_stitch,
        "panel_cholesky": panel_cholesky,
        "panel_inverse_full": panel_inverse_full,
        "chol_solve": chol_solve,
    }
