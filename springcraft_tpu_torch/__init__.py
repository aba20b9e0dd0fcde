"""
springcraft_tpu_torch — the PyTorch/CUDA port of springcraft_tpu.

A second package beside the JAX one (``springcraft_tpu``, the reference
it is held against).  It imports ``torch`` and numpy, never ``jax`` and
never ``springcraft_tpu``.  It covers fluctuation NMA without an
eigendecomposition — over conformer ensembles
(:func:`ensemble_anm_fluctuations`, :func:`ensemble_gnm_fluctuations`)
and for one structure (:func:`anm_fluctuations`,
:func:`gnm_fluctuations`), with the covariance and PRS — for the analytic
force fields, with hand-written CUDA kernels for Hopper (``csrc/``) on
its paths; and the spectral pipelines — eigenvalues, frequencies and
mode shapes from a two-stage banded eigensolver
(:func:`ensemble_anm_spectral`, :func:`ensemble_anm_banded`, their GNM
twins, :func:`anm_spectral`, :func:`gnm_spectral`) beside the dense
``torch.linalg.eigh`` route (:func:`ensemble_anm`, :func:`anm_observables`
and their GNM twins).

Importing the package turns TF32 off for float32 matrix products (see
:mod:`.utils.config`).
"""

from .utils import config  # noqa: F401  (pins float32 precision)
from .ops.ffparams import (FFParams, from_numpy_params, hinsen_params,
                           invariant_params, pfenm_params)
from .parallel.pipeline import (anm_fluctuations, anm_observables,
                                anm_spectral, ensemble_anm,
                                ensemble_anm_banded,
                                ensemble_anm_fluctuations,
                                ensemble_anm_spectral, ensemble_gnm,
                                ensemble_gnm_banded,
                                ensemble_gnm_fluctuations,
                                ensemble_gnm_spectral, gnm_fluctuations,
                                gnm_observables, gnm_spectral)
from .utils.config import resolve_device, synchronize

__all__ = [
    "FFParams",
    "from_numpy_params",
    "invariant_params",
    "hinsen_params",
    "pfenm_params",
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
    "resolve_device",
    "synchronize",
    "kernel_wrappers",
]


def kernel_wrappers():
    """Every kernel wrapper of the port, by kernel name; each keeps its
    launch count in ``.launches``."""
    from .ops.assembly_kernels import (hessian_planes_ensemble,
                                       hessian_xyz_ensemble,
                                       kirchhoff_ensemble, regularize_stitch)
    from .ops.spd_linalg import panel_inverse_batched
    from .ops.spectrum import banded_bisect, banded_eigvec

    return {
        "hessian_planes": hessian_planes_ensemble,
        "regularize_stitch": regularize_stitch,
        "panel_inverse": panel_inverse_batched,
        "kirchhoff": kirchhoff_ensemble,
        "hessian_xyz": hessian_xyz_ensemble,
        "banded_bisect": banded_bisect,
        "banded_eigvec": banded_eigvec,
    }
