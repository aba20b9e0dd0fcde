"""
springcraft_tpu_torch — the PyTorch/CUDA port of springcraft_tpu.

A second package beside the JAX one (``springcraft_tpu``, the reference
it is held against).  It imports ``torch`` and numpy, never ``jax`` and
never ``springcraft_tpu``.  This slice covers batched fluctuation NMA
over conformer ensembles (:func:`ensemble_anm_fluctuations`) with
hand-written CUDA kernels for Hopper (``csrc/``) on its main path.

Importing the package turns TF32 off for float32 matrix products (see
:mod:`.utils.config`).
"""

from .utils import config  # noqa: F401  (pins float32 precision)
from .ops.ffparams import (FFParams, from_numpy_params, hinsen_params,
                           invariant_params, pfenm_params)
from .parallel.pipeline import (ensemble_anm_fluctuations,
                                ensemble_gnm_fluctuations)
from .utils.config import resolve_device, synchronize

__all__ = [
    "FFParams",
    "from_numpy_params",
    "invariant_params",
    "hinsen_params",
    "pfenm_params",
    "ensemble_anm_fluctuations",
    "ensemble_gnm_fluctuations",
    "resolve_device",
    "synchronize",
    "kernel_wrappers",
]


def kernel_wrappers():
    """The kernel wrappers of the main path, by kernel name; each keeps
    its launch count in ``.launches``."""
    from .ops.assembly_kernels import (hessian_planes_ensemble,
                                       regularize_stitch)
    from .ops.spd_linalg import panel_inverse_batched

    return {
        "hessian_planes": hessian_planes_ensemble,
        "regularize_stitch": regularize_stitch,
        "panel_inverse": panel_inverse_batched,
    }
