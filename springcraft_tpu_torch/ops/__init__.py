"""Array-level building blocks of the PyTorch port (counterpart of
``springcraft_tpu/ops``): the same submodules and, at this level, the
same names."""

from . import (
    assembly,
    ffparams,
    linalg,
    matfree,
    modes,
    nma_core,
    pairs,
    rigid,
    spectrum,
)
from .assembly import hessian_matrix, hessian_rows, kirchhoff_matrix
from .ffparams import FFParams, force_constant_matrix, pairwise_sq_distance
from .linalg import eigensystem, eigh, pinvh
from .matfree import (
    covariance_solve_matfree,
    covariance_solve_matfree_gnm,
    dcc_rows_matfree,
    dcc_rows_matfree_gnm,
    effector_sensor_from_modes,
    effector_sensor_matfree,
    effector_sensor_stochastic,
    hessian_apply,
    kirchhoff_apply,
    kirchhoff_degree,
    linear_response_matfree,
    lowest_modes_matfree,
    lowest_modes_matfree_gnm,
    msf_stochastic,
    msf_stochastic_gnm,
    prs_diag_from_modes,
    prs_diag_stochastic,
    prs_rows_matfree,
)
from .modes import lowest_modes, lowest_modes_anm, refine_modes_f64
from .rigid import (
    covariance_cholesky,
    covariance_plane_traces,
    null_mode_gnm,
    rigid_modes_anm,
)
from .spectrum import eigh_banded, eigvalsh_banded

__all__ = [
    "assembly",
    "ffparams",
    "linalg",
    "matfree",
    "modes",
    "hessian_apply",
    "kirchhoff_apply",
    "lowest_modes_matfree",
    "lowest_modes_matfree_gnm",
    "covariance_solve_matfree",
    "covariance_solve_matfree_gnm",
    "linear_response_matfree",
    "dcc_rows_matfree",
    "dcc_rows_matfree_gnm",
    "effector_sensor_from_modes",
    "effector_sensor_matfree",
    "effector_sensor_stochastic",
    "kirchhoff_degree",
    "msf_stochastic",
    "msf_stochastic_gnm",
    "prs_diag_from_modes",
    "prs_diag_stochastic",
    "prs_rows_matfree",
    "nma_core",
    "pairs",
    "rigid",
    "spectrum",
    "eigh_banded",
    "eigvalsh_banded",
    "lowest_modes",
    "lowest_modes_anm",
    "refine_modes_f64",
    "covariance_cholesky",
    "covariance_plane_traces",
    "rigid_modes_anm",
    "null_mode_gnm",
    "FFParams",
    "force_constant_matrix",
    "pairwise_sq_distance",
    "kirchhoff_matrix",
    "hessian_matrix",
    "hessian_rows",
    "eigh",
    "eigensystem",
    "pinvh",
]
