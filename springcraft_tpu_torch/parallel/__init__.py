"""Batched ensemble pipelines and multi-device execution of the PyTorch
port (counterpart of ``springcraft_tpu/parallel``): the pipelines, the
device mesh, the sharded ensemble and mega-assembly paths and the
distributed blocked Cholesky, all ported."""

from .blocked import (
    blocked_cholesky,
    blocked_solve_lower,
    blocked_solve_lower_t,
    sharded_all_mode_msf,
    sharded_covariance_blocked,
)
from .mesh import ensemble_sharding, make_mesh
from .pipeline import (
    anm_fluctuations,
    anm_observables,
    anm_spectral,
    ensemble_anm,
    ensemble_anm_banded,
    ensemble_anm_fluctuations,
    ensemble_anm_spectral,
    ensemble_gnm,
    ensemble_gnm_banded,
    ensemble_gnm_fluctuations,
    ensemble_gnm_spectral,
    gnm_fluctuations,
    gnm_observables,
    gnm_spectral,
)
from .sharded import (
    ensemble_mean_msf,
    sharded_anm_pipeline,
    sharded_covariance,
    sharded_ensemble_anm,
    sharded_ensemble_anm_banded,
    sharded_ensemble_anm_fluctuations,
    sharded_ensemble_gnm,
    sharded_ensemble_gnm_banded,
    sharded_hessian,
    sharded_hessian_apply,
    sharded_lowest_modes,
    sharded_lowest_modes_matfree,
)

__all__ = [
    "make_mesh",
    "ensemble_sharding",
    "anm_fluctuations",
    "gnm_fluctuations",
    "ensemble_anm_fluctuations",
    "ensemble_gnm_fluctuations",
    "ensemble_gnm_spectral",
    "anm_observables",
    "anm_spectral",
    "ensemble_anm_spectral",
    "gnm_observables",
    "gnm_spectral",
    "ensemble_anm",
    "ensemble_anm_banded",
    "ensemble_gnm",
    "ensemble_gnm_banded",
    "sharded_ensemble_anm",
    "sharded_ensemble_gnm",
    "sharded_ensemble_anm_banded",
    "sharded_ensemble_anm_fluctuations",
    "sharded_ensemble_gnm_banded",
    "sharded_hessian",
    "sharded_hessian_apply",
    "sharded_lowest_modes",
    "sharded_lowest_modes_matfree",
    "sharded_covariance",
    "sharded_covariance_blocked",
    "sharded_all_mode_msf",
    "blocked_cholesky",
    "blocked_solve_lower",
    "blocked_solve_lower_t",
    "sharded_anm_pipeline",
    "ensemble_mean_msf",
]
