"""Batched ensemble pipelines of the PyTorch port (counterpart of
``springcraft_tpu/parallel``; its mesh, sharded and blocked multi-device
modules are not ported yet)."""

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

__all__ = [
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
]
