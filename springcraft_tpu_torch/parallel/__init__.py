"""Batched ensemble pipelines of the PyTorch port (counterpart of
``springcraft_tpu/parallel``)."""

from .pipeline import ensemble_anm_fluctuations, ensemble_gnm_fluctuations

__all__ = ["ensemble_anm_fluctuations", "ensemble_gnm_fluctuations"]
