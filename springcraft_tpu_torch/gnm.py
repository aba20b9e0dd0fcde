"""Alias of :mod:`springcraft_tpu_torch.models.gnm` mirroring the
reference's module layout."""

from .models.gnm import GNM  # noqa: F401

__all__ = ["GNM"]
