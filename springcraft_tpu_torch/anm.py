"""Alias of :mod:`springcraft_tpu_torch.models.anm` mirroring the
reference's module layout."""

from .models.anm import ANM  # noqa: F401

__all__ = ["ANM"]
