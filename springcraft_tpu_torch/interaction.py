"""Alias of :mod:`springcraft_tpu_torch.models.interaction` mirroring the
reference's module layout."""

from .models.interaction import compute_hessian, compute_kirchhoff  # noqa: F401

__all__ = ["compute_kirchhoff", "compute_hessian"]
