"""User-facing model layer of the port: the GNM/ANM classes, force
fields, interaction matrices and NMA functions (the reference-compatible
API surface of ``springcraft_tpu/models``)."""

from . import nma
from .anm import ANM
from .forcefield import (ForceField, HinsenForceField, InvariantForceField,
                         ParameterFreeForceField, PatchedForceField,
                         TabulatedForceField)
from .gnm import GNM
from .interaction import compute_hessian, compute_kirchhoff
from .nma import (bfactor, dcc, effector_sensor, eigen, frequencies,
                  linear_response, mean_square_fluctuation, normal_mode, prs)

__all__ = [
    "ANM",
    "GNM",
    "ForceField",
    "InvariantForceField",
    "HinsenForceField",
    "ParameterFreeForceField",
    "PatchedForceField",
    "TabulatedForceField",
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
]
