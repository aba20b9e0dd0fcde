"""Force-field objects of the port (see :mod:`.forcefield`)."""

from .forcefield import (ForceField, HinsenForceField, InvariantForceField,
                         ParameterFreeForceField, PatchedForceField,
                         TabulatedForceField)

__all__ = [
    "ForceField",
    "InvariantForceField",
    "HinsenForceField",
    "ParameterFreeForceField",
    "PatchedForceField",
    "TabulatedForceField",
]
