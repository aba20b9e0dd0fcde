"""Force-field objects of the port (see :mod:`.forcefield`)."""

from .forcefield import (ForceField, HinsenForceField, InvariantForceField,
                         ParameterFreeForceField, TabulatedForceField)

__all__ = [
    "ForceField",
    "InvariantForceField",
    "HinsenForceField",
    "ParameterFreeForceField",
    "TabulatedForceField",
]
