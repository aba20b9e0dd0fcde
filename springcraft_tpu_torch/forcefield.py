"""Alias of :mod:`springcraft_tpu_torch.models.forcefield` mirroring the
reference's module layout (``from springcraft.forcefield import ...``
becomes ``from springcraft_tpu_torch.forcefield import ...``)."""

from .models.forcefield import (  # noqa: F401
    AA_LIST,
    AA_TO_INDEX,
    ForceField,
    HinsenForceField,
    InvariantForceField,
    ParameterFreeForceField,
    PatchedForceField,
    TabulatedForceField,
)

__all__ = [
    "ForceField",
    "PatchedForceField",
    "InvariantForceField",
    "HinsenForceField",
    "ParameterFreeForceField",
    "TabulatedForceField",
    "AA_LIST",
    "AA_TO_INDEX",
]
