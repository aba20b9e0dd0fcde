"""Host-side structure layer of the port (numpy only): the ``AtomArray``
container, the PDB text reader, residue masses and the cell list."""

from . import info
from .atoms import (AtomArray, BadStructureError, array, as_atom_array,
                    check_res_id_continuity, concatenate, coord,
                    displacement, distance, filter_amino_acids,
                    get_chain_count, index_displacement,
                    is_atom_array_like)
from .celllist import CellList
from .pdb import PDBFile, get_structure, load_ensemble, load_structure

__all__ = [
    "AtomArray",
    "BadStructureError",
    "array",
    "as_atom_array",
    "is_atom_array_like",
    "coord",
    "displacement",
    "index_displacement",
    "distance",
    "get_chain_count",
    "check_res_id_continuity",
    "filter_amino_acids",
    "concatenate",
    "CellList",
    "PDBFile",
    "get_structure",
    "load_structure",
    "load_ensemble",
    "info",
]
