"""Host-side structure layer of the port (numpy only): the ``AtomArray``
container, the PDB, mmCIF and BinaryCIF readers, the PDB writer, residue
masses and the cell list."""

from . import info
from .atoms import (AtomArray, BadStructureError, array, as_atom_array,
                    check_res_id_continuity, concatenate, coord,
                    displacement, distance, filter_amino_acids,
                    get_chain_count, index_displacement,
                    is_atom_array_like)
from .bcif import load_structure_bcif, read_bcif_as_cif
from .celllist import CellList
from .cif import CIFFile, load_structure_cif
from .pdb import (PDBFile, get_structure, load_ensemble, load_structure,
                  write_pdb)

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
    "CIFFile",
    "get_structure",
    "load_structure",
    "load_structure_cif",
    "load_structure_bcif",
    "read_bcif_as_cif",
    "load_ensemble",
    "write_pdb",
    "info",
]
