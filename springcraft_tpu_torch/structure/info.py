"""
Chemical reference data: residue and element masses.

The port's own copy of ``springcraft_tpu/structure/info.py`` (numpy
only).  The reference infers per-residue masses with
``biotite.structure.info.mass(res_name, is_residue=True)``
(reference ``anm.py:74-79``, ``gnm.py:70-75``).  Here the 20 canonical
amino-acid residue masses (average isotopic composition, free amino acid
minus one water — i.e. the mass contributed by a residue inside a peptide
chain) are tabulated directly.
"""

from __future__ import annotations

import numpy as np

__all__ = ["mass", "residue_masses", "RESIDUE_MASSES", "ELEMENT_MASSES"]

# Average atomic masses (IUPAC 2021, rounded)
ELEMENT_MASSES = {
    "H": 1.008,
    "C": 12.011,
    "N": 14.007,
    "O": 15.999,
    "S": 32.06,
    "SE": 78.971,
    "P": 30.974,
    "FE": 55.845,
    "ZN": 65.38,
    "MG": 24.305,
    "CA": 40.078,
    "NA": 22.990,
    "CL": 35.45,
    "K": 39.098,
    "MN": 54.938,
    "CU": 63.546,
}

# Average residue masses: free amino acid minus H2O (18.0153)
RESIDUE_MASSES = {
    "ALA": 71.0788,
    "ARG": 156.1875,
    "ASN": 114.1038,
    "ASP": 115.0886,
    "CYS": 103.1388,
    "GLU": 129.1155,
    "GLN": 128.1307,
    "GLY": 57.0519,
    "HIS": 137.1411,
    "ILE": 113.1594,
    "LEU": 113.1594,
    "LYS": 128.1741,
    "MET": 131.1926,
    "PHE": 147.1766,
    "PRO": 97.1167,
    "SER": 87.0782,
    "THR": 101.1051,
    "TRP": 186.2132,
    "TYR": 163.1760,
    "VAL": 99.1326,
    # Common non-canonical residues
    "MSE": 178.091,  # selenomethionine residue
    "HOH": 18.0153,
}


def mass(item, is_residue=None):
    """
    Mass of an element or residue.

    Parameters
    ----------
    item : str
        Element symbol or residue name (three-letter code).
    is_residue : bool, optional
        If ``True``, `item` is interpreted as a residue name and the mass
        of the residue within a peptide chain (free molecule minus water)
        is returned.  If ``False``, `item` is an element symbol.  If
        ``None``, residues are tried first, then elements.

    Returns
    -------
    mass : float
    """
    key = str(item).upper()
    if is_residue is True:
        try:
            return RESIDUE_MASSES[key]
        except KeyError:
            raise KeyError(f"Unknown residue '{item}'")
    if is_residue is False:
        try:
            return ELEMENT_MASSES[key]
        except KeyError:
            raise KeyError(f"Unknown element '{item}'")
    if key in RESIDUE_MASSES:
        return RESIDUE_MASSES[key]
    if key in ELEMENT_MASSES:
        return ELEMENT_MASSES[key]
    raise KeyError(f"Unknown element or residue '{item}'")


def residue_masses(res_names):
    """Vectorized residue-mass lookup for an array of residue names.

    Raises
    ------
    KeyError
        Naming every unknown residue and where it first occurs, so a
        HETATM-bearing structure fails with an actionable message.
    """
    res_names = np.asarray(res_names)
    unknown = [name for name in dict.fromkeys(res_names)
               if str(name).upper() not in RESIDUE_MASSES]
    if unknown:
        pos = int(np.flatnonzero(res_names == unknown[0])[0])
        raise KeyError(
            f"Unknown residue(s) {', '.join(map(repr, map(str, unknown)))} "
            f"(first at atom index {pos}); masses=True needs every "
            f"res_name in the residue-mass table — pass an explicit "
            f"masses array or filter non-standard residues"
        )
    return np.array([mass(name, is_residue=True) for name in res_names])
