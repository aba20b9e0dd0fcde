"""
PDB file reader producing :class:`AtomArray` objects.

The reference obtains structures through ``biotite.structure.io.pdb``
(``PDBFile.read`` + ``get_structure(pdb_file, model=1)``, see reference
``tests/test_anm.py:14-18``).  This module provides the same entry points,
backed by a pure-Python column parser.  This is the port's own copy of
``springcraft_tpu/structure/pdb.py`` (importing that package would
import ``jax``); its optional C++ coordinate parser and the mmCIF and
BinaryCIF readers and the PDB writer are not ported (ROADMAP.md).
"""

from __future__ import annotations

import gzip

import numpy as np

from .atoms import AtomArray

__all__ = ["PDBFile", "get_structure", "load_structure", "load_ensemble"]


class PDBFile:
    """Parsed PDB text, split into models of ATOM/HETATM lines."""

    def __init__(self, lines):
        self._lines = lines

    @staticmethod
    def read(path):
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "rt") as f:
            lines = f.read().splitlines()
        return PDBFile(lines)

    def get_model_count(self):
        count = sum(1 for line in self._lines if line.startswith("MODEL"))
        return max(count, 1)

    def get_structure(self, model=None):
        return get_structure(self, model=model)

    @property
    def lines(self):
        return self._lines


def _atom_lines_for_model(lines, model):
    """Collect ATOM/HETATM record lines belonging to the given model."""
    has_models = any(line.startswith("MODEL") for line in lines)
    if not has_models:
        if model not in (None, 1):
            raise ValueError(f"Model {model} does not exist in this file")
        return [ln for ln in lines if ln.startswith(("ATOM", "HETATM"))]

    selected = []
    current = 0
    in_target = False
    for line in lines:
        if line.startswith("MODEL"):
            current += 1
            in_target = current == model
        elif line.startswith("ENDMDL"):
            in_target = False
        elif in_target and line.startswith(("ATOM", "HETATM")):
            selected.append(line)
    if not selected:
        raise ValueError(f"Model {model} does not exist in this file")
    return selected


def _guess_element(atom_name, hetero=False):
    """Infer the element from a PDB atom name when columns 77-78 are
    empty.  Two-letter elements are only trusted for HETATM records —
    a protein atom named ``CA`` is an alpha carbon, not calcium."""
    name = atom_name.strip()
    if not name:
        return ""
    # Hydrogen names may start with a digit (e.g. 1HB2)
    stripped = name.lstrip("0123456789")
    if stripped[:1] in ("H", "D"):
        return "H"
    if hetero and len(name) >= 2 and name[:2].upper() in (
        "FE", "ZN", "MG", "MN", "CU", "NA", "CL", "CA", "BR", "SE"
    ):
        return name[:2].upper()
    return stripped[:1]


def get_structure(pdb_file, model=None):
    """
    Build an :class:`AtomArray` from a :class:`PDBFile`.

    Parameters
    ----------
    pdb_file : PDBFile
        The parsed file.
    model : int, optional
        1-based model number.  If the file contains no ``MODEL`` records,
        the whole file is treated as a single model.  ``None`` selects
        model 1 (only single-model access is supported, matching the
        reference's usage pattern ``get_structure(pdb_file, model=1)``).
    """
    if model is None:
        model = 1
    lines = _atom_lines_for_model(pdb_file.lines, model)

    # Alternate locations (biotite altloc="first" semantics): for each
    # residue, pick the first altloc ID that appears and keep only
    # blank-altloc atoms plus atoms with that ID — never mix
    # conformations within a residue.
    # Key is (chain, resSeq+iCode) only — point microheterogeneity puts
    # different residue *names* in the same slot and must still resolve
    # to one conformer.
    residue_altloc = {}
    for line in lines:
        altloc = line[16] if len(line) > 16 else " "
        if altloc not in (" ", ""):
            res_key = (line[21], line[22:27])
            residue_altloc.setdefault(res_key, altloc)
    if residue_altloc:
        kept = []
        for line in lines:
            altloc = line[16] if len(line) > 16 else " "
            if altloc not in (" ", ""):
                if altloc != residue_altloc[(line[21], line[22:27])]:
                    continue
            kept.append(line)
        lines = kept

    n = len(lines)
    atoms = AtomArray(n)
    chain_id = np.empty(n, dtype="<U4")
    res_id = np.empty(n, dtype=np.int64)
    res_name = np.empty(n, dtype="<U5")
    atom_name = np.empty(n, dtype="<U6")
    element = np.empty(n, dtype="<U2")
    hetero = np.empty(n, dtype=bool)

    for i, line in enumerate(lines):
        # PDB fixed columns (1-based): name 13-16, altLoc 17,
        # resName 18-20, chainID 22, resSeq 23-26, x 31-38, y 39-46,
        # z 47-54, element 77-78
        atom_name[i] = line[12:16].strip()
        res_name[i] = line[17:20].strip()
        chain_id[i] = line[21].strip()
        res_id[i] = int(line[22:26])
        hetero[i] = line.startswith("HETATM")
        elem = line[76:78].strip() if len(line) >= 78 else ""
        element[i] = (elem.upper() if elem
                      else _guess_element(atom_name[i], hetero[i]))

    atoms.coord = _parse_coords(lines)
    atoms.set_annotation("chain_id", chain_id)
    atoms.set_annotation("res_id", res_id)
    atoms.set_annotation("res_name", res_name)
    atoms.set_annotation("atom_name", atom_name)
    atoms.set_annotation("element", element)
    atoms.add_annotation("hetero", bool)
    atoms.set_annotation("hetero", hetero)
    return atoms


def _parse_coords(lines):
    """Coordinate columns of ATOM/HETATM lines."""
    coord = np.empty((len(lines), 3), dtype=np.float32)
    for i, line in enumerate(lines):
        coord[i, 0] = float(line[30:38])
        coord[i, 1] = float(line[38:46])
        coord[i, 2] = float(line[46:54])
    return coord


_CIF_SUFFIXES = (".cif", ".cif.gz", ".mmcif", ".bcif", ".bcif.gz")


def _refuse_cif(path):
    if str(path).endswith(_CIF_SUFFIXES):
        raise NotImplementedError(
            f"{path}: the mmCIF and BinaryCIF readers are not ported "
            f"(ROADMAP.md); the port reads PDB text")


def load_structure(path, model=None):
    """Read a PDB file (optionally gzipped) and return its
    :class:`AtomArray`."""
    _refuse_cif(path)
    return get_structure(PDBFile.read(path), model=model)


def load_ensemble(path):
    """
    Load all models of a multi-model structure file as a conformer
    batch.

    Returns
    -------
    atoms : AtomArray
        Annotations + coordinates of the first model.
    coords : ndarray, shape=(m, n, 3), dtype=float32
        Coordinates of every model — ready for the batched ensemble
        pipelines (``parallel.ensemble_anm``).
    """
    _refuse_cif(path)

    # Single pass over the file: split atom lines at MODEL boundaries,
    # then parse annotations once and coordinates per model (an
    # O(models x lines) re-scan would dwarf the device solve for large
    # ensembles).
    pdb_file = PDBFile.read(path)
    models = []
    current = None
    has_models = False
    for line in pdb_file.lines:
        if line.startswith("MODEL"):
            has_models = True
            current = []
            models.append(current)
        elif line.startswith("ENDMDL"):
            current = None
        elif line.startswith(("ATOM", "HETATM")):
            if current is None:
                if has_models:
                    continue
                current = []
                models.append(current)
            current.append(line)
    if not models:
        raise ValueError("No atom records found")

    first = get_structure(PDBFile(["MODEL     1"] + models[0] + ["ENDMDL"])
                          if has_models else PDBFile(models[0]), model=1)
    coords = np.empty((len(models), first.array_length(), 3),
                      dtype=np.float32)
    coords[0] = first.coord
    for m, lines in enumerate(models[1:], start=1):
        if len(lines) != len(models[0]):
            raise ValueError(
                f"Model {m + 1} has {len(lines)} atom records, expected "
                f"{len(models[0])}"
            )
        coords[m] = _parse_coords(lines)
    return first, coords
