"""
PDB file reader producing :class:`AtomArray` objects.

The reference obtains structures through ``biotite.structure.io.pdb``
(``PDBFile.read`` + ``get_structure(pdb_file, model=1)``, see reference
``tests/test_anm.py:14-18``).  This module provides the same entry points,
backed by a pure-Python column parser; ``.cif``, ``.mmcif`` and ``.bcif``
files (optionally gzipped) go to :mod:`.cif` and :mod:`.bcif`.  This is
the port's own copy of ``springcraft_tpu/structure/pdb.py`` (importing
that package would import ``jax``), without its optional C++ coordinate
parser.  Its :func:`write_pdb` refuses what PDB's fixed columns cannot
hold, where the JAX package's widens or cuts a field without a word.
"""

from __future__ import annotations

import gzip

import numpy as np

from .atoms import AtomArray

__all__ = ["PDBFile", "get_structure", "load_structure",
           "load_ensemble", "write_pdb"]


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


def load_structure(path, model=None):
    """Read a structure file (PDB or mmCIF by extension) and return its
    :class:`AtomArray`."""
    name = str(path)
    if name.endswith((".bcif", ".bcif.gz")):
        from .bcif import load_structure_bcif

        return load_structure_bcif(path, model=model)
    if name.endswith((".cif", ".cif.gz", ".mmcif")):
        from .cif import load_structure_cif

        return load_structure_cif(path, model=model)
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
    name = str(path)
    if name.endswith((".cif", ".cif.gz", ".mmcif", ".bcif", ".bcif.gz")):
        from .cif import CIFFile, get_structure_cif

        if name.endswith((".bcif", ".bcif.gz")):
            from .bcif import read_bcif_as_cif

            cif = read_bcif_as_cif(path)
        else:
            cif = CIFFile.read(path)
        n_models = cif.get_model_count()
        first = get_structure_cif(cif, model=1)
        coords = np.empty((n_models, first.array_length(), 3),
                          dtype=np.float32)
        coords[0] = first.coord
        for m in range(2, n_models + 1):
            model = get_structure_cif(cif, model=m)
            if model.array_length() != first.array_length():
                raise ValueError(
                    f"Model {m} has {model.array_length()} atoms, "
                    f"expected {first.array_length()}"
                )
            coords[m - 1] = model.coord
        return first, coords

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


def _check_pdb_columns(atoms):
    """Raise ``ValueError`` for annotations that PDB's fixed columns
    cannot hold: written anyway, they widen a field (and shift every
    later column of the line) or lose characters."""
    n = atoms.array_length()
    if n > 99_999:
        raise ValueError(f"{n} atoms: the PDB serial column holds at most "
                         f"99,999; write mmCIF or BinaryCIF instead")
    res_id = np.asarray(atoms.res_id, dtype=np.int64)
    if n and (res_id.min() < -999 or res_id.max() > 9999):
        raise ValueError(
            f"residue IDs {int(res_id.min())}..{int(res_id.max())}: the "
            f"PDB residue column holds -999..9999")
    widths = (("chain_id", 1, "chain IDs"), ("atom_name", 4, "atom names"),
              ("res_name", 3, "residue names"))
    for annotation, width, what in widths:
        values = np.asarray(getattr(atoms, annotation)).astype(str)
        longest = int(np.char.str_len(values).max()) if n else 0
        if longest > width:
            raise ValueError(
                f"{what} of {longest} characters: the PDB column holds "
                f"{width}")


def write_pdb(path, atoms, coord_models=None):
    """
    Write an :class:`AtomArray` as a PDB file.

    Parameters
    ----------
    path : str
    atoms : AtomArray
        Template providing the annotations.
    coord_models : ndarray, shape=(m, n, 3), optional
        Per-model coordinates (e.g. a normal-mode trajectory from
        ``ANM.normal_mode`` added to the input structure).  If omitted,
        ``atoms.coord`` is written as a single model.

    Raises
    ------
    ValueError
        For coordinates outside [-999.999, 9999.999], more than 99,999
        atoms, residue IDs outside -999..9999, chain IDs longer than one
        character, atom names longer than four or residue names longer
        than three: PDB's fixed
        columns cannot hold them (mmCIF can).  Inside those limits the
        file is byte for byte the JAX package's.
    """
    if coord_models is None:
        coord_models = np.asarray(atoms.coord)[None]
    coord_models = np.asarray(coord_models)
    if (np.abs(coord_models) >= 10000).any() or (
        coord_models <= -1000
    ).any():
        raise ValueError(
            "Coordinates exceed the PDB fixed-column range "
            "[-999.999, 9999.999]"
        )
    _check_pdb_columns(atoms)
    multi = coord_models.shape[0] > 1

    with open(path, "w") as f:
        for m, coords in enumerate(coord_models, start=1):
            if multi:
                f.write(f"MODEL     {m:4d}\n")
            for i in range(atoms.array_length()):
                name = atoms.atom_name[i]
                # PDB name column convention: 1-char-element names start
                # in column 14
                name_field = f" {name:<3s}" if len(name) < 4 else name
                is_het = "hetero" in atoms._annot and bool(atoms.hetero[i])
                record = "HETATM" if is_het else "ATOM  "
                f.write(
                    f"{record}{i + 1:5d} {name_field:<4s}"
                    f"{atoms.res_name[i]:>4s} "
                    f"{atoms.chain_id[i] or 'A'}"
                    f"{int(atoms.res_id[i]):4d}    "
                    f"{coords[i, 0]:8.3f}{coords[i, 1]:8.3f}"
                    f"{coords[i, 2]:8.3f}"
                    f"{1.00:6.2f}{0.00:6.2f}          "
                    f"{atoms.element[i]:>2s}\n"
                )
            if multi:
                f.write("ENDMDL\n")
        f.write("END\n")
