"""
Host-side structure model: a minimal, biotite-compatible ``AtomArray``
container plus geometry helpers.

The upstream reference (springcraft) delegates this layer to the external
*biotite* package (see the reference's ``anm.py:10``,
``interaction.py:10``).  biotite is not a dependency of this framework, so
we provide a self-contained, numpy-backed equivalent that covers the API
surface the ENM pipeline needs (the port's own copy of
``springcraft_tpu/structure/atoms.py``: importing that package would
import ``jax``):

* ``AtomArray`` with the annotation categories used by the reference
  (``chain_id``, ``res_id``, ``res_name``, ``atom_name``, ``element``) and
  ``coord``; supports boolean-mask / slice indexing, concatenation with
  ``+`` and ``copy()`` (cf. reference tests ``test_forcefield.py:14-30``).
* ``coord()`` accepting either an ``AtomArray`` or a plain ``(n, 3)``
  ndarray (cf. ``biotite.structure.coord`` used at ``anm.py:63``).
* ``displacement`` / ``index_displacement`` / ``distance`` (used at
  ``interaction.py:162-188``; no periodic box is involved in ENMs).
* chain utilities ``get_chain_count`` / ``check_res_id_continuity``
  (used by reference tests, ``test_anm.py:115-118``).
"""

from __future__ import annotations

import numpy as np

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
]


class BadStructureError(Exception):
    """Raised when a structure does not fulfil the requirements of an
    operation (mirrors ``biotite.structure.BadStructureError``)."""


# Annotation name -> (dtype, default)
_ANNOTATIONS = {
    "chain_id": ("<U4", ""),
    "res_id": (np.int64, 0),
    "res_name": ("<U5", ""),
    "atom_name": ("<U6", ""),
    "element": ("<U2", ""),
    "hetero": (bool, False),
    "ins_code": ("<U1", ""),
    "b_factor": (np.float64, 0.0),
    "occupancy": (np.float64, 1.0),
}

# Standard canonical amino acids (three-letter codes)
AMINO_ACID_NAMES = frozenset(
    [
        "ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
        "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL",
        # common variants treated as amino acids
        "MSE", "SEC", "PYL",
    ]
)


class AtomArray:
    """
    A fixed-length array of atoms with per-atom annotations and
    coordinates, mirroring the parts of ``biotite.structure.AtomArray``
    used by the reference framework.

    Parameters
    ----------
    length : int
        Number of atoms.
    """

    def __init__(self, length):
        self._length = int(length)
        self._annot = {}
        for name in ("chain_id", "res_id", "res_name", "atom_name", "element"):
            dtype, default = _ANNOTATIONS[name]
            self._annot[name] = np.full(self._length, default, dtype=dtype)
        self.coord = np.zeros((self._length, 3), dtype=np.float32)

    # -- annotation access -------------------------------------------------

    def add_annotation(self, name, dtype):
        if name not in self._annot:
            self._annot[name] = np.zeros(self._length, dtype=dtype)

    def set_annotation(self, name, value):
        value = np.asarray(value)
        if len(value) != self._length:
            raise IndexError(
                f"Annotation length {len(value)} does not match "
                f"array length {self._length}"
            )
        self._annot[name] = value

    def get_annotation(self, name):
        return self._annot[name]

    def get_annotation_categories(self):
        return list(self._annot)

    def __getattr__(self, name):
        # Only called when normal lookup fails
        annot = object.__getattribute__(self, "_annot")
        if name in annot:
            return annot[name]
        raise AttributeError(f"AtomArray has no annotation '{name}'")

    def __setattr__(self, name, value):
        if name in ("_length", "_annot"):
            object.__setattr__(self, name, value)
        elif name == "coord":
            value = np.asarray(value)
            if value.ndim != 2 or value.shape[1] != 3:
                raise ValueError(
                    f"Expected coordinates with shape (n,3), got {value.shape}"
                )
            if hasattr(self, "_length") and len(value) != self._length:
                raise IndexError(
                    f"{len(value)} coordinates for {self._length} atoms"
                )
            object.__setattr__(self, name, value)
        elif name in _ANNOTATIONS or (
            hasattr(self, "_annot") and name in self._annot
        ):
            self.set_annotation(name, value)
        else:
            object.__setattr__(self, name, value)

    # -- container protocol ------------------------------------------------

    def array_length(self):
        return self._length

    def __len__(self):
        return self._length

    def __getitem__(self, index):
        if isinstance(index, (int, np.integer)):
            # Single atom view as a plain dict-like record
            return {name: annot[index] for name, annot in self._annot.items()} | {
                "coord": self.coord[index]
            }
        # Slice indexing returns a *view* of the parent coordinates —
        # copy only then (boolean/fancy indexing already copies), so
        # mutations never alias across arrays
        new_coord = self.coord[index]
        if np.shares_memory(new_coord, self.coord):
            new_coord = new_coord.copy()
        new = AtomArray(len(new_coord))
        new.coord = new_coord
        for name, annot in self._annot.items():
            new._annot[name] = annot[index].copy()
        return new

    def __add__(self, other):
        if not isinstance(other, AtomArray):
            return NotImplemented
        return concatenate([self, other])

    def copy(self):
        new = AtomArray(self._length)
        new.coord = self.coord.copy()
        for name, annot in self._annot.items():
            new._annot[name] = annot.copy()
        return new

    def __eq__(self, other):
        if not isinstance(other, AtomArray):
            return NotImplemented
        if self._length != other._length:
            return False
        if not np.array_equal(self.coord, other.coord):
            return False
        if set(self._annot) != set(other._annot):
            return False
        return all(
            np.array_equal(self._annot[n], other._annot[n]) for n in self._annot
        )

    def __repr__(self):
        return f"<AtomArray with {self._length} atoms>"


def concatenate(arrays):
    """Concatenate multiple :class:`AtomArray` objects."""
    arrays = list(arrays)
    total = sum(a.array_length() for a in arrays)
    new = AtomArray(total)
    new.coord = np.concatenate([a.coord for a in arrays], axis=0)
    names = set()
    for a in arrays:
        names.update(a._annot)
    for name in names:
        parts = []
        for a in arrays:
            if name in a._annot:
                parts.append(a._annot[name])
            else:
                dtype, default = _ANNOTATIONS.get(name, (object, None))
                parts.append(np.full(a.array_length(), default, dtype=dtype))
        new._annot[name] = np.concatenate(parts)
    return new


def array(atoms):
    """Build an :class:`AtomArray` from a list of per-atom dicts."""
    new = AtomArray(len(atoms))
    for i, atom in enumerate(atoms):
        new.coord[i] = atom["coord"]
        for name in new._annot:
            if name in atom:
                new._annot[name][i] = atom[name]
    return new


#: Annotation categories the ENM pipeline relies on; an object exposing
#: these plus ``coord`` duck-types the biotite ``AtomArray`` surface.
_REQUIRED_ANNOTATIONS = ("chain_id", "res_id", "res_name", "atom_name",
                         "element")


def is_atom_array_like(obj):
    """
    ``True`` if `obj` duck-types the atom-array surface the ENM pipeline
    needs: an ``(n, 3)`` ``coord`` array plus the five annotation
    categories (``chain_id``, ``res_id``, ``res_name``, ``atom_name``,
    ``element``).  A real ``biotite.structure.AtomArray`` qualifies —
    reference scripts built on biotite work unchanged (cf. reference
    ``anm.py:63``, ``forcefield.py:438-443``).
    """
    if isinstance(obj, AtomArray):
        return True
    c = getattr(obj, "coord", None)
    if c is None:
        return False
    c = np.asarray(c)
    if c.ndim != 2 or c.shape[1] != 3:
        return False  # e.g. a biotite AtomArrayStack ((m, n, 3))
    return all(
        getattr(obj, name, None) is not None
        for name in _REQUIRED_ANNOTATIONS
    )


def as_atom_array(obj):
    """
    Return `obj` as a native :class:`AtomArray` (zero-copy passthrough
    if it already is one), duck-converting any object with biotite's
    ``AtomArray`` attribute surface — annotation arrays plus ``coord``.

    Extra annotation categories are carried over when the source exposes
    biotite's ``get_annotation_categories()`` / ``get_annotation()``.
    """
    if isinstance(obj, AtomArray):
        return obj
    if not is_atom_array_like(obj):
        raise TypeError(
            f"Expected 'AtomArray', not {type(obj).__name__}"
        )
    c = np.asarray(obj.coord)
    new = AtomArray(len(c))
    new.coord = c
    for name in _REQUIRED_ANNOTATIONS:
        new.set_annotation(name, np.asarray(getattr(obj, name)))
    get_cats = getattr(obj, "get_annotation_categories", None)
    if callable(get_cats):
        for name in get_cats():
            if name not in new._annot:
                new.set_annotation(
                    name, np.asarray(obj.get_annotation(name))
                )
    return new


def coord(item):
    """
    Return the coordinates of `item` as an ``(n, 3)`` ndarray.

    Accepts an :class:`AtomArray`, any object with an ``(n, 3)``
    ``coord`` attribute (e.g. a biotite ``AtomArray``), or a plain
    array-like of shape ``(n, 3)`` (mirrors ``biotite.structure.coord``
    used at reference ``anm.py:63``).
    """
    if isinstance(item, AtomArray):
        return item.coord
    c = getattr(item, "coord", None)
    arr = np.asarray(item if c is None else c)
    if arr.ndim != 2 or arr.shape[-1] != 3:
        raise ValueError(f"Expected coordinates with shape (n,3), got {arr.shape}")
    return arr


def displacement(x, y):
    """Displacement vector(s) ``y - x`` (no periodic box), broadcasting."""
    x = np.asarray(x, dtype=np.float64) if not isinstance(x, np.ndarray) else x
    y = np.asarray(y, dtype=np.float64) if not isinstance(y, np.ndarray) else y
    return y - x


def index_displacement(atoms, pairs):
    """Displacement vectors for the given index `pairs`:
    ``coord[pairs[:,1]] - coord[pairs[:,0]]``."""
    c = coord(atoms)
    pairs = np.asarray(pairs)
    return c[pairs[:, 1]] - c[pairs[:, 0]]


def distance(x, y):
    """Euclidean distance between broadcastable coordinate arrays."""
    disp = displacement(x, y)
    return np.sqrt(np.sum(disp * disp, axis=-1))


def get_chain_count(atoms):
    """Number of chains, counted as contiguous runs of equal chain IDs."""
    chain_ids = atoms.chain_id
    if len(chain_ids) == 0:
        return 0
    changes = np.count_nonzero(chain_ids[1:] != chain_ids[:-1])
    return int(changes) + 1

def check_res_id_continuity(atoms):
    """
    Indices of atoms *after* a residue-ID discontinuity, i.e. positions
    ``i`` where ``res_id[i] - res_id[i-1]`` is neither 0 nor 1
    (mirrors ``biotite.structure.check_res_id_continuity``, used by the
    reference sdENM chain-patch test at ``test_anm.py:115-118``).
    """
    res_ids = atoms.res_id
    diff = np.diff(res_ids)
    discontinuity = (diff != 0) & (diff != 1)
    return np.where(discontinuity)[0] + 1


def filter_amino_acids(atoms):
    """Boolean mask selecting atoms belonging to canonical amino acids."""
    return np.isin(atoms.res_name, list(AMINO_ACID_NAMES))
