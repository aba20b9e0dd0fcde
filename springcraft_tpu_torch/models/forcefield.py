"""
Force fields: spring-constant rules for elastic network models.

The port's own copy of ``springcraft_tpu/models/forcefield.py`` (that
module imports ``jax`` through its package): the abstract ``ForceField``
contract with the vectorized
``force_constant(atom_i, atom_j, sq_distance)``, the analytic families
as thin wrappers over :mod:`..ops.ffparams`, and
:class:`TabulatedForceField` with its table loading and the seven named
parameterizations.  Every force field lowers itself with
:meth:`ForceField.to_params` to the :class:`~..ops.ffparams.FFParams`
the pipelines take; the tabulated one also with
``to_compact_params``, which the assembly kernels evaluate.  The
parameter tables are the package's own data (``data/*.csv``).
:class:`PatchedForceField` wraps any of them with artificial contact
switching and lowers to the wrapped field's parameters plus one dense
:class:`~..ops.ffparams.PatchOverlay`.
"""

from __future__ import annotations

import abc
import numbers
import os

import numpy as np

from ..ops import ffparams
from ..structure.atoms import BadStructureError, as_atom_array

__all__ = [
    "ForceField",
    "InvariantForceField",
    "HinsenForceField",
    "ParameterFreeForceField",
    "PatchedForceField",
    "TabulatedForceField",
    "AA_LIST",
    "AA_TO_INDEX",
]

DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.realpath(__file__))), "data"
)

N_AMINO_ACIDS = 20

# One-letter codes in alphabetical order -> three-letter codes; this is
# the ordering used by all parameter tables (reference
# ``forcefield.py:28-34`` via biotite's protein alphabet).
_ONE_TO_THREE = {
    "A": "ALA", "C": "CYS", "D": "ASP", "E": "GLU", "F": "PHE",
    "G": "GLY", "H": "HIS", "I": "ILE", "K": "LYS", "L": "LEU",
    "M": "MET", "N": "ASN", "P": "PRO", "Q": "GLN", "R": "ARG",
    "S": "SER", "T": "THR", "V": "VAL", "W": "TRP", "Y": "TYR",
}
AA_LIST = [_ONE_TO_THREE[letter] for letter in sorted(_ONE_TO_THREE)]
AA_TO_INDEX = {aa: i for i, aa in enumerate(AA_LIST)}


class ForceField(metaclass=abc.ABCMeta):
    """
    Defines the force constants of the modeled springs between atoms in
    an elastic network model.

    See the reference contract at ``forcefield.py:37-114``: concrete
    classes implement the vectorized :meth:`force_constant` over pair
    index arrays; the optional properties below configure cutoff and
    artificial contact switching.
    """

    @abc.abstractmethod
    def force_constant(self, atom_i, atom_j, sq_distance):
        """
        Force constants for the given interacting atom pairs.

        Parameters
        ----------
        atom_i, atom_j : ndarray, shape=(k,), dtype=int
            Pair index arrays.
        sq_distance : ndarray, shape=(k,), dtype=float
            Squared pair distances.
        """

    @property
    def cutoff_distance(self):
        return None

    @property
    def contact_shutdown(self):
        return None

    @property
    def contact_pair_off(self):
        return None

    @property
    def contact_pair_on(self):
        return None

    @property
    def natoms(self):
        return None

    def to_params(self, natoms=None):
        """
        Lower this force field to the :class:`FFParams` the pipelines
        take, or return ``None`` if the force field can only be
        evaluated through :meth:`force_constant`.
        """
        return None


class InvariantForceField(ForceField):
    """
    Identical force constant (1) for every interaction within the
    mandatory cutoff — the classic ANM/GNM parameterization
    (reference ``forcefield.py:264-289``).
    """

    def __init__(self, cutoff_distance):
        if cutoff_distance is None:
            # 'None' would yield a fully connected network with equal
            # constants, which is unreasonable (reference
            # forcefield.py:277-281)
            raise ValueError("Cutoff distance must be a float")
        self._cutoff_distance = cutoff_distance

    def force_constant(self, atom_i, atom_j, sq_distance):
        return np.ones(len(atom_i))

    @property
    def cutoff_distance(self):
        return self._cutoff_distance

    def to_params(self, natoms=None):
        return ffparams.invariant_params(self._cutoff_distance)


class HinsenForceField(ForceField):
    """
    Hinsen's Amber94-parametrized distance-dependent force field
    (reference ``forcefield.py:292-330``): nearest-neighbour backbone
    pairs (d < 4 A) follow ``860 d - 2390``, all other pairs
    ``128e4 d^-6``; distances are clamped to at least 2.9 A.
    """

    def __init__(self, cutoff_distance=None):
        self._cutoff_distance = cutoff_distance

    def force_constant(self, atom_i, atom_j, sq_distance):
        dist = np.clip(np.sqrt(sq_distance), 2.9, None)
        return np.where(dist < 4.0, dist * 8.6e2 - 2.39e3,
                        dist ** (-6) * 128e4)

    @property
    def cutoff_distance(self):
        return self._cutoff_distance

    def to_params(self, natoms=None):
        return ffparams.hinsen_params(self._cutoff_distance)


class ParameterFreeForceField(ForceField):
    """
    Jernigan-lab parameter-free ANM (pfENM): force constant
    ``1 / d^2``, no cutoff by default
    (reference ``forcefield.py:333-366``).
    """

    def __init__(self, cutoff_distance=None):
        self._cutoff_distance = cutoff_distance

    def force_constant(self, atom_i, atom_j, sq_distance):
        return 1.0 / sq_distance

    @property
    def cutoff_distance(self):
        return self._cutoff_distance

    def to_params(self, natoms=None):
        return ffparams.pfenm_params(self._cutoff_distance)


class PatchedForceField(ForceField):
    """
    Wraps another force field and applies custom changes to selected
    pairs of atoms (reference ``forcefield.py:117-261``): per-atom
    contact shutdown, per-pair switch-off, and per-pair switch-on with
    explicit force constants.
    """

    def __init__(self, force_field, contact_shutdown=None,
                 contact_pair_off=None, contact_pair_on=None,
                 force_constants=None):
        self._force_field = force_field

        def _opt_array(value, dtype=None):
            return None if value is None else np.asarray(value, dtype=dtype)

        self._contact_shutdown = _opt_array(contact_shutdown)
        self._contact_pair_off = _opt_array(contact_pair_off)
        self._contact_pair_on = _opt_array(contact_pair_on)
        self._force_constants = _opt_array(force_constants)

        for indices in (self._contact_shutdown, self._contact_pair_off,
                        self._contact_pair_on):
            _check_indices(force_field.natoms, indices)
        if self._contact_pair_on is not None:
            if self._force_constants is None:
                raise TypeError(
                    "Individual force constants must be given, "
                    "if contacts are turned on"
                )
            if len(self._force_constants) != len(self._contact_pair_on):
                raise IndexError(
                    f"{len(self._force_constants)} force constants were "
                    f"given for {len(self._contact_pair_on)} "
                    f"switched on contact_pairs"
                )
            if (self._contact_pair_on[:, 0]
                    == self._contact_pair_on[:, 1]).any():
                raise ValueError(
                    "Cannot turn on interaction of an atom with itself"
                )

    def force_constant(self, atom_i, atom_j, sq_distance):
        inner = self._force_field
        if inner.cutoff_distance is None:
            constants = np.asarray(
                inner.force_constant(atom_i, atom_j, sq_distance),
                dtype=float,
            )
        else:
            # Pairs beyond the wrapped field's cutoff (possible for
            # switched-on contacts) must not reach the wrapped
            # force_constant (reference forcefield.py:188-195)
            constants = np.zeros(len(sq_distance))
            within = sq_distance <= inner.cutoff_distance**2
            constants[within] = inner.force_constant(
                np.asarray(atom_i)[within], np.asarray(atom_j)[within],
                np.asarray(sq_distance)[within],
            )

        if self._contact_pair_on is None:
            return constants

        # Override constants for patched pairs.  Pairs are matched via
        # sorted encoded keys (i * size + j), symmetrized.
        atom_i = np.asarray(atom_i)
        atom_j = np.asarray(atom_j)
        pi, pj = self._contact_pair_on.T
        size = int(max(pi.max(), pj.max(), atom_i.max(), atom_j.max())) + 1
        keys = np.concatenate([pi * size + pj, pj * size + pi])
        values = np.concatenate([self._force_constants] * 2)
        order = np.argsort(keys, kind="stable")
        keys, values = keys[order], values[order]

        query = atom_i * size + atom_j
        pos = np.searchsorted(keys, query)
        pos_clipped = np.minimum(pos, len(keys) - 1)
        matched = keys[pos_clipped] == query
        return np.where(matched, values[pos_clipped], constants)

    @property
    def cutoff_distance(self):
        return self._force_field.cutoff_distance

    @property
    def contact_shutdown(self):
        return _concat_optional(self._contact_shutdown,
                                self._force_field.contact_shutdown)

    @property
    def contact_pair_off(self):
        return _concat_optional(self._contact_pair_off,
                                self._force_field.contact_pair_off)

    @property
    def contact_pair_on(self):
        return _concat_optional(self._contact_pair_on,
                                self._force_field.contact_pair_on)

    @property
    def natoms(self):
        return self._force_field.natoms

    def to_params(self, natoms=None):
        """The wrapped field's parameters with one more dense overlay.
        A field without an atom count of its own (the analytic ones)
        needs `natoms`; without it the result is ``None``."""
        inner = self._force_field.to_params(natoms=natoms)
        if inner is None:
            return None
        n = natoms if natoms is not None else self.natoms
        if n is None:
            return None

        off_mask = np.zeros((n, n), dtype=bool)
        if self._contact_shutdown is not None:
            off_mask[self._contact_shutdown, :] = True
            off_mask[:, self._contact_shutdown] = True
        if self._contact_pair_off is not None:
            i, j = self._contact_pair_off.T
            off_mask[i, j] = True
            off_mask[j, i] = True

        on_mask = np.zeros((n, n), dtype=bool)
        has_value = np.zeros((n, n), dtype=bool)
        values = np.zeros((n, n), dtype=np.float64)
        if self._contact_pair_on is not None:
            i, j = self._contact_pair_on.T
            on_mask[i, j] = True
            on_mask[j, i] = True
            values[i, j] = self._force_constants
            values[j, i] = self._force_constants
            has_value = on_mask.copy()

        return ffparams.with_overlay(inner, off_mask, on_mask, values,
                                     has_value)


class TabulatedForceField(ForceField):
    """
    Force constants tabulated by amino-acid type pair and distance bin
    (reference ``forcefield.py:369-545``).

    A position-specific ``interaction_matrix`` of shape
    ``(n, n, n_bins)`` is assembled at construction: non-bonded values
    come from `intra_chain` / `inter_chain` depending on chain identity;
    CA atoms with the same chain ID and adjacent residue IDs are treated
    as bonded and take values from `bonded`; the diagonal is zero.

    Parameters mirror the reference; each of `bonded`, `intra_chain`,
    `inter_chain` may be a scalar, a ``(k,)`` per-bin array, a
    ``(20, 20)`` type matrix or a ``(20, 20, k)`` type-and-bin array.
    `cutoff_distance` is a float / ``None`` (single bin) or an ascending
    array of right bin edges.
    """

    def __init__(self, atoms, bonded, intra_chain, inter_chain,
                 cutoff_distance):
        # Duck-typed acceptance: any object with biotite's AtomArray
        # attribute surface works (e.g. a real biotite AtomArray), so
        # reference scripts port with only the import line changed.
        atoms = as_atom_array(atoms)
        if not np.all((atoms.atom_name == "CA") & (atoms.element == "C")):
            raise BadStructureError(
                "AtomArray does not contain exclusively CA atoms"
            )

        self._natoms = atoms.array_length()

        if cutoff_distance is None:
            self._edges = None
            n_bins = 1
        elif isinstance(cutoff_distance, numbers.Real):
            self._edges = np.array([float(cutoff_distance)])
            n_bins = 1
        else:
            self._edges = np.asarray(cutoff_distance)
            if not np.all(np.diff(self._edges) >= 0):
                raise ValueError(
                    "Distance bin edges are not sorted in increasing order"
                )
            n_bins = len(self._edges)
        self._n_bins = n_bins

        self._bonded = _as_type_table(bonded, n_bins)
        self._intra_chain = _as_type_table(intra_chain, n_bins)
        self._inter_chain = _as_type_table(inter_chain, n_bins)

        # Per-atom metadata for both the dense matrix and the compact
        # representation
        bad = [aa for aa in dict.fromkeys(atoms.res_name)
               if aa not in AA_TO_INDEX]
        if bad:
            pos = int(np.flatnonzero(
                np.asarray(atoms.res_name) == bad[0])[0])
            raise BadStructureError(
                f"non-canonical residue(s) {', '.join(map(repr, bad))} "
                f"(first at atom index {pos}); TabulatedForceField "
                f"requires the 20 canonical amino acids — filter "
                f"HETATM/non-standard residues from the CA trace first"
            )
        self._type_idx = np.array(
            [AA_TO_INDEX[aa] for aa in atoms.res_name], dtype=np.int32
        )
        _, self._chain_code = np.unique(atoms.chain_id, return_inverse=True)
        same_chain_next = atoms.chain_id[:-1] == atoms.chain_id[1:]
        adjacent_res = np.diff(atoms.res_id) == 1
        self._bonded_next = np.concatenate(
            [same_chain_next & adjacent_res, [False]]
        )

        # the (n, n, bins) table is built on first use: the compact
        # parameters (to_compact_params) need only the per-atom metadata,
        # and at 10,000 atoms the table alone is 20.8 GB
        self._interaction_matrix = None

    def _build_interaction_matrix(self):
        t = self._type_idx
        ti, tj = t[:, None], t[None, :]
        intra = self._intra_chain[ti, tj]       # (n, n, bins)
        inter = self._inter_chain[ti, tj]
        same_chain = (self._chain_code[:, None]
                      == self._chain_code[None, :])
        matrix = np.where(same_chain[:, :, None], intra, inter)

        bond_i = np.where(self._bonded_next[:-1])[0]
        bonded_vals = self._bonded[t[bond_i], t[bond_i + 1]]
        matrix[bond_i, bond_i + 1] = bonded_vals
        matrix[bond_i + 1, bond_i] = bonded_vals

        n = self._natoms
        matrix[np.arange(n), np.arange(n), :] = 0
        return matrix

    def force_constant(self, atom_i, atom_j, sq_distance):
        if self._edges is None or len(self._edges) == 1:
            return self.interaction_matrix[atom_i, atom_j, 0]
        bin_indices = np.searchsorted(self._edges**2, sq_distance)
        if (bin_indices >= len(self._edges)).any():
            raise ValueError(
                "Atom interactions above cutoff distance are not "
                "allowed in TabulatedForceField"
            )
        return self.interaction_matrix[atom_i, atom_j, bin_indices]

    @property
    def cutoff_distance(self):
        return None if self._edges is None else self._edges[-1]

    @property
    def natoms(self):
        return self._natoms

    @property
    def interaction_matrix(self):
        """The live position-specific table; mutations affect the force
        field (same contract as the reference attribute)."""
        if self._interaction_matrix is None:
            self._interaction_matrix = self._build_interaction_matrix()
        return self._interaction_matrix

    def to_params(self, natoms=None):
        return ffparams.table_pair_params(self.interaction_matrix,
                                          self._edges)

    def to_compact_params(self):
        """
        Memory-light ``table_compact`` parameterization storing only the
        ``(20, 20, bins)`` type tables plus O(n) per-atom metadata — use
        for large systems and ensemble pipelines.  (Reflects the
        construction-time tables; later mutations of
        ``interaction_matrix`` are not visible here.)
        """
        return ffparams.table_compact_params(
            self._type_idx, self._chain_code, self._bonded_next,
            self._bonded, self._intra_chain, self._inter_chain,
            self._edges,
        )

    # -- named parameterizations -------------------------------------------

    @staticmethod
    def s_enm_10(atoms):
        """sENM10 (Dehouck & Mikhailov 2013): type-specific non-bonded
        constants, cutoff 10 A, bonded constant 10 RT/A^2
        (reference ``forcefield.py:547-581``)."""
        fc = _load_matrix("s_enm_10.csv")
        return TabulatedForceField(atoms, 10.0, fc, fc, 10.0)

    @staticmethod
    def s_enm_13(atoms):
        """sENM13 (Dehouck & Mikhailov 2013): type-specific non-bonded
        constants, cutoff 13 A (reference ``forcefield.py:583-616``)."""
        fc = _load_matrix("s_enm_13.csv")
        return TabulatedForceField(atoms, 10.0, fc, fc, 13.0)

    @staticmethod
    def d_enm(atoms):
        """dENM (Dehouck & Mikhailov 2013): distance-bin-specific
        constants over 26 bins, bonded constant 46.83
        (reference ``forcefield.py:618-655``)."""
        fc = _load_matrix("d_enm.csv")
        edges = _load_matrix("d_enm_edges.csv")
        return TabulatedForceField(atoms, 46.83, fc, fc, edges)

    @staticmethod
    def sd_enm(atoms):
        """sdENM (Dehouck & Mikhailov 2013): type- and distance-specific
        constants (26 bins x 20 x 20), scaled by R*T*10; bonded constant
        43.52*R*T*10 (reference ``forcefield.py:657-699``)."""
        raw = _load_matrix("sd_enm.csv").reshape(-1, 20, 20).T
        scale = 0.0083144621 * 300 * 10
        edges = _load_matrix("d_enm_edges.csv")
        return TabulatedForceField(atoms, 43.52 * scale, raw * scale,
                                   raw * scale, edges)

    @staticmethod
    def e_anm(atoms, nonbonded_mean=False):
        """eANM (Hamacher & McCammon 2006): Miyazawa-Jernigan intra-chain
        and Keskin inter-chain parameters, bonded 82 RT/A^2, cutoff 13 A
        (reference ``forcefield.py:701-766``)."""
        intra = _load_matrix("miyazawa.csv")
        inter = _load_matrix("keskin.csv")
        if nonbonded_mean:
            intra = np.full((20, 20), np.average(intra))
            inter = np.full((20, 20), np.average(inter))
        return TabulatedForceField(atoms, 82.0, intra, inter, 13.0)

    @staticmethod
    def e_anm_mj(atoms, nonbonded_mean=False):
        """eANM variant with Miyazawa-Jernigan parameters for both intra-
        and inter-chain contacts (reference ``forcefield.py:768-822``)."""
        table = _load_matrix("miyazawa.csv")
        if nonbonded_mean:
            table = np.full((20, 20), np.average(table))
        return TabulatedForceField(atoms, 82.0, table, table, 13.0)

    @staticmethod
    def e_anm_ke(atoms, nonbonded_mean=False):
        """eANM variant with Keskin parameters for both intra- and
        inter-chain contacts (reference ``forcefield.py:824-876``)."""
        table = _load_matrix("keskin.csv")
        if nonbonded_mean:
            table = np.full((20, 20), np.average(table))
        return TabulatedForceField(atoms, 82.0, table, table, 13.0)


def _concat_optional(first, second):
    if second is None:
        return first
    if first is None:
        # Reference concatenates unconditionally here, which would fail;
        # returning the wrapped field's patches is the useful behavior.
        return second
    return np.concatenate([first, second])


def _check_indices(length, indices):
    """Bounds check for patch index arrays
    (reference ``forcefield.py:953-962``)."""
    if indices is None or length is None:
        return
    flat = np.asarray(indices).flatten()
    out_of_bounds = flat[flat >= length]
    if len(out_of_bounds) > 0:
        raise IndexError(
            f"Index {out_of_bounds[0]} is out of bounds "
            f"for a structure of length {length}"
        )


def _as_type_table(value, n_bins):
    """
    Broadcast scalar / per-bin / per-type / per-type-and-bin input to a
    ``(20, 20, n_bins)`` float32 table, validating shapes and symmetry
    (reference ``_convert_to_matrix``, ``forcefield.py:879-937``).
    """
    if np.isnan(value).any():
        raise IndexError("Array contains NaN elements")

    if isinstance(value, numbers.Number):
        return np.full((N_AMINO_ACIDS, N_AMINO_ACIDS, n_bins), value,
                       dtype=np.float32)

    array = np.asarray(value, dtype=np.float32)
    if array.ndim == 1:
        if len(array) != n_bins:
            raise IndexError(
                f"Array contains {len(array)} elements "
                f"for {n_bins} distance bins"
            )
        return np.broadcast_to(
            array, (N_AMINO_ACIDS, N_AMINO_ACIDS, n_bins)
        ).copy()
    if array.ndim == 2:
        _check_type_matrix(array)
        return np.repeat(array[:, :, None], n_bins, axis=-1)
    if array.ndim == 3:
        _check_type_matrix(array)
        if array.shape[-1] != n_bins:
            raise IndexError(
                f"Array contains {array.shape[-1]} elements "
                f"for {n_bins} distance bins"
            )
        return array
    raise IndexError(
        f"Expected array with at most 3 dimensions, {array.ndim} given"
    )


def _check_type_matrix(matrix):
    if matrix.shape[:2] != (N_AMINO_ACIDS, N_AMINO_ACIDS):
        raise IndexError(
            f"Expected matrix of shape {(N_AMINO_ACIDS, N_AMINO_ACIDS)}, "
            f"got {matrix.shape[:2]}"
        )
    axes = (1, 0, 2) if matrix.ndim == 3 else (1, 0)
    if not np.allclose(matrix, np.transpose(matrix, axes)):
        raise ValueError("Input matrix is not symmetric")


_TABLE_CACHE = {}


def _load_matrix(fname):
    """Memoized CSV parameter-table loader
    (reference ``forcefield.py:940-950``)."""
    if fname not in _TABLE_CACHE:
        _TABLE_CACHE[fname] = np.loadtxt(
            os.path.join(DATA_DIR, fname), delimiter=","
        )
    return _TABLE_CACHE[fname]
