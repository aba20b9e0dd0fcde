"""
Minimal mmCIF/PDBx reader producing :class:`AtomArray` objects.

Covers the ``atom_site`` loop category — the part needed to load
structures for ENM analysis (the reference gallery loads structures via
``biotite.structure.io.pdbx``, cf. ``doc/examples/scripts/basic_nma.py``).
Handles multi-model files, quoted values, comments, rows wrapping over
multiple lines, and ``;``-delimited text fields; everything beyond
``atom_site`` is ignored.  This is the port's own copy of
``springcraft_tpu/structure/cif.py`` (importing that package would import
``jax``).
"""

from __future__ import annotations

import gzip

import numpy as np

from .atoms import AtomArray

__all__ = ["CIFFile", "get_structure_cif", "load_structure_cif"]


def _tokenize(line):
    """Split an mmCIF data line.  Per the CIF spec a quote only opens a
    quoted string at the *start* of a token (so unquoted primed atom
    names like C1' stay intact), and closes it only when followed by
    whitespace/end."""
    if "'" not in line and '"' not in line:
        return line.split()
    tokens = []
    i, n = 0, len(line)
    while i < n:
        while i < n and line[i].isspace():
            i += 1
        if i >= n:
            break
        quote = line[i] if line[i] in "'\"" else None
        if quote:
            j = i + 1
            while j < n:
                if line[j] == quote and (j + 1 >= n or line[j + 1].isspace()):
                    break
                j += 1
            tokens.append(line[i + 1:j])
            i = j + 1
        else:
            j = i
            while j < n and not line[j].isspace():
                j += 1
            tokens.append(line[i:j])
            i = j
    return tokens


class CIFFile:
    """Parsed ``atom_site`` records of an mmCIF file.

    Storage is columnar (one NumPy array per column) so that numeric
    columns decoded from BinaryCIF stay vectorized end-to-end; the
    row-major constructor is kept for the text reader.
    """

    def __init__(self, columns, rows):
        self._columns = list(columns)
        if rows:
            arr = np.array(rows, dtype=object)
            self._cols = [arr[:, j] for j in range(arr.shape[1])]
        else:
            self._cols = [np.empty(0, dtype=object) for _ in columns]

    @classmethod
    def from_columns(cls, columns, cols):
        """Build directly from per-column arrays (string or numeric)."""
        self = cls.__new__(cls)
        self._columns = list(columns)
        self._cols = [np.asarray(c) for c in cols]
        return self

    @staticmethod
    def read(path):
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "rt") as f:
            lines = f.read().splitlines()

        columns = []
        rows = []
        pending = []  # tokens of a row spanning multiple lines
        in_loop_header = False
        in_atom_site = False
        i, n_lines = 0, len(lines)
        while i < n_lines:
            raw = lines[i]
            # ';'-delimited text field: opens with ';' in column 1 and
            # runs (including blank lines) until a line starting with
            # ';'.  Inside atom_site the whole block is one value; in
            # any other category it is consumed and ignored so its
            # content cannot confuse the state machine.
            if raw.startswith(";"):
                text = [raw[1:]]
                i += 1
                while i < n_lines and not lines[i].startswith(";"):
                    text.append(lines[i])
                    i += 1
                if i >= n_lines:
                    raise ValueError(
                        "Unterminated ';'-delimited text field"
                    )
                i += 1  # closing ';'
                if in_atom_site and not in_loop_header:
                    pending.append("\n".join(text).strip())
                    if len(pending) == len(columns):
                        rows.append(pending)
                        pending = []
                continue
            stripped = raw.strip()
            i += 1
            if not stripped or stripped.startswith("#"):
                if in_atom_site and rows and not pending:
                    in_atom_site = False
                continue
            if stripped == "loop_":
                in_loop_header = True
                columns = []
                in_atom_site = False
                continue
            if in_loop_header and stripped.startswith("_"):
                tag = stripped.split(".", 1)
                if tag[0] == "_atom_site":
                    columns.append(tag[1].split()[0])
                    in_atom_site = True
                else:
                    in_atom_site = False
                continue
            in_loop_header = False
            if in_atom_site:
                if stripped.startswith(("_", "loop_", "data_")):
                    in_atom_site = False
                    continue
                pending.extend(_tokenize(stripped))
                if len(pending) == len(columns):
                    rows.append(pending)
                    pending = []
                elif len(pending) > len(columns):
                    raise ValueError(
                        f"atom_site row has {len(pending)} values for "
                        f"{len(columns)} columns: {stripped[:60]!r}"
                    )
        if pending:
            raise ValueError(
                f"Incomplete final atom_site row: {len(pending)} values "
                f"for {len(columns)} columns"
            )
        return CIFFile(columns, rows)

    def get_model_count(self):
        col = self._column("pdbx_PDB_model_num")
        if col is None:
            return 1
        return len(np.unique(col))

    def _column(self, name):
        try:
            return self._cols[self._columns.index(name)]
        except ValueError:
            return None

    def get_structure(self, model=None):
        return get_structure_cif(self, model=model)


def _pick(cif, *names):
    for name in names:
        col = cif._column(name)
        if col is not None:
            return col
    return None


def _as_int(col, *, blank_to=None):
    """Vectorized int conversion tolerating '.'/'?' blanks when
    `blank_to` is given."""
    col = np.asarray(col)
    if col.dtype.kind in "OUS":
        s = col.astype("U16")
        if blank_to is not None:
            s = np.where(np.isin(s, (".", "?", "")), str(blank_to), s)
        return s.astype(np.int64)
    return col.astype(np.int64)


def get_structure_cif(cif, model=None):
    """Build an :class:`AtomArray` from a :class:`CIFFile` (1-based
    `model`, defaulting to the first).  Fully vectorized — columns stay
    NumPy arrays from decode to annotation."""
    n_total = len(cif._cols[0]) if cif._cols else 0
    keep = np.ones(n_total, dtype=bool)

    model_col = cif._column("pdbx_PDB_model_num")
    if model_col is not None:
        mvals = _as_int(model_col, blank_to=1)
        model_ids = np.unique(mvals)
        wanted = model_ids[(model or 1) - 1]
        keep &= mvals == wanted
    elif model not in (None, 1):
        raise ValueError(f"Model {model} does not exist in this file")

    chain_col = _pick(cif, "auth_asym_id", "label_asym_id")
    seq_col = _pick(cif, "auth_seq_id", "label_seq_id")

    # Alternate locations (label_alt_id): first altloc ID per residue
    # wins; blank-altloc ('.'/'?') atoms always kept — mirrors the PDB
    # reader so .cif and .pdb of the same structure load identically.
    alt_col = cif._column("label_alt_id")
    if alt_col is not None and n_total:
        alt = np.asarray(alt_col).astype("U4")
        blank = np.isin(alt, (".", "?", ""))
        if not (blank | ~keep).all():
            chain_s = (np.asarray(chain_col).astype("U16")
                       if chain_col is not None
                       else np.full(n_total, "", dtype="U1"))
            seq_s = (np.asarray(seq_col).astype("U16")
                     if seq_col is not None
                     else np.full(n_total, "", dtype="U1"))
            res_key = np.char.add(np.char.add(chain_s, "|"), seq_s)
            uniq, inv = np.unique(res_key, return_inverse=True)
            # first non-blank altloc per residue wins: assign in
            # reverse order so the earliest occurrence overwrites last
            nb = np.flatnonzero(~blank & keep)[::-1]
            first_alt = np.zeros(len(uniq), dtype=alt.dtype)
            first_alt[inv[nb]] = alt[nb]
            keep &= blank | (alt == first_alt[inv])

    cols = {
        "res_name": _pick(cif, "auth_comp_id", "label_comp_id"),
        "atom_name": _pick(cif, "auth_atom_id", "label_atom_id"),
        "element": _pick(cif, "type_symbol"),
        "x": _pick(cif, "Cartn_x"),
        "y": _pick(cif, "Cartn_y"),
        "z": _pick(cif, "Cartn_z"),
        "record": _pick(cif, "group_PDB"),
    }
    for required in ("x", "y", "z", "atom_name", "res_name"):
        if cols[required] is None:
            raise ValueError(f"atom_site is missing required column "
                             f"for '{required}'")

    n = int(keep.sum())
    if n == 0:
        raise ValueError("No atom_site records found")
    atoms = AtomArray(n)

    def _f32(col):
        col = np.asarray(col)[keep]
        if col.dtype.kind in "OUS":
            col = col.astype("U24")
        return col.astype(np.float32)

    coord = np.stack(
        [_f32(cols["x"]), _f32(cols["y"]), _f32(cols["z"])], axis=1)
    chain_id = (np.asarray(chain_col)[keep].astype("U4")
                if chain_col is not None
                else np.full(n, "A", dtype="U4"))
    res_id = (_as_int(np.asarray(seq_col)[keep], blank_to=0)
              if seq_col is not None
              else np.zeros(n, dtype=np.int64))
    res_name = np.asarray(cols["res_name"])[keep].astype("U5")
    atom_name = np.asarray(cols["atom_name"])[keep].astype("U6")
    element = (np.char.upper(
        np.asarray(cols["element"])[keep].astype("U2"))
        if cols["element"] is not None else np.full(n, "", dtype="U2"))
    hetero = (np.asarray(cols["record"])[keep].astype("U6") == "HETATM"
              if cols["record"] is not None else np.zeros(n, dtype=bool))

    atoms.coord = coord
    atoms.set_annotation("chain_id", chain_id)
    atoms.set_annotation("res_id", res_id)
    atoms.set_annotation("res_name", res_name)
    atoms.set_annotation("atom_name", atom_name)
    atoms.set_annotation("element", element)
    atoms.add_annotation("hetero", bool)
    atoms.set_annotation("hetero", hetero)
    return atoms


def load_structure_cif(path, model=None):
    return get_structure_cif(CIFFile.read(path), model=model)
