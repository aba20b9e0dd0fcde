"""
Force-field parameters for the PyTorch port: the analytic families and
the two tabulated ones, and patch overlays on top of any of them.

Counterpart of ``springcraft_tpu/ops/ffparams.py:63-485`` (the
``FFParams`` record with its ``PatchOverlay`` entries, its constructors,
the dense spring-constant rules with :func:`pairwise_sq_distance` and
:func:`force_constant_matrix`, and the sparse per-pair overlay
correction) and of ``springcraft_tpu/ops/pallas_kernels.py:95-185`` (the
rules the assembly kernels evaluate).  The port cannot import the JAX
package (its ``ffparams`` imports ``jax``), so :func:`from_numpy_params`
carries a JAX ``FFParams`` across as a plain dict of its fields.

Families:

* ``invariant``, ``hinsen``, ``pfenm`` — analytic rules
  (:func:`analytic_constants`);
* ``table_compact`` — ``(20, 20, bins)`` type tables for bonded,
  intra-chain and inter-chain pairs plus per-atom type, chain and bond
  flags; the assembly kernels look a pair up on the fly;
* ``table_pair`` — a position-specific ``(n, n, bins)`` table, evaluated
  by the plain versions only (as the JAX package leaves it to XLA).

The array fields stay numpy arrays on the host; :meth:`FFParams.device_tables`
moves what a lookup needs to a device and dtype, once per pair of them.

The bin of a pair is the number of squared edges strictly below its
squared distance, clipped to ``n_bins - 1``, with the edges rounded to
the working dtype: in float32 that is the rule of the TPU kernels
(``pallas_kernels.py:146-149``), in float64 that of the dense route
(``ffparams.py:400``).

A :class:`PatchOverlay` is the dense form of ``PatchedForceField``
contact switching: four ``(n, n)`` numpy arrays on top of any base
family.  The dense plain assembly applies them through the full
adjacency and value pipeline; every kernel path runs the base family
(:func:`strip_overlays`) and adds the sparse correction
``k_patched - k_base`` over the pairs an overlay can touch
(:func:`overlay_pair_delta`).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = [
    "FFParams",
    "PatchOverlay",
    "with_overlay",
    "strip_overlays",
    "overlay_candidate_pairs",
    "pair_base_constants",
    "overlay_pair_delta",
    "effective_adjacency",
    "force_constants",
    "pairwise_sq_distance",
    "squared_norm",
    "force_constant_matrix",
    "ANALYTIC_KINDS",
    "TABLE_KINDS",
    "KERNEL_KINDS",
    "N_TYPES",
    "invariant_params",
    "hinsen_params",
    "pfenm_params",
    "table_pair_params",
    "table_compact_params",
    "analytic_constants",
    "base_constants",
    "rect_base_constants",
    "pack_atom_code",
    "from_numpy_params",
]

_INF = math.inf

#: Families with an analytic spring-constant rule.
ANALYTIC_KINDS = ("invariant", "hinsen", "pfenm")
#: Tabulated families.
TABLE_KINDS = ("table_pair", "table_compact")
#: Families the assembly kernels evaluate, in the order of their codes.
KERNEL_KINDS = ANALYTIC_KINDS + ("table_compact",)

#: Amino-acid types of a type table.
N_TYPES = 20
#: Contexts of the stacked tables, in this order.
_CONTEXTS = ("intra_table", "inter_table", "bonded_table")

_ARRAY_FIELDS = ("pair_table", "type_idx", "chain_code", "bonded_next",
                 "intra_table", "inter_table", "bonded_table")
_COMPACT_FIELDS = _ARRAY_FIELDS[1:]
_OVERLAY_FIELDS = ("off_mask", "on_mask", "values", "has_value")


@dataclasses.dataclass(frozen=True, eq=False)
class PatchOverlay:
    """Dense form of ``PatchedForceField`` contact switching: ``(n, n)``
    numpy arrays in atom order."""

    off_mask: np.ndarray    # bool: contacts forced off
    on_mask: np.ndarray     # bool: contacts forced on
    values: np.ndarray      # force-constant overrides where `has_value`
    has_value: np.ndarray   # bool: positions with an override value

    def __post_init__(self):
        shape = np.shape(self.off_mask)
        if len(shape) != 2 or shape[0] != shape[1] or any(
                np.shape(getattr(self, f)) != shape
                for f in _OVERLAY_FIELDS):
            raise ValueError(
                "a patch overlay is four (n, n) arrays, got shapes "
                f"{[np.shape(getattr(self, f)) for f in _OVERLAY_FIELDS]}")

    def __eq__(self, other):
        if not isinstance(other, PatchOverlay):
            return NotImplemented
        return all(np.array_equal(getattr(self, f), getattr(other, f))
                   for f in _OVERLAY_FIELDS)

    __hash__ = None

    def permuted(self, perm):
        """The overlay of the atoms reordered by `perm` (slot ``i`` holds
        atom ``perm[i]``)."""
        return PatchOverlay(*(getattr(self, f)[perm][:, perm]
                              for f in _OVERLAY_FIELDS))


@dataclasses.dataclass(frozen=True, eq=False)
class FFParams:
    """One force-field family: its tag, bin count, squared cutoff
    (``inf`` means no cutoff), squared right bin edges and, for the
    tabulated families, its numpy tables."""

    kind: str
    n_bins: int = 1
    cutoff_sq: float = _INF
    edges_sq: tuple | None = None

    # table_pair: (n, n, bins) force constants per pair and bin
    pair_table: np.ndarray | None = None

    # table_compact
    type_idx: np.ndarray | None = None      # (n,) int32 amino-acid type
    chain_code: np.ndarray | None = None    # (n,) int32 chain id code
    bonded_next: np.ndarray | None = None   # (n,) bool, i bonded to i + 1
    intra_table: np.ndarray | None = None   # (20, 20, bins)
    inter_table: np.ndarray | None = None   # (20, 20, bins)
    bonded_table: np.ndarray | None = None  # (20, 20, bins)

    # patch overlays, applied innermost first
    overlays: tuple = ()

    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        if self.kind not in ANALYTIC_KINDS + TABLE_KINDS:
            raise ValueError(
                f"unknown force-field kind {self.kind!r}; the port covers "
                f"{ANALYTIC_KINDS + TABLE_KINDS}")
        needed = {"table_pair": _ARRAY_FIELDS[:1],
                  "table_compact": _COMPACT_FIELDS}.get(self.kind, ())
        given = tuple(f for f in _ARRAY_FIELDS
                      if getattr(self, f) is not None)
        if given != tuple(needed):
            raise ValueError(f"family {self.kind!r} carries the array "
                             f"fields {tuple(needed)}, got {given}")
        if not all(isinstance(o, PatchOverlay) for o in self.overlays):
            raise TypeError("overlays must be PatchOverlay entries (see "
                            "with_overlay)")
        sizes = {o.off_mask.shape[0] for o in self.overlays}
        if self.n_atoms is not None:
            sizes.add(self.n_atoms)
        if len(sizes) > 1:
            raise ValueError(f"overlays and tables were built for "
                             f"different atom counts {sorted(sizes)}")

    def _scalars(self):
        return self.kind, self.n_bins, self.cutoff_sq, self.edges_sq

    def __eq__(self, other):
        if not isinstance(other, FFParams):
            return NotImplemented
        return self._scalars() == other._scalars() and all(
            np.array_equal(getattr(self, f), getattr(other, f))
            for f in _ARRAY_FIELDS if getattr(self, f) is not None
            or getattr(other, f) is not None) \
            and self.overlays == other.overlays

    def __hash__(self):
        return hash(self._scalars())

    @property
    def has_cutoff(self):
        return self.cutoff_sq != _INF

    @property
    def kind_code(self):
        """Integer tag of the family, as the assembly kernels take it."""
        if self.kind not in KERNEL_KINDS:
            raise ValueError(f"family {self.kind!r} has no kernel; its "
                             f"matrices come from the plain versions")
        return KERNEL_KINDS.index(self.kind)

    @property
    def n_atoms(self):
        """Atoms the tables or overlays were built for (``None``: any)."""
        if self.kind == "table_pair":
            return self.pair_table.shape[0]
        if self.kind == "table_compact":
            return self.type_idx.shape[0]
        if self.overlays:
            return self.overlays[0].off_mask.shape[0]
        return None

    def replace(self, **changes):
        """A copy with `changes`, and device tensors of its own."""
        return dataclasses.replace(self, _cache={}, **changes)

    def permuted(self, perm):
        """The parameters of the atoms reordered by `perm` (slot ``i``
        holds atom ``perm[i]``): per-atom codes and overlay masks follow
        their atoms.  The bonded test of ``table_compact`` is positional,
        so lookups on the result need the original positions (``pos=``).
        """
        if self.kind == "table_pair":
            raise ValueError("table_pair parameters are not reordered "
                             "(the matrix-free path does not take them)")
        changes = {}
        if self.kind == "table_compact":
            changes = {f: getattr(self, f)[perm]
                       for f in ("type_idx", "chain_code", "bonded_next")}
        return self.replace(overlays=tuple(o.permuted(perm)
                                           for o in self.overlays),
                            **changes)

    def _check_atoms(self, n):
        if self.n_atoms is not None and self.n_atoms != n:
            raise ValueError(f"force field was built for {self.n_atoms} "
                             f"atoms, coordinates have {n}")

    def device_tables(self, device, dtype):
        """What a table lookup needs as tensors on `device`, made once
        per device and dtype: ``edges`` ``(n_edges,)`` in `dtype`, and
        for ``table_compact`` the stacked ``tables`` ``(bins, 3, 20, 20)``
        (intra, inter, bonded) in `dtype` with the packed per-atom
        ``code`` ``(n,)`` int32 (:func:`pack_atom_code`), for
        ``table_pair`` the ``pair_table`` in `dtype`."""
        device = torch.device(device)
        key = (device, dtype)
        if key not in self._cache:
            out = {"edges": torch.tensor(
                self.edges_sq if self.edges_sq is not None else (),
                dtype=torch.float64).to(dtype).to(device)}
            if self.kind == "table_compact":
                stacked = np.stack([
                    np.moveaxis(np.asarray(getattr(self, f)), -1, 0)
                    for f in _CONTEXTS], axis=1)     # (bins, 3, 20, 20)
                out["tables"] = torch.from_numpy(
                    np.ascontiguousarray(stacked)).to(dtype).to(device)
                out["code"] = torch.from_numpy(pack_atom_code(
                    self.type_idx, self.chain_code,
                    self.bonded_next)).to(device)
            elif self.kind == "table_pair":
                out["pair_table"] = torch.from_numpy(np.ascontiguousarray(
                    self.pair_table)).to(dtype).to(device)
            self._cache[key] = out
        return self._cache[key]

    def device_overlays(self, device, dtype):
        """The overlays as tensors on `device`, made once per device and
        dtype: the dense ``off_any`` / ``on_any`` ``(n, n)`` masks, the
        ``layers`` ``[(has_value, values), ...]`` of the value pipeline,
        and the same restricted to the candidate pairs ``ii``, ``jj``
        (``pair_off``, ``pair_on``, ``pair_layers``)."""
        device = torch.device(device)
        key = ("overlays", device, dtype)
        if key not in self._cache:
            ii, jj = overlay_candidate_pairs(self)
            off_any = np.logical_or.reduce([o.off_mask
                                            for o in self.overlays])
            on_any = np.logical_or.reduce([o.on_mask for o in self.overlays])

            def dev(a, dt=None):
                return torch.from_numpy(np.ascontiguousarray(a)).to(
                    device=device, dtype=dt)

            self._cache[key] = {
                "off_any": dev(off_any), "on_any": dev(on_any),
                "layers": [(dev(o.has_value), dev(o.values, dtype))
                           for o in self.overlays],
                "ii": dev(ii.astype(np.int64)),
                "jj": dev(jj.astype(np.int64)),
                "pair_off": dev(off_any[ii, jj]),
                "pair_on": dev(on_any[ii, jj]),
                "pair_layers": [(dev(o.has_value[ii, jj]),
                                 dev(o.values[ii, jj], dtype))
                                for o in self.overlays],
            }
        return self._cache[key]


def pack_atom_code(type_idx, chain_code, bonded_next):
    """One int32 per atom, as the assembly kernels stage it: the type in
    bits 0-4, the bonded-to-next flag in bit 5, the chain code from
    bit 6 up."""
    return (np.asarray(type_idx, dtype=np.int32)
            | (np.asarray(bonded_next, dtype=np.int32) << 5)
            | (np.asarray(chain_code, dtype=np.int32) << 6))


def invariant_params(cutoff_distance):
    """Unit force constant within `cutoff_distance` (mandatory)."""
    if cutoff_distance is None:
        raise ValueError("Cutoff distance must be a float")
    return FFParams(kind="invariant", cutoff_sq=float(cutoff_distance) ** 2)


def hinsen_params(cutoff_distance=None):
    cutoff_sq = _INF if cutoff_distance is None \
        else float(cutoff_distance) ** 2
    return FFParams(kind="hinsen", cutoff_sq=cutoff_sq)


def pfenm_params(cutoff_distance=None):
    cutoff_sq = _INF if cutoff_distance is None \
        else float(cutoff_distance) ** 2
    return FFParams(kind="pfenm", cutoff_sq=cutoff_sq)


def _edges_fields(edges):
    """``(cutoff_sq, edges_sq)`` of right bin edges given as distances
    (``None``: one bin, no cutoff)."""
    if edges is None:
        return _INF, None
    edges = np.asarray(edges, dtype=np.float64)
    return float(edges[-1]) ** 2, tuple(float(e) ** 2 for e in edges)


def table_pair_params(pair_table, edges):
    """Position-specific tabulated force field: `pair_table`
    ``(n, n, bins)`` (diagonal zero) and the right bin `edges`
    ``(bins,)`` as distances, or ``None`` for a single bin without a
    cutoff."""
    pair_table = np.asarray(pair_table)
    cutoff_sq, edges_sq = _edges_fields(edges)
    return FFParams(kind="table_pair", n_bins=pair_table.shape[-1],
                    cutoff_sq=cutoff_sq, edges_sq=edges_sq,
                    pair_table=pair_table)


def table_compact_params(type_idx, chain_code, bonded_next,
                         bonded_table, intra_table, inter_table, edges):
    """Compact tabulated force field: O(n) per-atom metadata plus
    ``(20, 20, bins)`` type tables."""
    intra_table = np.asarray(intra_table)
    cutoff_sq, edges_sq = _edges_fields(edges)
    return FFParams(
        kind="table_compact", n_bins=intra_table.shape[-1],
        cutoff_sq=cutoff_sq, edges_sq=edges_sq,
        type_idx=np.asarray(type_idx, dtype=np.int32),
        chain_code=np.asarray(chain_code, dtype=np.int32),
        bonded_next=np.asarray(bonded_next, dtype=bool),
        intra_table=intra_table,
        inter_table=np.asarray(inter_table),
        bonded_table=np.asarray(bonded_table),
    )


def analytic_constants(kind, sq):
    """Unmasked spring constants of an analytic family for squared
    distances `sq`, with the rules and constants of the JAX assembly
    kernels (reference ``forcefield.py:264-366``)."""
    # `scalar / tensor` would run as reciprocal-then-multiply in
    # PyTorch; a 0-d tensor numerator keeps the true division
    if kind == "invariant":
        return torch.ones_like(sq)
    if kind == "hinsen":
        dist = torch.clamp(torch.sqrt(sq), min=2.9)
        return torch.where(dist < 4.0, dist * 8.6e2 - 2.39e3,
                           sq.new_tensor(1.28e6) / (sq * sq * sq))
    if kind == "pfenm":
        return sq.new_tensor(1.0) / torch.where(sq == 0,
                                                torch.ones_like(sq), sq)
    raise NotImplementedError(kind)


def _bin_indices(sq, params, edges):
    """Distance bin of every pair, ``min(#{edges < sq}, n_bins - 1)``,
    or ``None`` for a single bin."""
    if params.edges_sq is None or params.n_bins == 1:
        return None
    return torch.bucketize(sq, edges).clamp_(max=params.n_bins - 1)


def _compact_offsets(code_p, code_q, pos_p, pos_q):
    """Offsets ``(context * 20 + type_p) * 20 + type_q`` into one bin of
    the stacked tables for pairs of packed atom codes at the array
    positions `pos_p`, `pos_q` (broadcast against each other): bonded for
    neighbours in the array whose lower one is flagged, else intra-chain
    for equal chain codes, else inter-chain."""
    gap = pos_q - pos_p
    bonded = ((gap == 1) & ((code_p >> 5) & 1 != 0)) \
        | ((gap == -1) & ((code_q >> 5) & 1 != 0))
    context = torch.where((code_p >> 6) == (code_q >> 6), 0, 1)
    context = torch.where(bonded, 2, context)
    return (context * N_TYPES + (code_p & 31).long()) * N_TYPES \
        + (code_q & 31).long()


def _network_bins(params, sq, net_sq):
    """Distance bin of every pair at squared distances `sq`, decided on
    `net_sq` (``None``: on `sq`) against the edges in its own dtype: the
    bins of the network that a matrix was assembled on, where the values
    are wanted in another precision."""
    decide = sq if net_sq is None else net_sq
    return _bin_indices(decide, params, params.device_tables(
        decide.device, decide.dtype)["edges"])


def _compact_lookup(params, sq, dev, offsets, net_sq=None):
    """The stacked tables at `offsets` in the distance bin of `sq` (of
    `net_sq`, if given)."""
    bins = _network_bins(params, sq, net_sq)
    if bins is not None:
        offsets = offsets + bins * (3 * N_TYPES * N_TYPES)
    return dev["tables"].reshape(-1)[offsets.expand(sq.shape)]


def base_constants(params, sq):
    """Unmasked spring constants ``(..., n, n)`` of the base family
    (overlays aside) for the squared distances `sq` ``(..., n, n)`` of
    all pairs of one protein: the plain version of the kernels' rules and
    of their table lookup."""
    if params.kind in ANALYTIC_KINDS:
        return analytic_constants(params.kind, sq)
    n = sq.shape[-1]
    params._check_atoms(n)
    dev = params.device_tables(sq.device, sq.dtype)
    if params.kind == "table_compact":
        idx = torch.arange(n, device=sq.device)
        code = dev["code"]
        return _compact_lookup(params, sq, dev, _compact_offsets(
            code[:, None], code[None, :], idx[:, None], idx[None, :]))
    bins = _bin_indices(sq, params, dev["edges"])
    offset = torch.arange(n * n, device=sq.device).reshape(n, n) \
        * params.n_bins
    index = offset.expand(sq.shape) if bins is None else bins + offset
    return dev["pair_table"].reshape(-1)[index]


def rect_base_constants(params, sq, rows, cols, row_pos=None, col_pos=None,
                        net_sq=None):
    """Unmasked spring constants ``(R, C)`` of an analytic or
    ``table_compact`` base family for a rectangular block of pairs: `sq`
    ``(R, C)``, `rows` ``(R,)`` and `cols` ``(C,)`` the slots of the
    atoms (index into the per-atom codes; slots past the last atom read
    atom 0 and must be masked by the caller), `row_pos` / `col_pos`
    their original array positions for the bonded test where the atoms
    were reordered (default: the slots), `net_sq` the squared distances
    that decide the bins (default `sq`)."""
    if params.kind in ANALYTIC_KINDS:
        return analytic_constants(params.kind, sq)
    if params.kind != "table_compact":
        raise ValueError(f"no per-atom lookup for kind={params.kind!r}")
    dev = params.device_tables(sq.device, sq.dtype)
    n = dev["code"].shape[0]
    code_r = dev["code"][torch.where(rows < n, rows, 0)]
    code_c = dev["code"][torch.where(cols < n, cols, 0)]
    row_pos = rows if row_pos is None else row_pos
    col_pos = cols if col_pos is None else col_pos
    return _compact_lookup(params, sq, dev, _compact_offsets(
        code_r[:, None], code_c[None, :], row_pos[:, None],
        col_pos[None, :]), net_sq)


# ---------------------------------------------------------------------------
# Patch overlays
# ---------------------------------------------------------------------------

def with_overlay(params, off_mask, on_mask, values, has_value):
    """`params` with one more (outer) patch overlay."""
    overlay = PatchOverlay(
        off_mask=np.asarray(off_mask, dtype=bool),
        on_mask=np.asarray(on_mask, dtype=bool),
        values=np.asarray(values),
        has_value=np.asarray(has_value, dtype=bool))
    return params.replace(overlays=params.overlays + (overlay,))


def strip_overlays(params):
    """`params` without its patch overlays (the base family).  The
    result is kept, so its device tables are made once."""
    if not params.overlays:
        return params
    if "stripped" not in params._cache:
        params._cache["stripped"] = params.replace(overlays=())
    return params._cache["stripped"]


def overlay_candidate_pairs(params):
    """Upper-triangle pair indices ``(ii, jj)`` (int32 numpy) of every
    pair any overlay could touch: the support of the sparse correction
    behind the kernels."""
    if not params.overlays:
        return np.empty(0, np.int32), np.empty(0, np.int32)
    if "pairs" not in params._cache:
        union = np.zeros_like(params.overlays[0].off_mask, dtype=bool)
        for o in params.overlays:
            union |= o.off_mask | o.on_mask | o.has_value
        ii, jj = np.nonzero(np.triu(union, 1))
        params._cache["pairs"] = ii.astype(np.int32), jj.astype(np.int32)
    return params._cache["pairs"]


def pair_base_constants(ii, jj, sq, params, pos_i=None, pos_j=None,
                        net_sq=None):
    """Unmasked spring constants of the base family for 1-D pair index
    tensors `ii`, `jj` and their squared distances `sq` ``(..., P)`` —
    the sparse counterpart of :func:`base_constants`.  `pos_i` / `pos_j`
    are the original array positions for the bonded test of
    ``table_compact`` where the atoms were reordered; `net_sq` the
    squared distances that decide the bins (default `sq`)."""
    if params.kind in ANALYTIC_KINDS:
        return analytic_constants(params.kind, sq)
    dev = params.device_tables(sq.device, sq.dtype)
    if params.kind == "table_compact":
        code = dev["code"]
        return _compact_lookup(params, sq, dev, _compact_offsets(
            code[ii], code[jj], ii if pos_i is None else pos_i,
            jj if pos_j is None else pos_j), net_sq)
    bins = _network_bins(params, sq, net_sq)
    table = dev["pair_table"]
    return table[ii, jj, 0].expand(sq.shape) if bins is None \
        else table[ii, jj, bins]


def _within_cutoff(sq, params):
    return sq <= torch.as_tensor(params.cutoff_sq, dtype=sq.dtype)


def _value_pipeline(k, sq, params, layers):
    """Overlay values, innermost patch outward: a pair beyond the wrapped
    field's cutoff contributes zero, and a per-pair constant overrides
    wherever one is defined."""
    for has_value, values in layers:
        k = torch.where(_within_cutoff(sq, params), k, torch.zeros_like(k))
        k = torch.where(has_value, values, k)
    return k


def overlay_pair_delta(coord, params, pos=None):
    """The sparse correction of the patch overlays: the candidate pairs
    and ``k_patched - k_base`` at each, for `coord` ``(..., n, 3)`` in
    the order of the overlay masks.

    ``k_base`` is what a kernel computed for the pair: the squared
    distance in the kernels' operation order and dtype, the cutoff
    compared in that dtype.  `pos` ``(n,)`` maps slots to original array
    positions (the Morton permutation of the block-sparse paths) for the
    bonded test of ``table_compact``.

    Returns ``(ii, jj, delta, disp, safe_sq)``: int64 index tensors
    ``(P,)``, ``delta`` and ``safe_sq`` ``(..., P)`` and the pair
    displacements ``disp`` ``(..., P, 3)``.
    """
    params._check_atoms(coord.shape[-2])
    dev = params.device_overlays(coord.device, coord.dtype)
    ii, jj = dev["ii"], dev["jj"]
    pos_i = pos_j = None
    if pos is not None:
        pos = torch.as_tensor(pos, device=coord.device).long()
        pos_i, pos_j = pos[ii], pos[jj]
    disp = coord[..., ii, :] - coord[..., jj, :]
    sq = disp[..., 0] * disp[..., 0] + disp[..., 1] * disp[..., 1] \
        + disp[..., 2] * disp[..., 2]
    safe_sq = torch.where(sq == 0, torch.ones_like(sq), sq)
    base_adj = _within_cutoff(sq, params)
    k_raw = pair_base_constants(ii, jj, sq, strip_overlays(params),
                                pos_i=pos_i, pos_j=pos_j)
    zero = torch.zeros_like(k_raw)
    k_base = torch.where(base_adj, k_raw, zero)
    k_full = _value_pipeline(k_raw, sq, params, dev["pair_layers"])
    adj = (base_adj & ~dev["pair_off"]) | dev["pair_on"]
    return ii, jj, torch.where(adj, k_full, zero) - k_base, disp, safe_sq


def effective_adjacency(sq, params):
    """The interaction set ``(..., n, n)``: within the cutoff, no
    self-pairs, then every overlay's shutdown and switched-off pairs
    removed and its switched-on pairs added."""
    n = sq.shape[-1]
    adj = ~torch.eye(n, dtype=torch.bool, device=sq.device)
    if params.has_cutoff:
        adj = adj & _within_cutoff(sq, params)
    else:
        adj = adj.expand(sq.shape)
    if params.overlays:
        dev = params.device_overlays(sq.device, sq.dtype)
        adj = (adj & ~dev["off_any"]) | dev["on_any"]
    return adj


def force_constants(params, sq):
    """Masked spring constants ``(..., n, n)`` of all pairs of one
    protein at squared distances `sq`, overlays applied: zero on the
    diagonal and outside the interaction set (the dense plain
    constants)."""
    k = base_constants(params, sq)
    if params.overlays:
        params._check_atoms(sq.shape[-1])
        k = _value_pipeline(k, sq, params, params.device_overlays(
            sq.device, sq.dtype)["layers"])
    return torch.where(effective_adjacency(sq, params), k,
                       torch.zeros_like(k))


def squared_norm(disp):
    """``(d_x d_x + d_y d_y) + d_z d_z`` of displacements ``(..., 3)``,
    summed in this order on every device.  A reduction's order is the
    device's choice (``torch.sum`` on CUDA may add ``d_x d_x + (d_y d_y
    + d_z d_z)``), and one rounding decides a pair within an ulp of the
    cutoff; this order is the assembly kernels' and the host's."""
    return (disp[..., 0] * disp[..., 0] + disp[..., 1] * disp[..., 1]
            + disp[..., 2] * disp[..., 2])


def pairwise_sq_distance(coord):
    """Displacements ``coord[i] - coord[j]`` ``(..., n, n, 3)`` and
    squared distances ``(..., n, n)`` of all atom pairs of `coord`
    ``(..., n, 3)``, by the exact difference (not the ``|x|^2 - 2 x.y``
    product) summed by :func:`squared_norm`, so that the cutoff decision
    matches a brute-force reference bit for bit on every device."""
    disp = coord[..., :, None, :] - coord[..., None, :, :]
    return disp, squared_norm(disp)


def force_constant_matrix(sq_dist, params, dtype=None):
    """Dense masked force constants ``k[i, j]`` ``(..., n, n)`` at squared
    distances `sq_dist`, overlays applied (zero on the diagonal and
    outside the interaction set): :func:`force_constants` with the JAX
    package's argument order, cast to `dtype` when given."""
    k = force_constants(params, sq_dist)
    return k if dtype is None else k.to(dtype)


def _overlay_from_fields(entry):
    """A :class:`PatchOverlay` from a dict of its four arrays."""
    if not isinstance(entry, dict) or set(entry) != set(_OVERLAY_FIELDS):
        raise ValueError(
            f"an overlay entry is a dict of the arrays {_OVERLAY_FIELDS}, "
            f"got {sorted(entry) if isinstance(entry, dict) else entry!r}")
    return PatchOverlay(
        off_mask=np.asarray(entry["off_mask"], dtype=bool),
        on_mask=np.asarray(entry["on_mask"], dtype=bool),
        values=np.asarray(entry["values"]),
        has_value=np.asarray(entry["has_value"], dtype=bool))


def from_numpy_params(fields):
    """Port :class:`FFParams` from the fields of a JAX ``FFParams``
    given as a dict (``kind``, ``n_bins``, ``cutoff_sq``, ``edges_sq``,
    array fields as numpy arrays or ``None``, ``overlays`` as a tuple of
    dicts of the four ``(n, n)`` arrays ``off_mask``, ``on_mask``,
    ``values``, ``has_value``)."""
    if not isinstance(fields, dict) or "kind" not in fields:
        raise TypeError("from_numpy_params takes a dict of the fields of "
                        "a JAX FFParams, with its 'kind'")
    edges = fields.get("edges_sq")
    arrays = {f: np.asarray(fields[f]) for f in _ARRAY_FIELDS
              if fields.get(f) is not None}
    return FFParams(
        kind=fields["kind"],
        n_bins=int(fields.get("n_bins", 1)),
        cutoff_sq=float(fields.get("cutoff_sq", _INF)),
        edges_sq=None if edges is None else tuple(float(e) for e in edges),
        overlays=tuple(_overlay_from_fields(entry)
                       for entry in fields.get("overlays") or ()),
        **arrays,
    )
