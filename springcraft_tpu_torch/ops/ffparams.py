"""
Force-field parameters for the PyTorch port: the analytic families and
the two tabulated ones.

Counterpart of ``springcraft_tpu/ops/ffparams.py:78-189, 395-456`` (the
``FFParams`` record, its constructors and the dense spring-constant
rules) and of ``springcraft_tpu/ops/pallas_kernels.py:95-185`` (the
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
(``ffparams.py:400``).  Patch overlays are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = [
    "FFParams",
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

    def _scalars(self):
        return self.kind, self.n_bins, self.cutoff_sq, self.edges_sq

    def __eq__(self, other):
        if not isinstance(other, FFParams):
            return NotImplemented
        return self._scalars() == other._scalars() and all(
            np.array_equal(getattr(self, f), getattr(other, f))
            for f in _ARRAY_FIELDS if getattr(self, f) is not None
            or getattr(other, f) is not None)

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
        """Atoms a tabulated family was built for (``None``: any)."""
        if self.kind == "table_pair":
            return self.pair_table.shape[0]
        if self.kind == "table_compact":
            return self.type_idx.shape[0]
        return None

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


def _compact_pair_base(code):
    """``(n, n)`` offsets ``(context * 20 + type_p) * 20 + type_q`` into
    one bin of the stacked tables: bonded for neighbours in the array
    whose lower one is flagged, else intra-chain for equal chain codes,
    else inter-chain."""
    n = code.shape[0]
    types = (code & 31).long()
    bonded_next = (code >> 5) & 1
    chain = code >> 6
    idx = torch.arange(n, device=code.device)
    upper = (idx[None, :] - idx[:, None] == 1) & (bonded_next[:, None] != 0)
    bonded = upper | upper.T
    context = torch.where(chain[:, None] == chain[None, :], 0, 1)
    context = torch.where(bonded, 2, context)
    return (context * N_TYPES + types[:, None]) * N_TYPES + types[None, :]


def base_constants(params, sq):
    """Unmasked spring constants ``(..., n, n)`` of any family for the
    squared distances `sq` ``(..., n, n)`` of all pairs of one protein:
    the plain version of the kernels' rules and of their table
    lookup."""
    if params.kind in ANALYTIC_KINDS:
        return analytic_constants(params.kind, sq)
    n = sq.shape[-1]
    if params.n_atoms != n:
        raise ValueError(f"force field was built for {params.n_atoms} "
                         f"atoms, coordinates have {n}")
    dev = params.device_tables(sq.device, sq.dtype)
    bins = _bin_indices(sq, params, dev["edges"])
    if params.kind == "table_pair":
        offset = torch.arange(n * n, device=sq.device).reshape(n, n) \
            * params.n_bins
        flat = dev["pair_table"].reshape(-1)
    else:
        offset = _compact_pair_base(dev["code"])
        flat = dev["tables"].reshape(-1)
        if bins is not None:
            bins = bins * (3 * N_TYPES * N_TYPES)
    index = offset.expand(sq.shape) if bins is None else bins + offset
    return flat[index]


def from_numpy_params(fields):
    """Port :class:`FFParams` from the fields of a JAX ``FFParams``
    given as a dict (``kind``, ``n_bins``, ``cutoff_sq``, ``edges_sq``,
    array fields as numpy arrays or ``None``, ``overlays``)."""
    if fields.get("overlays"):
        raise NotImplementedError(
            "patch overlays are not ported yet (ROADMAP.md, next slices: "
            "overlays)")
    edges = fields.get("edges_sq")
    arrays = {f: np.asarray(fields[f]) for f in _ARRAY_FIELDS
              if fields.get(f) is not None}
    return FFParams(
        kind=fields["kind"],
        n_bins=int(fields.get("n_bins", 1)),
        cutoff_sq=float(fields.get("cutoff_sq", _INF)),
        edges_sq=None if edges is None else tuple(float(e) for e in edges),
        **arrays,
    )
