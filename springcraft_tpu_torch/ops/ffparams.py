"""
Force-field parameters of the analytic families for the PyTorch port.

Counterpart of ``springcraft_tpu/ops/ffparams.py:78-138`` (the
``FFParams`` record and its analytic constructors) and of
``springcraft_tpu/ops/pallas_kernels.py:95-108`` (``_analytic_constants``,
the per-family spring-constant rules the assembly kernels evaluate).
The port cannot import the JAX package (its ``ffparams`` imports
``jax``), so :func:`from_numpy_params` carries a JAX ``FFParams`` across
as a plain dict of its fields.

Tabulated families (``table_pair``, ``table_compact``) and patch overlays
are a later slice of the port (ROADMAP, next slices: tabulated
families).
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = [
    "FFParams",
    "ANALYTIC_KINDS",
    "invariant_params",
    "hinsen_params",
    "pfenm_params",
    "analytic_constants",
    "from_numpy_params",
]

_INF = math.inf

#: Families the port evaluates, in the order of their kernel codes.
ANALYTIC_KINDS = ("invariant", "hinsen", "pfenm")

_ARRAY_FIELDS = ("pair_table", "type_idx", "chain_code", "bonded_next",
                 "intra_table", "inter_table", "bonded_table")


@dataclasses.dataclass(frozen=True)
class FFParams:
    """One analytic force-field family: its tag, bin count and squared
    cutoff (``inf`` means no cutoff)."""

    kind: str
    n_bins: int = 1
    cutoff_sq: float = _INF
    edges_sq: tuple | None = None

    def __post_init__(self):
        if self.kind not in ANALYTIC_KINDS:
            raise NotImplementedError(
                f"force-field kind {self.kind!r} is not ported yet; the "
                f"port covers {ANALYTIC_KINDS} (tabulated families are "
                f"a later slice, see ROADMAP.md)")

    @property
    def has_cutoff(self):
        return self.cutoff_sq != _INF

    @property
    def kind_code(self):
        """Integer tag of the family, as the assembly kernel takes it."""
        return ANALYTIC_KINDS.index(self.kind)


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


def from_numpy_params(fields):
    """Port :class:`FFParams` from the fields of a JAX ``FFParams``
    given as a dict (``kind``, ``n_bins``, ``cutoff_sq``, ``edges_sq``,
    array fields as numpy arrays or ``None``, ``overlays``)."""
    kind = fields["kind"]
    if kind in ("table_pair", "table_compact"):
        raise NotImplementedError(
            f"tabulated family {kind!r} is not ported yet (ROADMAP.md, "
            f"next slices: tabulated families with pair_constant_planes)")
    if fields.get("overlays"):
        raise NotImplementedError(
            "patch overlays are not ported yet (ROADMAP.md, next slices: "
            "tabulated families and overlays)")
    extra = [f for f in _ARRAY_FIELDS if fields.get(f) is not None]
    if extra:
        raise ValueError(f"analytic family {kind!r} carries no array "
                         f"fields, got {extra}")
    edges = fields.get("edges_sq")
    return FFParams(
        kind=kind,
        n_bins=int(fields.get("n_bins", 1)),
        cutoff_sq=float(fields.get("cutoff_sq", _INF)),
        edges_sq=None if edges is None else tuple(float(e) for e in edges),
    )
