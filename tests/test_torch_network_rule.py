"""The float64 refinement applies the network its modes were solved on.

The assembly kernels (K5, K6 and their plain versions) decide which pairs
interact, and in which sdENM distance bin, on the float32 squared
distances of float32 coordinates.  With float32 coordinates and float32
modes, ``refine_modes_f64`` and ``refine_modes_f64_gnm`` decide the same
way; with float64 coordinates they keep the float64 decision.  The
structure here has one pair whose float32 and float64 squared distances
fall in different bins (7.0 A) and one astride the 16.5 A cutoff.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import springcraft_tpu_torch as sct
from springcraft_tpu_torch.ops import (assembly_kernels, ffparams, modes,
                                       pairs, pallas_kernels)
from springcraft_tpu_torch.structure import AtomArray

AA20 = ("ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS",
        "ILE", "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP",
        "TYR", "VAL")
N = 60
#: Atoms moved onto the edge pairs: (fixed, moved, distance in A).
EDGE_PAIRS = ((5, 40, 7.0), (20, 50, 16.5))
K = 10


def _sq32(a, b):
    d = a.astype(np.float32) - b.astype(np.float32)
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
        + d[..., 2] * d[..., 2]


def _place_on_edge(coord, p, q, r, u):
    """Move atom `q` to a float32 position at about `r` from `p` along `u`
    whose float32 squared distance is at most ``r^2`` and whose float64
    one is above it (a search over the nearby float32 positions)."""
    base = (coord[p].astype(np.float64) + r * u).astype(np.float32)
    steps = np.arange(-12, 13)
    grid = np.stack(np.meshgrid(steps, steps, steps, indexing="ij"),
                    -1).reshape(-1, 3)
    cand = base[None] + grid * np.spacing(base)[None]
    s32 = _sq32(coord[p][None], cand)
    s64 = ((cand.astype(np.float64) - coord[p].astype(np.float64)) ** 2
           ).sum(-1)
    r2 = np.float32(r * r)
    ok = np.flatnonzero((s32 <= r2) & (s64 > float(r2)))
    coord[q] = cand[ok[np.argmin(s64[ok])]]


def edge_system():
    """``(coord float32 (n, 3), sdENM parameters)`` with the two edge
    pairs."""
    rng = np.random.default_rng(5)
    side = (N / 0.00763) ** (1 / 3)
    coord = (rng.random((N, 3)) * side).astype(np.float32)
    res_name = np.array(AA20)[rng.integers(0, 20, N)]
    for p, q, r in EDGE_PAIRS:
        u = rng.standard_normal(3)
        _place_on_edge(coord, p, q, r, u / np.linalg.norm(u))
    atoms = AtomArray(N)
    atoms.coord = coord
    atoms.atom_name = np.full(N, "CA")
    atoms.element = np.full(N, "C")
    atoms.chain_id = np.array(list("AB"))[np.arange(N) * 2 // N]
    atoms.res_id = np.arange(1, N + 1)
    atoms.res_name = res_name
    params = sct.TabulatedForceField.sd_enm(atoms).to_compact_params()
    return torch.from_numpy(coord), params


@pytest.fixture(scope="module")
def system():
    return edge_system()


def _squared(c):
    d = c[:, None] - c[None]
    return d, ffparams.squared_norm(d)


def _network(c32, params, network):
    """The float64 constants ``(n, n)`` of the network decided in
    `network`: the sdENM edges and cutoff are exact in float32, so the
    float32 decision is the float64 one on the float32 squared
    distances."""
    _, s32 = _squared(c32)
    _, s64 = _squared(c32.double())
    decide = s32.double() if network == torch.float32 else s64
    return ffparams.force_constants(params, decide)


def network_hessian(c32, params, network):
    """The float64 xyz Hessian of that network."""
    d, s64 = _squared(c32.double())
    g = _network(c32, params, network) / torch.where(
        s64 == 0, torch.ones_like(s64), s64)
    n = c32.shape[0]
    h = torch.zeros(3 * n, 3 * n, dtype=torch.float64)
    idx = torch.arange(n)
    for a in range(3):
        for b in range(3):
            block = -g * d[..., a] * d[..., b]
            h[a * n:(a + 1) * n, b * n:(b + 1) * n] = block
            h[a * n + idx, b * n + idx] = -block.sum(dim=-1)
    return h


def _kirchhoff(c32, params, network):
    k = _network(c32, params, network)
    return torch.diag(k.sum(dim=1)) - k


def _rel(got, truth):
    return float((got - truth).abs().max() / truth.abs().max())


def test_the_structure_has_both_edge_pairs(system):
    c32, params = system
    c = c32.numpy()
    for p, q, r in EDGE_PAIRS:
        s32 = _sq32(c[p], c[q])
        s64 = float(((c[p].astype(np.float64) - c[q]) ** 2).sum())
        assert s32 <= np.float32(r * r) and float(r * r) < s64
    k32 = _network(c32, params, torch.float32)
    k64 = _network(c32, params, torch.float64)
    # the 7.0 A pair changes bin, the 16.5 A pair drops out in float64
    assert float(k32[5, 40]) != float(k64[5, 40])
    assert float(k32[20, 50]) != 0.0 and float(k64[20, 50]) == 0.0


@pytest.mark.parametrize("network", [torch.float32, torch.float64])
def test_pair_list_members_and_bins(system, network):
    """The pair list of the float32 network is K5's plain version's
    (members and bins: its float64 constants round to the kernel's
    float32 ones); that of the float64 network is the float64 one."""
    c32, params = system
    i, j, k = pairs.pair_list(c32.double(), params, network=network)
    dense = torch.zeros(N, N, dtype=torch.float64)
    dense[i, j] = k
    want = torch.triu(_network(c32, params, network), 1)
    assert torch.equal(dense, want)
    if network == torch.float32:
        _, s32 = _squared(c32)
        kernel = torch.triu(ffparams.force_constants(params, s32), 1)
        assert torch.equal(dense.float(), kernel)


@pytest.mark.parametrize("method", ["sparse", "dense"])
def test_float32_input_is_refined_on_the_kernels_network(system, method):
    """Modes of the float32 K5 Hessian (its plain version), refined from
    float32 coordinates: within 1e-9 of float64 ``eigvalsh`` of the
    float32 network.  From float64 coordinates (the old rule for this
    input) they read 1.90e-03 off it: the operator of another network."""
    c32, params = system
    h32 = assembly_kernels.hessian_xyz_ensemble(c32[None], params)[0]
    _, vecs = modes.lowest_modes_anm(h32, c32, K)
    assert vecs.dtype == torch.float32
    truth = torch.linalg.eigvalsh(
        network_hessian(c32, params, torch.float32))
    truth = truth[6:6 + K - 2]
    got = modes.refine_modes_f64(c32, params, vecs, method=method,
                                 block=16)[0][:K - 2]
    assert _rel(got, truth) <= 1e-9
    old = modes.refine_modes_f64(c32.double(), params, vecs, method=method,
                                 block=16)[0][:K - 2]
    assert _rel(old, truth) >= 1e-3


@pytest.mark.parametrize("method", ["sparse", "dense"])
def test_float64_coordinates_keep_the_float64_network(system, method):
    """Modes of a float64 assembly (float64 coordinates), in float64 or
    rounded to float32 as the models round them, and float64 modes of
    float32 coordinates: the float64 network, as before the rule."""
    c32, params = system
    h64 = assembly_kernels.hessian_xyz_ensemble(c32.double()[None],
                                                params)[0]
    truth = torch.linalg.eigvalsh(
        network_hessian(c32, params, torch.float64))
    truth = truth[6:6 + K - 2]
    _, vecs = modes.lowest_modes_anm(h64, c32.double(), K)
    for coord, v in ((c32.double(), vecs), (c32.double(), vecs.float()),
                     (c32, vecs)):
        got = modes.refine_modes_f64(coord, params, v, method=method,
                                     block=16)[0][:K - 2]
        assert _rel(got, truth) <= 1e-9


@pytest.mark.parametrize("method", ["sparse", "dense"])
def test_gnm_refinement_takes_the_same_rule(system, method):
    c32, params = system
    for network in (torch.float32, torch.float64):
        coord = c32 if network == torch.float32 else c32.double()
        kmat = assembly_kernels.kirchhoff_ensemble(coord[None], params)[0]
        vecs = torch.linalg.eigh(kmat)[1][:, 1:1 + K].T.float().contiguous()
        truth = torch.linalg.eigvalsh(_kirchhoff(c32, params, network))
        truth = truth[1:1 + K - 2]
        got = modes.refine_modes_f64_gnm(coord, params, vecs, method=method,
                                         block=16)[0][:K - 2]
        assert _rel(got, truth) <= 1e-9


def test_numpy_inputs_follow_their_dtypes(system):
    c32, params = system
    h32 = assembly_kernels.hessian_xyz_ensemble(c32[None], params)[0]
    _, vecs = modes.lowest_modes_anm(h32, c32, K)
    got = modes.refine_modes_f64(c32.numpy(), params, vecs,
                                 method="sparse")[0]
    want = modes.refine_modes_f64(c32, params, vecs, method="sparse")[0]
    assert torch.equal(got, want)
    assert modes._network_dtype(c32.numpy(), vecs.numpy()) == torch.float32
    assert modes._network_dtype(c32.numpy().astype(np.float64),
                                vecs) == torch.float64


def test_counters_and_spans(system):
    """One request of the assembly cell's chain on the CPU under the
    profiler: the spans of each stage, the sweeps run and the pairs
    listed."""
    c32, params = system
    sweeps = modes.lowest_modes_shift_invert.sweeps
    listed = modes.refine_modes_f64.listed_pairs
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        h = pallas_kernels.hessian_pallas(c32, params)
        _, vecs = sct.lowest_modes_anm(h, c32, 6, engine="chol")
        sct.refine_modes_f64(c32, params, vecs)
    names = {e.name for e in prof.events()}
    for stage in ("assembly", "lowest_modes_anm", "prep", "cholesky",
                  "sweeps", "refine", "pair_search"):
        assert "springcraft::" + stage in names, stage
    assert modes.lowest_modes_shift_invert.sweeps == sweeps + 24
    i, _, _ = pairs.pair_list(c32.double(), params, network=torch.float32)
    assert modes.refine_modes_f64.listed_pairs == listed + i.numel()
