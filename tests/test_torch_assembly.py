"""
PyTorch port, assembly layer: force-field parameters, the Hessian-plane
assembly (plain version of the ``hessian_planes`` CUDA kernel) and the
regularize/stitch prep (plain version of ``regularize_stitch``), each
held against the JAX package on the same numpy inputs.  The JAX Pallas
kernels run in interpret mode on the CPU.

Tolerances: the assembly matches the JAX kernel's arithmetic operation
by operation except for the diagonal's summation order, so 1e-5 of
max|H| is several float32 ulps of headroom; the stitch adds one scale
and a rank-6 sum per element (1e-5 of max|reg|), and the Jacobi scale
and sigma are short float32 reductions (1e-6 relative).
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from springcraft_tpu.ops import ffparams as jff  # noqa: E402
from springcraft_tpu.ops import pallas_kernels  # noqa: E402
from springcraft_tpu.ops import rigid as jrigid  # noqa: E402
from springcraft_tpu_torch.ops import assembly, assembly_kernels  # noqa: E402
from springcraft_tpu_torch.ops import ffparams as tff  # noqa: E402
from springcraft_tpu_torch.ops import rigid as trigid  # noqa: E402

KINDS = ("invariant", "hinsen", "pfenm")


def _dense_coords(b, n, seed):
    # connected at a 7 A cutoff (see tests/test_pallas_linalg.py)
    rng = np.random.RandomState(seed)
    base = (rng.rand(n, 3) * 6.0).astype(np.float32)
    return base[None] + 0.05 * rng.randn(b, n, 3).astype(np.float32)


def _jax_params(kind, cutoff=7.0):
    return getattr(jff, f"{kind}_params")(cutoff)


def _fields(params):
    """A JAX ``FFParams`` as the plain dict the port carries across."""
    out = {}
    for f in dataclasses.fields(params):
        value = getattr(params, f.name)
        if value is not None and f.name not in ("kind", "n_bins",
                                                "cutoff_sq", "edges_sq",
                                                "overlays"):
            value = np.asarray(value)
        out[f.name] = value
    return out


def _rel(got, ref):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("cutoff", [7.0, None])
def test_from_numpy_params_round_trip(kind, cutoff):
    if kind == "invariant" and cutoff is None:
        with pytest.raises(ValueError):
            tff.invariant_params(None)
        return
    ref = _jax_params(kind, cutoff)
    got = tff.from_numpy_params(_fields(ref))
    assert got == getattr(tff, f"{kind}_params")(cutoff)
    assert (got.kind, got.n_bins, got.cutoff_sq, got.edges_sq) == (
        ref.kind, ref.n_bins, ref.cutoff_sq, ref.edges_sq)
    assert got.has_cutoff == ref.has_cutoff


def _overlay_fields(n, seed):
    """The four ``(n, n)`` arrays of one overlay, as a dict."""
    rng = np.random.RandomState(seed)
    off = np.triu(rng.rand(n, n) < 0.1, 1)
    on = np.triu(rng.rand(n, n) < 0.1, 1) & ~off
    values = np.where(on, rng.rand(n, n) + 0.5, 0.0)
    return {"off_mask": off | off.T, "on_mask": on | on.T,
            "values": values + values.T, "has_value": on | on.T}


def _family_fields(kind, n):
    rng = np.random.RandomState(1)
    if kind == "invariant":
        return {"kind": kind, "n_bins": 1, "cutoff_sq": 49.0}
    edges_sq = (16.0, 49.0)
    if kind == "table_pair":
        return {"kind": kind, "n_bins": 2, "cutoff_sq": 49.0,
                "edges_sq": edges_sq, "pair_table": rng.rand(n, n, 2)}
    tables = {f"{name}_table": rng.rand(20, 20, 2).astype(np.float32)
              for name in ("intra", "inter", "bonded")}
    return {"kind": kind, "n_bins": 2, "cutoff_sq": 49.0,
            "edges_sq": edges_sq,
            "type_idx": rng.randint(0, 20, n).astype(np.int32),
            "chain_code": np.zeros(n, np.int32),
            "bonded_next": np.ones(n, bool), **tables}


@pytest.mark.parametrize("kind", ["table_compact", "table_pair",
                                  "invariant"])
def test_from_numpy_params_carries_overlays(kind):
    """Patch overlays ride on every family: each entry, a dict of its four
    ``(n, n)`` arrays, becomes a ``PatchOverlay`` in order, and the
    overlay reaches the dense constants (the JAX package's own value
    pipeline: tests/test_torch_overlays.py)."""
    n = 12
    entries = (_overlay_fields(n, 2), _overlay_fields(n, 3))
    got = tff.from_numpy_params({**_family_fields(kind, n),
                                 "overlays": entries})
    assert got.kind == kind and len(got.overlays) == 2
    for overlay, entry in zip(got.overlays, entries):
        for name, array in entry.items():
            assert np.array_equal(getattr(overlay, name), array), name
    assert got.n_atoms == n
    base = tff.from_numpy_params(_family_fields(kind, n))
    assert tff.strip_overlays(got) == base and got != base
    sq = torch.from_numpy(np.random.RandomState(4).rand(n, n) * 60.0)
    sq = sq + sq.T
    assert not torch.equal(tff.force_constants(got, sq),
                           tff.force_constants(base, sq))


def test_from_numpy_params_refuses_a_malformed_overlay():
    fields = _family_fields("invariant", 6)
    entry = _overlay_fields(6, 0)
    with pytest.raises(ValueError, match="an overlay entry is a dict"):
        tff.from_numpy_params({**fields, "overlays": ("overlay",)})
    with pytest.raises(ValueError, match="an overlay entry is a dict"):
        tff.from_numpy_params({**fields, "overlays": (
            {k: v for k, v in entry.items() if k != "values"},)})
    with pytest.raises(ValueError, match=r"four \(n, n\) arrays"):
        tff.from_numpy_params({**fields, "overlays": (
            {**entry, "values": entry["values"][:5]},)})
    with pytest.raises(ValueError, match="different atom counts"):
        tff.from_numpy_params({**_family_fields("table_pair", 7),
                               "overlays": (entry,)})


@pytest.mark.parametrize("kind", KINDS)
def test_analytic_constants_match_jax(kind):
    sq = np.linspace(0.0, 200.0, 401).astype(np.float32)
    ref = np.asarray(pallas_kernels._analytic_constants(kind,
                                                        jnp.asarray(sq)))
    got = tff.analytic_constants(kind, torch.from_numpy(sq)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_hessian_planes_match_pallas_ensemble(kind):
    coords = _dense_coords(3, 41, seed=17)
    n = coords.shape[1]
    ref = pallas_kernels.hessian_pallas_ensemble(
        jnp.asarray(coords), _jax_params(kind), dtype=jnp.float32,
        raw_planes=True, tile=n, interpret=True)
    ref = np.stack([np.asarray(p) for p in ref])        # (9, B, n, n)

    params = getattr(tff, f"{kind}_params")(7.0)
    before = assembly_kernels.hessian_planes_ensemble.launches
    got = assembly_kernels.hessian_planes_ensemble(
        torch.from_numpy(coords), params)
    # a CPU tensor takes the plain version and launches nothing
    assert assembly_kernels.hessian_planes_ensemble.launches == before
    assert got.shape == (9, 3, n, n) and got.dtype == torch.float32
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(got.numpy() - ref)) <= 1e-5 * scale

    dense = assembly.hessian_xyz_plain(torch.from_numpy(coords), params)
    ref_dense = pallas_kernels.hessian_pallas_ensemble(
        jnp.asarray(coords), _jax_params(kind), dtype=jnp.float32,
        tile=n, interpret=True)
    assert np.max(np.abs(dense.numpy() - np.asarray(ref_dense))) \
        <= 1e-5 * scale


def test_hessian_planes_null_space():
    """Rigid-body modes are null vectors of the assembled Hessian."""
    coords = torch.from_numpy(_dense_coords(2, 25, seed=3)).double()
    h = assembly.hessian_xyz_plain(coords, tff.hinsen_params(9.0))
    t = trigid.rigid_modes_anm(coords)
    assert torch.allclose(h, h.transpose(-1, -2))
    assert float((h @ t).abs().max()) < 1e-9 * float(h.abs().max())


@pytest.mark.parametrize("with_masses", [False, True])
def test_regularize_stitch_matches_jax(with_masses):
    coords = _dense_coords(3, 41, seed=5)
    n = coords.shape[1]
    masses = (np.linspace(0.8, 2.5, n).astype(np.float32)
              if with_masses else None)
    planes = pallas_kernels.hessian_pallas_ensemble(
        jnp.asarray(coords), jff.invariant_params(7.0), dtype=jnp.float32,
        raw_planes=True, tile=n, interpret=True)
    bases = np.asarray(jax.vmap(
        lambda c: jrigid.rigid_modes_anm(c, masses=masses, layout="xyz"))(
            jnp.asarray(coords))).astype(np.float32)
    ref_reg, ref_scale, ref_sigma = jrigid._regularize_equilibrated_planes(
        planes, n, jnp.asarray(bases), None, masses=masses, interpret=True)

    planes_t = torch.from_numpy(np.stack([np.asarray(p) for p in planes]))
    masses_t = None if masses is None else torch.from_numpy(masses)
    reg, scale, sigma = trigid._regularize_equilibrated_planes(
        planes_t, n, torch.from_numpy(bases), masses=masses_t)
    assert reg.shape == ref_reg.shape == (3, 128, 128)
    assert _rel(reg, ref_reg) <= 1e-5
    assert _rel(scale, ref_scale) <= 1e-6
    assert _rel(sigma, ref_sigma) <= 1e-6
    # identity on the padded diagonal, zeros elsewhere in the pad
    pad = reg[:, 3 * n:, :]
    assert torch.equal(pad[:, :, :3 * n], torch.zeros_like(pad[:, :, :3 * n]))
    assert torch.equal(pad[:, :, 3 * n:],
                       torch.eye(128 - 3 * n).expand(3, -1, -1))


def test_regularize_stitch_matches_concatenated_prep():
    """The stitch from planes is the semantic twin of the dense prep."""
    coords = torch.from_numpy(_dense_coords(2, 30, seed=8))
    params = tff.pfenm_params(7.0)
    planes = assembly.hessian_planes_plain(coords, params)
    t = trigid.rigid_modes_anm(coords)
    got = trigid._regularize_equilibrated_planes(planes, 30, t)
    ref = trigid._regularize_equilibrated(
        assembly.planes_to_xyz(planes), t, pad_to=128)
    for g, r in zip(got, ref):
        assert _rel(g, r) <= 1e-6


@pytest.mark.parametrize("n", [7, 41, 100])
@pytest.mark.parametrize("with_masses", [False, True])
def test_ordered_stitch_reference_matches_the_plain_version(n, with_masses):
    """The card tests hold K2 bit for bit against an ordered reference
    (the rank-6 sum in k order, each float32 product and sum rounded on
    its own); that reference is the plain version up to the order of the
    sum (1e-6 of max|reg|) and equal to it on the pad."""
    from .test_torch_cuda import ordered_regularize_stitch

    coords = torch.from_numpy(_dense_coords(2, n, seed=n))
    planes = assembly.hessian_planes_plain(coords, tff.invariant_params(7.0))
    masses = torch.linspace(0.8, 2.5, n) if with_masses else None
    bases = trigid.rigid_modes_anm(coords, masses=masses)
    _, _, scale_h, ts = trigid.stitch_inputs(planes, bases, masses=masses)
    m = 3 * n
    mp = m + 8 - m % 8 + 8
    got = ordered_regularize_stitch(planes, scale_h, ts, mp)
    ref = assembly_kernels.regularize_stitch_plain(planes, scale_h, ts, mp)
    assert got.shape == ref.shape == (2, mp, mp)
    assert _rel(got, ref) <= 1e-6
    assert torch.equal(got[:, m:, :], ref[:, m:, :])
    assert torch.equal(got[:, :, m:], ref[:, :, m:])


@pytest.mark.parametrize("bad", ["planes", "scale_h", "ts", "mp"])
def test_regularize_stitch_rejects_bad_shapes(bad):
    b, n = 2, 10
    args = {"planes": torch.zeros(9, b, n, n), "scale_h": torch.ones(b, 3 * n),
            "ts": torch.zeros(b, 3 * n, 6), "mp": 32}
    args[bad] = {"planes": torch.zeros(8, b, n, n),
                 "scale_h": torch.ones(b, 3 * n + 1),
                 "ts": torch.zeros(b, 3 * n, 5), "mp": 3 * n - 1}[bad]
    with pytest.raises(ValueError):
        assembly_kernels.regularize_stitch(**args)


def test_wrappers_refuse_other_devices():
    meta = torch.empty(2, 10, 3, device="meta")
    with pytest.raises(ValueError, match="device"):
        assembly_kernels.hessian_planes_ensemble(meta,
                                                 tff.invariant_params(7.0))
    with pytest.raises(ValueError, match="device"):
        assembly_kernels.regularize_stitch(
            torch.zeros(9, 2, 10, 10), torch.ones(2, 30),
            torch.zeros(2, 30, 6, device="meta"), 32)


# ---------------------------------------------------------------------------
# Single structures: dense matrices, row panels and their helpers (float64)
# ---------------------------------------------------------------------------

from springcraft_tpu.ops import assembly as jassembly  # noqa: E402

SINGLE_FAMILIES = ("invariant", "hinsen", "pfenm", "hinsen_nocut",
                   "pfenm_nocut")


def _single_params(family):
    kind, _, nocut = family.partition("_")
    cutoff = None if nocut else 7.0
    return _jax_params(kind, cutoff), getattr(tff, f"{kind}_params")(cutoff)


def _single_coord(n=41, seed=7, dtype=np.float64):
    return _dense_coords(1, n, seed)[0].astype(dtype)


def test_pairwise_sq_distance_matches_jax():
    coord = _single_coord()
    disp, sq = jff.pairwise_sq_distance(coord, np)
    tdisp, tsq = tff.pairwise_sq_distance(torch.from_numpy(coord))
    assert torch.equal(tdisp, torch.from_numpy(np.asarray(disp)))
    assert torch.equal(tsq, torch.from_numpy(np.asarray(sq)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_squared_norm_sums_in_order(dtype):
    """``(d_x d_x + d_y d_y) + d_z d_z`` bit for bit, the order that
    decides a pair within an ulp of the cutoff the same way on every
    device."""
    disp = np.random.RandomState(3).randn(4096, 3).astype(dtype) * 10
    ref = (disp[:, 0] * disp[:, 0] + disp[:, 1] * disp[:, 1]) \
        + disp[:, 2] * disp[:, 2]
    assert torch.equal(tff.squared_norm(torch.from_numpy(disp)),
                       torch.from_numpy(ref))


@pytest.mark.parametrize("family", SINGLE_FAMILIES)
def test_force_constant_matrix_matches_jax(family):
    jparams, tparams = _single_params(family)
    coord = _single_coord()
    _, sq = jff.pairwise_sq_distance(coord, np)
    ref = jff.force_constant_matrix(sq, jparams, np, dtype=np.float64)
    got = tff.force_constant_matrix(torch.from_numpy(sq), tparams)
    assert got.dtype == torch.float64
    assert _rel(got, ref) <= 1e-12
    assert tff.force_constant_matrix(torch.from_numpy(sq), tparams,
                                     dtype=torch.float32).dtype \
        == torch.float32


@pytest.mark.parametrize("layout", ["atom", "xyz"])
@pytest.mark.parametrize("family", SINGLE_FAMILIES)
def test_hessian_and_kirchhoff_matrix_match_jax(family, layout):
    jparams, tparams = _single_params(family)
    coord = _single_coord()
    ref = jassembly.hessian_matrix(coord, jparams, np, dtype=np.float64,
                                   layout=layout)
    got = assembly.hessian_matrix(torch.from_numpy(coord), tparams,
                                  layout=layout)
    assert got.shape == (123, 123) and _rel(got, ref) <= 1e-12
    ref = jassembly.kirchhoff_matrix(coord, jparams, np, dtype=np.float64)
    got = assembly.kirchhoff_matrix(torch.from_numpy(coord), tparams)
    assert _rel(got, ref) <= 1e-12
    with pytest.raises(ValueError, match="layout"):
        assembly.hessian_matrix(torch.from_numpy(coord), tparams,
                                layout="planes")


def test_hessian_matrix_layouts_are_one_permutation():
    _, tparams = _single_params("hinsen")
    coord = torch.from_numpy(_single_coord())
    p = assembly.atom_to_xyz_permutation(41)
    assert np.array_equal(p.numpy(), jassembly.atom_to_xyz_permutation(41))
    atom = assembly.hessian_matrix(coord, tparams, layout="atom")
    xyz = assembly.hessian_matrix(coord, tparams, layout="xyz")
    assert torch.equal(atom[p][:, p], xyz)
    # the kernels' plain xyz-layout assembly agrees
    assert _rel(assembly.hessian_xyz_plain(coord[None], tparams)[0],
                xyz) <= 1e-12


@pytest.mark.parametrize("start,block", [(0, 41), (0, 8), (16, 10), (33, 8)])
@pytest.mark.parametrize("family", SINGLE_FAMILIES)
def test_row_panels_match_jax(family, start, block):
    jparams, tparams = _single_params(family)
    coord = _single_coord()
    ref = jassembly.hessian_rows(coord, jparams, start, block, np,
                                 dtype=np.float64)
    got = assembly.hessian_rows(torch.from_numpy(coord), tparams, start,
                                block)
    assert got.shape == (3 * block, 123) and _rel(got, ref) <= 1e-12
    full = assembly.hessian_matrix(torch.from_numpy(coord), tparams)
    assert _rel(got, full[3 * start:3 * (start + block)]) <= 1e-12
    ref = jassembly.kirchhoff_rows(coord, jparams, start, block, np,
                                   dtype=np.float64)
    got = assembly.kirchhoff_rows(torch.from_numpy(coord), tparams, start,
                                  block)
    assert got.shape == (block, 41) and _rel(got, ref) <= 1e-12


@pytest.mark.parametrize("maker", ["sd_enm", "e_anm", "table_pair"])
def test_row_panels_of_tables_match_jax(maker):
    import springcraft_tpu as sc
    from springcraft_tpu.structure import load_structure as jload

    import springcraft_tpu_torch as sct

    path = os.path.join(os.path.dirname(os.path.realpath(__file__)), "data",
                        "1l2y.pdb")
    params = []
    for module, load in ((sc, jload), (sct, sct.load_structure)):
        atoms = load(path, model=1)
        ca = atoms[(atoms.atom_name == "CA") & (atoms.element == "C")]
        ff = getattr(module.TabulatedForceField,
                     "e_anm" if maker == "table_pair" else maker)(ca)
        params.append(ff.to_params() if maker == "table_pair"
                      else ff.to_compact_params())
    coord = np.asarray(ca.coord, np.float64)
    for start, block in ((0, 20), (5, 7)):
        ref = jassembly.hessian_rows(coord, params[0], start, block, np,
                                     dtype=np.float64)
        got = assembly.hessian_rows(torch.from_numpy(coord), params[1],
                                    start, block)
        assert _rel(got, ref) <= 1e-12
        ref = jassembly.kirchhoff_rows(coord, params[0], start, block, np,
                                       dtype=np.float64)
        got = assembly.kirchhoff_rows(torch.from_numpy(coord), params[1],
                                      start, block)
        assert _rel(got, ref) <= 1e-12


def test_row_panels_refuse_overlays():
    coord = torch.from_numpy(_single_coord(n=10))
    n = 10
    params = tff.with_overlay(tff.invariant_params(7.0),
                              np.zeros((n, n), bool), np.zeros((n, n), bool),
                              np.zeros((n, n)), np.zeros((n, n), bool))
    for fn in (assembly.hessian_rows, assembly.kirchhoff_rows):
        with pytest.raises(NotImplementedError, match="overlays"):
            fn(coord, params, 0, 4)


@pytest.mark.parametrize("repeat3", [False, True])
def test_mass_weights_match_jax(repeat3):
    masses = np.linspace(0.8, 2.5, 13)
    ref = jassembly.mass_weights(masses, np, repeat3=repeat3)
    got = assembly.mass_weights(torch.from_numpy(masses), repeat3=repeat3)
    assert _rel(got, ref) <= 1e-15


def test_single_structure_matrices_keep_float32():
    _, tparams = _single_params("invariant")
    coord = torch.from_numpy(_single_coord(dtype=np.float32))
    assert assembly.hessian_matrix(coord, tparams).dtype == torch.float32
    assert assembly.kirchhoff_rows(coord, tparams, 0, 5).dtype \
        == torch.float32
    assert assembly.hessian_matrix(coord, tparams, dtype=torch.float64
                                   ).dtype == torch.float64
