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


@pytest.mark.parametrize("fields", [
    {"kind": "table_compact", "n_bins": 3},
    {"kind": "table_pair", "n_bins": 2},
    {"kind": "invariant", "n_bins": 1, "cutoff_sq": 49.0,
     "overlays": ("overlay",)},
])
def test_from_numpy_params_refuses_unported(fields):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tff.from_numpy_params(fields)


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
