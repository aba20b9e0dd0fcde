"""
PyTorch port, the device mesh and the sharded paths
(``springcraft_tpu_torch.parallel.{mesh,sharded}``) against the JAX
package's on the same numpy inputs, on the CPU: the port on meshes of
eight ``torch.device("cpu")`` entries, the JAX package on the eight
virtual devices of ``tests/conftest.py`` with the same ``make_mesh(8,
row_axis=...)``; K12's plain version over row ranges; the JAX sharded
operator's dropped patch overlays and the port's repair.

Tolerances (the JAX package's own, ``tests/test_parallel.py``): float64
ensembles and the pipeline 1e-9, the Hessian 1e-12, the modes 1e-6
relative, the covariance 1e-8; the float64 operator 1e-10 of max|y| and
the float32 one 1e-4 of max|y| (the two packages' float32 sums run in
different orders); the patched operator 1e-12 of max|y|.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import springcraft_tpu as sc  # noqa: E402
from springcraft_tpu import parallel as jpar  # noqa: E402
from springcraft_tpu.ops import assembly as jassembly  # noqa: E402
from springcraft_tpu.ops import ffparams as jff  # noqa: E402
from springcraft_tpu.ops import matfree as jmf  # noqa: E402
import springcraft_tpu_torch as sct  # noqa: E402
from springcraft_tpu_torch import parallel as tpar  # noqa: E402
from springcraft_tpu_torch.ops import matfree as tmf  # noqa: E402
from springcraft_tpu_torch.parallel import mesh as tmesh  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.realpath(__file__)), "data")
CPU8 = [torch.device("cpu")] * 8


def _conformers(n_batch, n_atoms, seed=0, jitter=0.05):
    """``tests/test_parallel.py``'s conformers: dense enough that a ~9 A
    cutoff keeps the network connected."""
    rng = np.random.RandomState(seed)
    base = rng.rand(n_atoms, 3) * 10
    return base[None] + jitter * rng.randn(n_batch, n_atoms, 3)


def _mesh(row_axis):
    return tpar.make_mesh(8, row_axis=row_axis, devices=CPU8)


def _rel(got, ref):
    got = np.asarray(torch.as_tensor(got).double())
    ref = np.asarray(ref, dtype=np.float64)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _np(out):
    return {key: np.asarray(value) for key, value in out.items()}


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("row_axis", [1, 2, 4, 8])
def test_mesh_matches_jax_layout(row_axis):
    got = _mesh(row_axis)
    ref = jpar.make_mesh(8, row_axis=row_axis)
    assert got.shape == dict(ref.shape)
    assert tuple(ref.axis_names) == ("ens", "row")
    assert got.size == ref.size == 8
    # the flat order is the grid's row-major order, as P(("ens", "row"))
    grid = ref.devices
    order = [int(np.argwhere(grid == dev)[0] @ [grid.shape[1], 1])
             for dev in grid.flatten()]
    assert order == list(range(8))
    assert len(got.flat) == 8 and hash(got) == hash(_mesh(row_axis))
    sharding = tpar.ensemble_sharding(got)
    assert sharding == tmesh.Sharding(got, 0)
    assert sharding.bounds(16) == [(2 * d, 2 * d + 2) for d in range(8)]


def test_mesh_refusals(monkeypatch):
    with pytest.raises(ValueError, match="does not divide"):
        tpar.make_mesh(6, row_axis=4, devices=CPU8)
    with pytest.raises(ValueError, match="does not divide"):
        jpar.make_mesh(6, row_axis=4)
    with pytest.raises(ValueError, match="divisible by the mesh size"):
        tpar.ensemble_sharding(_mesh(2)).bounds(12)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.make_mesh()


def test_sharding_split_and_full():
    mesh = tpar.make_mesh(4, row_axis=2, devices=CPU8[:4])
    x = torch.arange(48.0).reshape(8, 6)
    rows = tmesh.Sharding(mesh, 0).split(x)
    cols = tmesh.Sharding(mesh, 1).split(x[:, :4])
    assert rows.shape == x.shape and rows.dtype == x.dtype
    assert [tuple(s.shape) for s in rows.shards] == [(2, 6)] * 4
    assert torch.equal(rows.full(), x)
    assert torch.equal(cols.full(), x[:, :4])
    rows.shards[0][0, 0] = -1.0          # copies, not views of x
    assert x[0, 0] == 0.0


# ---------------------------------------------------------------------------
# The ensemble half
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_ensemble(name, options):
    """The JAX package's float64 call on a mesh of row axis 2."""
    out = getattr(jpar, name)(_conformers(16, 24), jff.invariant_params(9.0),
                              jpar.make_mesh(8, row_axis=2),
                              dtype=jnp.float64, **dict(options))
    return _np(out)


@pytest.mark.parametrize("name, options, tol", [
    ("sharded_ensemble_anm", {}, 1e-9),
    ("sharded_ensemble_gnm", {}, 1e-9),
    ("sharded_ensemble_anm_fluctuations", {}, 1e-9),
    ("sharded_ensemble_anm_banded", {"bandwidth": 4}, 1e-9),
    ("sharded_ensemble_gnm_banded", {"bandwidth": 4}, 1e-9),
])
def test_sharded_ensembles_match_jax(name, options, tol):
    """Float64 on both sides: every output within 1e-9 of max; the
    frequencies of the non-trivial modes (those of the null space are
    square roots of rounding), the eigenvectors of the non-trivial,
    non-degenerate modes by their overlaps (free up to sign; the GNM's
    top eigenvalue here is fivefold)."""
    ref = _jax_ensemble(name, tuple(sorted(options.items())))
    got = getattr(tpar, name)(_conformers(16, 24), sct.invariant_params(9.0),
                              _mesh(2), dtype=torch.float64, **options)
    trivial = 1 if "gnm" in name else 6
    assert set(got) == set(ref)
    for key, value in got.items():
        assert tuple(value.shape) == ref[key].shape, key
        assert value.device == torch.device("cpu")
        value, ref_value = value.numpy(), ref[key]
        if key == "eig_vectors":
            overlap = np.abs(np.sum(value * ref_value, axis=-1))
            lam = ref["eig_values"]
            gap = np.minimum(np.diff(lam, prepend=-np.inf),
                             np.diff(lam, append=np.inf))
            apart = gap > 1e-6 * np.abs(lam).max(axis=-1, keepdims=True)
            apart[:, :trivial] = False
            assert np.all(overlap[apart] > 1 - tol), key
            continue
        if key == "frequencies":
            value, ref_value = value[:, trivial:], ref_value[:, trivial:]
        assert _rel(value, ref_value) <= tol, key


def test_sharded_ensemble_equals_unsharded():
    """Each shard runs the single-device entry point: the sharded call is
    the unsharded one, chunk for chunk."""
    coords = _conformers(16, 24).astype(np.float32)
    params = sct.invariant_params(9.0)
    got = tpar.sharded_ensemble_anm_fluctuations(
        coords, params, _mesh(2), inverse="blocked", with_covariance=False)
    ref = sct.ensemble_anm_fluctuations(
        coords[:2], params, inverse="blocked", with_covariance=False,
        device="cpu")
    for key in ref:
        assert torch.equal(got[key][:2], ref[key]), key


def test_ensemble_mean_msf_matches_jax():
    """Float32 (both packages' default), 1e-4 of max, as the JAX test
    holds its mean against the float64 ensemble."""
    coords = _conformers(16, 24)
    for kind in ("anm", "gnm"):
        ref = np.asarray(jpar.ensemble_mean_msf(
            coords, jff.invariant_params(9.0), jpar.make_mesh(8, row_axis=2),
            kind=kind))
        got = tpar.ensemble_mean_msf(coords, sct.invariant_params(9.0),
                                     _mesh(2), kind=kind)
        assert tuple(got.shape) == ref.shape
        assert _rel(got, ref) <= 1e-4, kind


def test_ensemble_refusals():
    coords = _conformers(12, 24)
    params = sct.invariant_params(9.0)
    with pytest.raises(ValueError, match="divisible by the mesh size"):
        tpar.sharded_ensemble_anm(coords, params, _mesh(2))
    with pytest.raises(ValueError, match="mesh places the shards"):
        tpar.sharded_ensemble_anm(_conformers(16, 24), params, _mesh(2),
                                  device="cpu")


# ---------------------------------------------------------------------------
# The mega half
# ---------------------------------------------------------------------------

def _two_chains(load):
    atoms = load(os.path.join(DATA, "1l2y.pdb"), model=1)
    ca = atoms[(atoms.atom_name == "CA") & (atoms.element == "C")]
    first, second = ca.copy(), ca.copy()
    first.chain_id[:] = "A"
    second.chain_id[:] = "B"
    return first + second


@functools.lru_cache(maxsize=None)
def _hessian_case(kind):
    """``(coord, JAX params, port params)`` of ``tests/test_parallel.py``'s
    sharded-Hessian cases."""
    if kind == "compact":
        jatoms = _two_chains(sc.structure.load_structure)
        tatoms = _two_chains(sct.load_structure)
        return (jatoms.coord.astype(np.float64),
                sc.TabulatedForceField.s_enm_10(jatoms).to_compact_params(),
                sct.TabulatedForceField.s_enm_10(tatoms)
                .to_compact_params())
    from .util import random_coord

    coord = random_coord(5, 40)
    if kind == "invariant":
        return coord, jff.invariant_params(10.0), sct.invariant_params(10.0)
    return coord, jff.hinsen_params(), sct.hinsen_params()


@pytest.mark.parametrize("kind", ["invariant", "hinsen", "compact"])
def test_sharded_hessian_matches_jax(kind):
    coord, jparams, tparams = _hessian_case(kind)
    ref = np.asarray(jpar.sharded_hessian(
        coord, jparams, jpar.make_mesh(8, row_axis=4), dtype=jnp.float64))
    dense = np.asarray(jassembly.hessian_matrix(coord, jparams, jnp,
                                                dtype=np.float64))
    got = tpar.sharded_hessian(coord, tparams, _mesh(4),
                               dtype=torch.float64)
    assert isinstance(got, tmesh.ShardedTensor) and got.dim == 0
    assert len(got.shards) == 4
    assert np.allclose(got.full().numpy(), ref, atol=1e-12)
    assert np.allclose(got.full().numpy(), dense, atol=1e-12)


def _patched(module, n):
    return module.PatchedForceField(module.InvariantForceField(8.0),
                                    contact_shutdown=[0, 5]) \
        .to_params(natoms=n)


def test_sharded_hessian_refuses_overlays():
    coord = _conformers(1, 32, seed=6)[0]
    for package, params in ((jpar, _patched(sc, 32)),
                            (tpar, _patched(sct, 32))):
        mesh = (jpar.make_mesh(8, row_axis=4) if package is jpar
                else _mesh(4))
        with pytest.raises(NotImplementedError):
            package.sharded_hessian(coord, params, mesh)
    with pytest.raises(ValueError, match="divisible by the row axis"):
        tpar.sharded_hessian(_conformers(1, 30)[0],
                             sct.invariant_params(9.0), _mesh(4))


@pytest.mark.parametrize("dtype, tol", [("float64", 1e-10),
                                        ("float32", 1e-4)])
@pytest.mark.parametrize("family", ["invariant", "pfenm", "compact"])
def test_sharded_hessian_apply_matches_jax(family, dtype, tol):
    """The row-sharded operator: in float64 the plain row blocks, in
    float32 K12's plain version over each device's row range."""
    if family == "compact":
        coord, jparams, tparams = _hessian_case("compact")
    elif family == "pfenm":
        coord = _conformers(1, 40, seed=2)[0]
        jparams, tparams = jff.pfenm_params(None), sct.pfenm_params(None)
    else:
        coord = _conformers(1, 40, seed=2)[0]
        jparams, tparams = jff.invariant_params(9.0), \
            sct.invariant_params(9.0)
    x = np.random.RandomState(3).randn(3 * len(coord), 5).astype(dtype)
    ref = np.asarray(jpar.sharded_hessian_apply(
        coord.astype(dtype), x, jparams, jpar.make_mesh(8, row_axis=2),
        block=4, dtype=jnp.dtype(dtype)))
    got = tpar.sharded_hessian_apply(coord.astype(dtype), x, tparams,
                                     _mesh(2), block=4,
                                     dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    assert _rel(got, ref) <= tol
    vec = tpar.sharded_hessian_apply(coord, x[:, 0], tparams, _mesh(2),
                                     dtype=getattr(torch, dtype))
    assert tuple(vec.shape) == (3 * len(coord),)


def test_sharded_hessian_apply_keeps_overlays():
    """The JAX package's sharded operator drops patch overlays (it
    rebuilds the parameters from the kind, the cutoff and the bins,
    ``springcraft_tpu/parallel/sharded.py:201-203``): its product equals
    the unpatched operator's.  The port's equals the JAX single-device
    patched ``matfree.hessian_apply`` within 1e-12 of max."""
    coord = _conformers(1, 32, seed=6)[0]
    x = np.random.RandomState(4).randn(96, 3)
    jparams = _patched(sc, 32)
    patched = np.asarray(jmf.hessian_apply(coord, x, jparams,
                                           dtype=jnp.float64))
    unpatched = np.asarray(jmf.hessian_apply(
        coord, x, dataclasses.replace(jparams, overlays=()),
        dtype=jnp.float64))
    jax_sharded = np.asarray(jpar.sharded_hessian_apply(
        coord, x, jparams, jpar.make_mesh(8, row_axis=2),
        dtype=jnp.float64))
    assert np.abs(patched - unpatched).max() > 1.0
    assert np.abs(jax_sharded - unpatched).max() <= 1e-12 * np.abs(
        unpatched).max()
    tparams = _patched(sct, 32)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        got = tpar.sharded_hessian_apply(coord, x, tparams, _mesh(2),
                                         dtype=dtype)
        assert _rel(got, patched) <= tol, dtype


def test_sharded_lowest_modes_matfree_matches_jax():
    coord = _conformers(1, 40, seed=6)[0]
    options = dict(degree=48, n_outer=8, block=8, oversample=6)
    ref_vals, _, _ = jpar.sharded_lowest_modes_matfree(
        coord, jff.invariant_params(10.0), jpar.make_mesh(8, row_axis=2), 4,
        dtype=jnp.float64, **options)
    vals, vecs, res = tpar.sharded_lowest_modes_matfree(
        coord, sct.invariant_params(10.0), _mesh(2), 4,
        dtype=torch.float64, **options)
    assert tuple(vecs.shape) == (4, 120) and tuple(res.shape) == (4,)
    assert np.allclose(vals.numpy(), np.asarray(ref_vals), rtol=1e-6)
    with pytest.raises(ValueError, match="mesh places the shards"):
        tpar.sharded_lowest_modes_matfree(
            coord, sct.invariant_params(10.0), _mesh(2), 4, device="cpu")


def test_sharded_lowest_modes_matches_jax():
    coord = _conformers(1, 40, seed=6)[0]
    ref_vals, _ = jpar.sharded_lowest_modes(
        coord, jff.invariant_params(10.0), jpar.make_mesh(8, row_axis=4),
        k=6, dtype=jnp.float64, n_iter=300)
    vals, vecs = tpar.sharded_lowest_modes(
        coord, sct.invariant_params(10.0), _mesh(4), k=6,
        dtype=torch.float64, n_iter=300)
    h = np.asarray(jassembly.hessian_matrix(
        coord, jff.invariant_params(10.0), jnp, layout="atom"))
    truth = np.linalg.eigvalsh(h)[6:12]
    assert tuple(vecs.shape) == (6, 120)
    assert np.allclose(vals.numpy(), np.asarray(ref_vals), rtol=1e-6)
    assert np.allclose(vals.numpy(), truth, rtol=1e-6)


def test_sharded_covariance_matches_jax():
    coord = _conformers(1, 40, seed=6)[0]
    ref = np.asarray(jpar.sharded_covariance(
        coord, jff.invariant_params(10.0), jpar.make_mesh(8, row_axis=2),
        dtype=jnp.float64))
    got = tpar.sharded_covariance(coord, sct.invariant_params(10.0),
                                  _mesh(2), dtype=torch.float64)
    assert isinstance(got, tmesh.ShardedTensor) and got.dim == 1
    h = np.asarray(jassembly.hessian_matrix(
        coord, jff.invariant_params(10.0), jnp, layout="atom"))
    pinv = np.linalg.pinv(h, hermitian=True, rcond=1e-6)
    assert np.allclose(got.full().numpy(), ref, atol=1e-8)
    assert np.allclose(got.full().numpy(), pinv, atol=1e-8)
    with pytest.raises(ValueError, match="divisible by the mesh size"):
        tpar.sharded_covariance(_conformers(1, 30)[0],
                                sct.invariant_params(10.0), _mesh(2))


def test_sharded_anm_pipeline_matches_jax():
    coord = _conformers(1, 40, seed=6)[0]
    ref = _np(jpar.sharded_anm_pipeline(
        coord, jff.invariant_params(10.0), jpar.make_mesh(8, row_axis=4),
        dtype=jnp.float64, n_modes=20))
    got = tpar.sharded_anm_pipeline(coord, sct.invariant_params(10.0),
                                    _mesh(4), dtype=torch.float64,
                                    n_modes=20)
    assert set(got) == set(ref)
    for key, value in got.items():
        assert np.allclose(value.numpy(), ref[key], atol=1e-9), key
    with pytest.raises(ValueError, match=r"n_modes=200 must be in \[1, "
                                         r"114\]"):
        tpar.sharded_anm_pipeline(coord, sct.invariant_params(10.0),
                                  _mesh(4), n_modes=200)


# ---------------------------------------------------------------------------
# K12 over a row range: the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["invariant", "pfenm"])
@pytest.mark.parametrize("start, rows", [(0, 10), (13, 20), (63, 7),
                                         (0, 70)])
def test_k12_plain_row_range_equals_full_call(family, start, rows):
    """The rows of a range are the same rows of the full call, bit for
    bit (the same row tiles, the same sums), and the full range is the
    full call."""
    rng = np.random.RandomState(0)
    coord = torch.as_tensor(rng.rand(70, 3) * 15, dtype=torch.float32)
    x = torch.as_tensor(rng.randn(210, 6), dtype=torch.float32)
    params = (sct.invariant_params(8.0) if family == "invariant"
              else sct.pfenm_params(None))
    full = tmf.hessian_apply_dense_plain(coord, x, params, tile=16)
    part = tmf.hessian_apply_dense_plain(coord, x, params, tile=16,
                                         row_start=start, n_rows=rows)
    want = full.reshape(3, 70, 6)[:, start:start + rows].reshape(-1, 6)
    assert torch.equal(part, want)
    wrapper = tmf._launch_dense(coord, x, params, 16, start, rows)
    assert torch.equal(wrapper, want)
    with pytest.raises(ValueError, match="outside the 70 atoms"):
        tmf.hessian_apply_dense_plain(coord, x, params, row_start=65,
                                      n_rows=10)
