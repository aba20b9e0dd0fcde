"""
PyTorch port, the distributed blocked Cholesky
(``springcraft_tpu_torch.parallel.blocked``) against the JAX package's on
the same numpy inputs, on the CPU (the port on meshes of eight
``torch.device("cpu")`` entries, the JAX package on the eight virtual
devices of ``tests/conftest.py``), and the port counterparts of the 14
asserted blocks of ``__graft_entry__.dryrun_multichip`` at its shapes
(``chip_smoke.dryrun_blocks``, which the card runs too).

Tolerances (``tests/test_parallel.py``): the factor and the solves
1e-9, the covariance and the all-mode MSF against the JAX package and
``pinv(hessian, rcond=1e-6)`` 1e-8 (float64); float32 1e-4 of max|ref|;
the dryrun's own engine cross-checks 1e-3.
"""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from springcraft_tpu import parallel as jpar  # noqa: E402
from springcraft_tpu.ops import assembly as jassembly  # noqa: E402
from springcraft_tpu.ops import ffparams as jff  # noqa: E402
from springcraft_tpu.parallel import blocked as jblocked  # noqa: E402
import springcraft_tpu_torch as sct  # noqa: E402
from springcraft_tpu_torch import parallel as tpar  # noqa: E402
from springcraft_tpu_torch.parallel import mesh as tmesh  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = [torch.device("cpu")] * 8


def _conformers(n_batch, n_atoms, seed=0, jitter=0.05):
    rng = np.random.RandomState(seed)
    base = rng.rand(n_atoms, 3) * 10
    return base[None] + jitter * rng.randn(n_batch, n_atoms, 3)


def _mesh(row_axis):
    return tpar.make_mesh(8, row_axis=row_axis, devices=CPU8)


def _spd(n=48, seed=7):
    rng = np.random.RandomState(seed)
    a = rng.randn(n, n)
    return a @ a.T + n * np.eye(n)


def _full(x):
    return (x.full() if isinstance(x, tmesh.ShardedTensor) else x).numpy()


@pytest.mark.parametrize("sharded", [False, True])
def test_blocked_cholesky_and_solves_match_jax(sharded):
    """n = 48 in panels of 12; sharded, the factor in 8 row shards of 6
    rows (panels straddle shards) and the right-hand side in 8 column
    shards."""
    a = _spd()
    rhs = np.random.RandomState(8).randn(48, 16)
    ref_l = np.asarray(jblocked.blocked_cholesky(jnp.asarray(a), 12))
    ref_y = np.asarray(jblocked.blocked_solve_lower(
        jnp.asarray(ref_l), jnp.asarray(rhs), 12))
    ref_x = np.asarray(jblocked.blocked_solve_lower_t(
        jnp.asarray(ref_l), jnp.asarray(rhs), 12))
    mesh = _mesh(2)
    rows = tmesh.Sharding(mesh, 0) if sharded else None
    cols = tmesh.Sharding(mesh, 1) if sharded else None
    a_t, rhs_t = torch.as_tensor(a), torch.as_tensor(rhs)
    l = tpar.blocked_cholesky(a_t, 12, sharding=rows)
    y = tpar.blocked_solve_lower(l, rhs_t, 12, sharding=cols)
    x = tpar.blocked_solve_lower_t(l, rhs_t, 12, sharding=cols)
    assert isinstance(l, tmesh.ShardedTensor) == sharded
    if sharded:
        assert (l.dim, y.dim, len(l.shards), len(y.shards)) == (0, 1, 8, 8)
    assert np.array_equal(_full(l), np.tril(_full(l)))
    assert np.allclose(_full(l) @ _full(l).T, a, atol=1e-9)
    for got, ref in ((l, ref_l), (y, ref_y), (x, ref_x)):
        assert np.allclose(_full(got), ref, atol=1e-9)
    assert torch.equal(a_t, torch.as_tensor(a))      # inputs untouched


def test_blocked_refusals():
    mesh = _mesh(2)
    a = torch.as_tensor(_spd())
    with pytest.raises(ValueError, match="must divide"):
        tpar.blocked_cholesky(a, 10)
    with pytest.raises(ValueError, match="split by rows"):
        tpar.blocked_cholesky(a, 12, sharding=tmesh.Sharding(mesh, 1))
    with pytest.raises(ValueError, match="split by columns"):
        tpar.blocked_solve_lower(a, a, 12, sharding=tmesh.Sharding(mesh, 0))


@pytest.fixture(scope="module")
def pinvh_case():
    """``tests/test_parallel.py``'s case: 48 atoms, invariant 10 A, the
    JAX package's covariance and MSF on its 8-device mesh (row axis 2,
    panels of 16), and ``pinv(hessian, rcond=1e-6)``."""
    coord = _conformers(1, 48, seed=6)[0].astype(np.float64)
    params = jff.invariant_params(10.0)
    mesh = jpar.make_mesh(8, row_axis=2)
    h = np.asarray(jassembly.hessian_matrix(coord, params, jnp,
                                            layout="atom"))
    return {
        "coord": coord,
        "pinv": np.linalg.pinv(h, hermitian=True, rcond=1e-6),
        "cov": np.asarray(jpar.sharded_covariance_blocked(
            coord, params, mesh, block=16, dtype=jnp.float64)),
        "msf": {key: np.asarray(value) for key, value in
                jpar.sharded_all_mode_msf(coord, params, mesh, block=16,
                                          dtype=jnp.float64).items()},
    }


@pytest.mark.parametrize("row_axis", [2, 8])
def test_blocked_covariance_and_msf_match_jax(pinvh_case, row_axis):
    """Float64: the covariance and the one-solve MSF against the JAX
    package's and ``pinvh`` within 1e-8 (the Hessian born in 2 or 8 row
    shards, refactored in 8)."""
    coord, mesh = pinvh_case["coord"], _mesh(row_axis)
    params = sct.invariant_params(10.0)
    cov = tpar.sharded_covariance_blocked(coord, params, mesh, block=16,
                                          dtype=torch.float64)
    assert isinstance(cov, tmesh.ShardedTensor) and cov.dim == 1
    assert len(cov.shards) == 8
    assert np.allclose(cov.full().numpy(), pinvh_case["cov"], atol=1e-8)
    assert np.allclose(cov.full().numpy(), pinvh_case["pinv"], atol=1e-8)

    out = tpar.sharded_all_mode_msf(coord, params, mesh, block=16,
                                    dtype=torch.float64)
    n = coord.shape[0]
    truth = np.einsum("iaia->i", pinvh_case["pinv"].reshape(n, 3, n, 3))
    for key, value in out.items():
        assert np.allclose(value.numpy(), pinvh_case["msf"][key],
                           atol=1e-8), key
    assert np.allclose(out["msf"].numpy(), truth, atol=1e-8)
    assert np.allclose(out["bfactor"].numpy(), 8 * np.pi**2 / 3 * truth,
                       atol=1e-7)


def test_all_mode_msf_float32_matches_jax():
    """The dryrun's case in float32 (32 atoms at 8 A in a 12 A box,
    panels of 16): 1e-4 of max against the JAX package's float32."""
    rng = np.random.RandomState(0)
    coord = rng.rand(32, 3).astype(np.float32) * 12.0
    ref = np.asarray(jpar.sharded_all_mode_msf(
        coord, jff.invariant_params(8.0), jpar.make_mesh(8, row_axis=2),
        block=16, dtype=jnp.float32)["msf"])
    got = tpar.sharded_all_mode_msf(coord, sct.invariant_params(8.0),
                                    _mesh(2), block=16)["msf"]
    assert got.dtype == torch.float32
    assert np.max(np.abs(got.numpy() - ref)) <= 1e-4 * np.abs(ref).max()


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_under_test", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("n_devices", [8, 4, 1])
def test_dryrun_blocks(chip_smoke, n_devices):
    """The 14 blocks on a CPU mesh of 8 (row axis 2: 32 atoms, 16
    conformers), 4 and 1 entries, each with the dryrun's checks."""
    blocks = chip_smoke.dryrun_blocks([torch.device("cpu")] * n_devices)
    assert [label for label, _ in blocks] == [
        "1", "2", "2b", "3", "4", "5", "6", "6b", "6c", "7", "8", "8b",
        "8c", "9"]
    for _, run in blocks:
        run()
