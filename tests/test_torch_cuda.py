"""
PyTorch port on the card: each CUDA kernel against its plain PyTorch
version on the same CUDA tensors, at small and edge shapes, and the
slice on CUDA against the float64 ``cho_solve`` engine.

Marked ``cuda``: every test skips without an NVIDIA GPU.  This file
imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch (skip the JAX test configuration there)::

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances as in ``chip_smoke.py``: 1e-5 of max|x| for the assembly and
the stitch, 2e-5 absolute for unit-scale panels, 1e-4 of max|x| for the
float32 slice against float64.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import springcraft_tpu_torch as sct  # noqa: E402
from springcraft_tpu_torch.ops import assembly, assembly_kernels  # noqa: E402
from springcraft_tpu_torch.ops import rigid, spd_linalg  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _coords(b, n, seed, spread=6.0):
    rng = np.random.RandomState(seed)
    base = (rng.rand(n, 3) * spread).astype(np.float32)
    return base[None] + 0.05 * rng.randn(b, n, 3).astype(np.float32)


def _rel(got, ref):
    diff = (got.double() - ref.double()).abs().max()
    return float(diff / ref.double().abs().max())


def _spd_panels(count, pb, seed):
    rng = np.random.RandomState(seed)
    a = rng.randn(count, pb, pb)
    a = a @ a.transpose(0, 2, 1) / pb + 0.5 * np.eye(pb)
    d = 1.0 / np.sqrt(np.diagonal(a, axis1=1, axis2=2))
    return (a * d[:, :, None] * d[:, None, :]).astype(np.float32)


@pytest.mark.parametrize("kind,cutoff", [("invariant", 7.0),
                                         ("hinsen", 7.0), ("hinsen", None),
                                         ("pfenm", 7.0)])
@pytest.mark.parametrize("b,n", [(3, 41), (2, 300), (1, 5)])
def test_hessian_planes_kernel(cuda, kind, cutoff, b, n):
    params = getattr(sct, f"{kind}_params")(cutoff)
    coords = torch.as_tensor(_coords(b, n, seed=n), device=cuda)
    before = assembly_kernels.hessian_planes_ensemble.launches
    got = assembly_kernels.hessian_planes_ensemble(coords, params)
    assert assembly_kernels.hessian_planes_ensemble.launches == before + 1
    ref = assembly.hessian_planes_plain(coords, params)
    torch.cuda.synchronize()
    assert got.shape == (9, b, n, n) and got.device == coords.device
    assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("b,n,mp", [(3, 41, 128), (2, 32, 96),
                                    (2, 100, 384)])
def test_regularize_stitch_kernel(cuda, b, n, mp):
    coords = torch.as_tensor(_coords(b, n, seed=n), device=cuda)
    planes = assembly.hessian_planes_plain(coords, sct.invariant_params(7.0))
    masses = torch.linspace(0.8, 2.5, n, device=cuda)
    bases = rigid.rigid_modes_anm(coords, masses=masses)
    _, _, scale_h, ts = rigid.stitch_inputs(planes, bases, masses=masses)
    before = assembly_kernels.regularize_stitch.launches
    got = assembly_kernels.regularize_stitch(planes, scale_h, ts, mp)
    assert assembly_kernels.regularize_stitch.launches == before + 1
    ref = assembly_kernels.regularize_stitch_plain(planes, scale_h, ts, mp)
    torch.cuda.synchronize()
    assert got.shape == (b, mp, mp)
    assert _rel(got, ref) <= 1e-5
    assert torch.equal(got[:, 3 * n:, :], ref[:, 3 * n:, :])


@pytest.mark.parametrize("pb", [8, 16, 64])
def test_panel_inverse_kernel(cuda, pb):
    panels = torch.as_tensor(_spd_panels(5, pb, seed=pb), device=cuda)
    before = spd_linalg.panel_inverse_batched.launches
    got = spd_linalg.panel_inverse_batched(panels)
    assert spd_linalg.panel_inverse_batched.launches == before + 1
    ref = spd_linalg.panel_inverse_plain(panels)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 2e-5
    upper = torch.triu(got, diagonal=1)
    assert torch.equal(upper, torch.zeros_like(upper))


def test_panel_inverse_kernel_breakdown_is_not_finite(cuda):
    panels = _spd_panels(3, 64, seed=1)
    panels[1, 5, 5] = -1.0
    got = spd_linalg.panel_inverse_batched(torch.as_tensor(panels,
                                                           device=cuda))
    assert not bool(torch.isfinite(got[1]).all())
    assert bool(torch.isfinite(got[0]).all())


def test_kernels_refuse_what_they_do_not_take(cuda):
    coords = torch.as_tensor(_coords(2, 10, seed=0), device=cuda)
    params = sct.invariant_params(7.0)
    with pytest.raises(TypeError, match="float32"):
        assembly_kernels.hessian_planes_ensemble(coords.double(), params)
    with pytest.raises(ValueError, match="contiguous"):
        assembly_kernels.hessian_planes_ensemble(
            coords.transpose(0, 1).contiguous().transpose(0, 1), params)
    with pytest.raises(ValueError, match="device"):
        assembly_kernels.regularize_stitch(
            torch.zeros(9, 2, 10, 10, device=cuda), torch.ones(2, 30),
            torch.zeros(2, 30, 6, device=cuda), 32)
    with pytest.raises(TypeError, match="float32"):
        spd_linalg.panel_inverse_batched(
            torch.eye(16, device=cuda, dtype=torch.float64).expand(2, 16,
                                                                  16))
    with pytest.raises(ValueError, match="exceeds"):
        spd_linalg.panel_inverse_batched(
            torch.eye(72, device=cuda).expand(2, 72, 72).contiguous())
    with pytest.raises(TypeError, match="float32"):
        sct.ensemble_anm_fluctuations(coords, params, inverse="blocked",
                                      dtype=torch.float64)


@pytest.mark.parametrize("with_masses", [False, True])
def test_slice_on_cuda(cuda, with_masses):
    coords = _coords(4, 100, seed=3, spread=34.0 * (1 / 3) ** (1 / 3))
    masses = (np.linspace(0.8, 2.5, 100).astype(np.float32)
              if with_masses else None)
    params = sct.invariant_params(13.0)
    wrappers = sct.kernel_wrappers()
    before = {k: w.launches for k, w in wrappers.items()}
    got = sct.ensemble_anm_fluctuations(coords, params, masses=masses,
                                        inverse="blocked", device="cuda")
    for name, w in wrappers.items():
        assert w.launches > before[name], name
    chunked = sct.ensemble_anm_fluctuations(
        coords, params, masses=masses, inverse="blocked", chunk=2,
        device="cuda")
    ref = sct.ensemble_anm_fluctuations(
        coords.astype(np.float64), params,
        masses=None if masses is None else masses.astype(np.float64),
        inverse="cho_solve", dtype=torch.float64, device="cuda")
    cpu = sct.ensemble_anm_fluctuations(coords, params, masses=masses,
                                        inverse="blocked", device="cpu")
    for key in ("msf", "bfactor", "dcc"):
        assert got[key].device.type == "cuda"
        assert _rel(got[key], ref[key]) <= 1e-4, key
        assert _rel(got[key], cpu[key].to(cuda)) <= 1e-4, key
        assert _rel(chunked[key], got[key]) <= 1e-6, key
