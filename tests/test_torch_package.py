"""
PyTorch port, package level: it imports without JAX, pins float32
matrix products to full precision, refuses CUDA without a card, and
``chip_smoke.py`` stops before building anything without one.  Also the
observables of ``ops.nma_core`` against the JAX package's (numpy
array module), on the same numpy inputs.
"""

import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from springcraft_tpu.ops import nma_core as jcore  # noqa: E402
import springcraft_tpu_torch as sct  # noqa: E402
from springcraft_tpu_torch import _build  # noqa: E402
from springcraft_tpu_torch.ops import nma_core as tcore  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_import_leaves_jax_out():
    proc = _run(["-c", "import sys, springcraft_tpu_torch, "
                 "springcraft_tpu_torch.ops.rigid, "
                 "springcraft_tpu_torch.parallel.pipeline; "
                 "bad = sorted(m for m in sys.modules if m == 'jax' or "
                 "m.startswith(('jax.', 'springcraft_tpu.'))"
                 " or m == 'springcraft_tpu'); print(bad)"], cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_float32_products_stay_full_precision():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_resolve_device():
    assert sct.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        sct.resolve_device(None)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        sct.resolve_device("cuda")


def test_kernel_library_is_named_by_its_sources():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("springcraft_kernels_")
    assert {p.name for p in _build.SOURCES} >= {
        "hessian_planes.cu", "regularize_stitch.cu", "panel_inverse.cu"}
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert set(sct.kernel_wrappers()) == {"hessian_planes",
                                          "regularize_stitch",
                                          "panel_inverse"}
    for wrapper in sct.kernel_wrappers().values():
        assert isinstance(wrapper.launches, int)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    if alone:
        cwd = tmp_path
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), cwd)
    else:
        cwd = ROOT
    before = sorted(os.listdir(cwd))
    proc = _run(["chip_smoke.py"], cwd=cwd, timeout=60)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert sorted(os.listdir(cwd)) == before          # nothing was built


# ---------------------------------------------------------------------------
# Observables (ops.nma_core)
# ---------------------------------------------------------------------------

def _modes(n_modes, m, seed):
    rng = np.random.RandomState(seed)
    vals = np.sort(rng.rand(n_modes) + 0.1)
    vecs = rng.randn(n_modes, m)
    return vals, vecs


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("layout", ["atom", "xyz"])
def test_mode_observables_match_jax(layout):
    vals, vecs = _modes(12, 30, seed=1)
    idx = np.arange(6, 12)
    np.testing.assert_allclose(
        tcore.mean_square_fluctuation(_t(vals), _t(vecs), _t(idx),
                                      layout=layout, tem=300.0).numpy(),
        jcore.mean_square_fluctuation(vals, vecs, idx, np, layout=layout,
                                      tem=300.0), rtol=1e-12)
    np.testing.assert_allclose(
        tcore.dcc_from_modes(_t(vals), _t(vecs), _t(idx),
                             layout=layout).numpy(),
        jcore.dcc_from_modes(vals, vecs, idx, np, layout=layout),
        rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(
        tcore.fold_modes(_t(vecs) ** 2, layout=layout).numpy(),
        jcore.fold_modes(vecs**2, np, layout=layout), rtol=1e-12)


def test_frequencies_and_bfactor_match_jax():
    vals = np.array([-1e-9, 2e-10, 0.5, 1.0, 4.0])
    np.testing.assert_allclose(
        tcore.frequencies_from_eigenvalues(_t(vals), 2).numpy(),
        jcore.frequencies_from_eigenvalues(vals, 2, np), rtol=1e-12)
    msf = np.random.RandomState(0).rand(3, 7)
    np.testing.assert_allclose(tcore.bfactor_from_msf(_t(msf)).numpy(),
                               jcore.bfactor_from_msf(msf), rtol=1e-12)
    assert math.isclose(tcore.K_B, jcore.K_B) and tcore.N_A == jcore.N_A


def test_covariance_observables_match_jax():
    rng = np.random.RandomState(3)
    a = rng.randn(24, 24)
    cov = a @ a.T
    np.testing.assert_allclose(
        tcore.dcc_from_covariance_anm(_t(cov)).numpy(),
        jcore.dcc_from_covariance_anm(cov, np), rtol=1e-12)
    dcc = jcore.dcc_from_covariance_anm(cov, np)
    np.testing.assert_allclose(tcore.normalize_dcc(_t(dcc)).numpy(),
                               jcore.normalize_dcc(dcc, np), rtol=1e-12)
    batched = tcore.normalize_dcc(_t(np.stack([dcc, 2 * dcc])))
    np.testing.assert_allclose(batched[1].numpy(),
                               jcore.normalize_dcc(dcc, np), rtol=1e-12)
    force = rng.randn(8, 3)
    np.testing.assert_allclose(
        tcore.linear_response_displacement(_t(cov), _t(force)).numpy(),
        jcore.linear_response_displacement(cov, force, np), rtol=1e-12)
    for norm in (True, False):
        np.testing.assert_allclose(
            tcore.prs_matrix(_t(cov), norm=norm).numpy(),
            jcore.prs_matrix(cov, np, norm=norm), rtol=1e-12)
    prs = jcore.prs_matrix(cov, np)
    for got, ref in zip(tcore.effector_sensor_profiles(_t(prs)),
                        jcore.effector_sensor_profiles(prs, np)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12)


@pytest.mark.parametrize("movement", ["sine", "triangle"])
def test_normal_mode_displacements_match_jax(movement):
    vec = np.random.RandomState(4).randn(21)
    np.testing.assert_allclose(
        tcore.normal_mode_displacements(_t(vec), 2.0, 10,
                                        movement=movement).numpy(),
        jcore.normal_mode_displacements(vec, 2.0, 10, np,
                                        movement=movement),
        rtol=1e-12, atol=1e-15)
    with pytest.raises(ValueError, match="unknown"):
        tcore.normal_mode_displacements(_t(vec), 2.0, 10, movement="saw")
