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
                 "springcraft_tpu_torch.ops.matfree, "
                 "springcraft_tpu_torch.models, "
                 "springcraft_tpu_torch.models.forcefield, "
                 "springcraft_tpu_torch.structure, "
                 "springcraft_tpu_torch.structure.pdb, "
                 "springcraft_tpu_torch.structure.celllist, "
                 "springcraft_tpu_torch.structure.info, "
                 "springcraft_tpu_torch.utils.network, "
                 "springcraft_tpu_torch.ops.linalg, "
                 "springcraft_tpu_torch.nma, springcraft_tpu_torch.anm, "
                 "springcraft_tpu_torch.gnm, "
                 "springcraft_tpu_torch.interaction, "
                 "springcraft_tpu_torch.forcefield, "
                 "springcraft_tpu_torch.parallel.pipeline, "
                 "springcraft_tpu_torch.parallel.mesh, "
                 "springcraft_tpu_torch.parallel.sharded, "
                 "springcraft_tpu_torch.parallel.blocked, "
                 "springcraft_tpu_torch.ops.pallas_kernels, "
                 "springcraft_tpu_torch.ops.pallas_linalg, "
                 "springcraft_tpu_torch.utils.profiling, "
                 "springcraft_tpu_torch.io, "
                 "springcraft_tpu_torch.structure.cif, "
                 "springcraft_tpu_torch.structure.bcif, "
                 "springcraft_tpu_torch.utils.elastic; "
                 "bad = sorted(m for m in sys.modules if m == 'jax' or "
                 "m.startswith(('jax.', 'springcraft_tpu.'))"
                 " or m == 'springcraft_tpu'); print(bad)"], cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_entry_points_are_exported():
    for name in ("anm_fluctuations", "gnm_fluctuations",
                 "ensemble_anm_fluctuations", "ensemble_gnm_fluctuations",
                 "anm_observables", "gnm_observables", "ensemble_anm",
                 "ensemble_gnm", "anm_spectral", "gnm_spectral",
                 "ensemble_anm_spectral", "ensemble_gnm_spectral",
                 "ensemble_anm_banded", "ensemble_gnm_banded",
                 "lowest_modes_matfree", "lowest_modes_matfree_gnm",
                 "estimate_lambda_max", "covariance_solve_matfree",
                 "covariance_solve_matfree_gnm", "linear_response_matfree",
                 "prs_rows_matfree", "dcc_rows_matfree",
                 "dcc_rows_matfree_gnm", "prs_diag_from_modes",
                 "effector_sensor_from_modes", "effector_sensor_matfree",
                 "prs_diag_stochastic", "msf_stochastic",
                 "msf_stochastic_gnm", "effector_sensor_stochastic",
                 "kernel_wrappers",
                 "TabulatedForceField", "InvariantForceField",
                 "HinsenForceField", "ParameterFreeForceField",
                 "PatchedForceField", "PatchOverlay", "with_overlay",
                 "strip_overlays", "load_structure", "table_pair_params",
                 "table_compact_params", "panel_cholesky_batched",
                 "panel_inverse_batched", "spd_inverse_blocked"):
        assert name in sct.__all__ and callable(getattr(sct, name))
    from springcraft_tpu_torch.ops import assembly, ffparams, matfree

    for module, names in (
            (ffparams, ("overlay_candidate_pairs", "pair_base_constants",
                        "overlay_pair_delta", "effective_adjacency",
                        "force_constants")),
            (assembly, ("overlay_correction_hessian_xyz",
                        "overlay_correction_kirchhoff")),
            (matfree, ("overlay_apply_hessian", "overlay_apply_kirchhoff"))):
        for name in names:
            assert name in module.__all__ and callable(getattr(module, name))
    # the JAX package's ops-level names (springcraft_tpu/ops/__init__.py)
    from springcraft_tpu_torch import ops

    for name in ("effector_sensor_from_modes", "effector_sensor_matfree",
                 "effector_sensor_stochastic", "msf_stochastic",
                 "msf_stochastic_gnm", "prs_diag_from_modes",
                 "prs_diag_stochastic", "kirchhoff_degree",
                 "hessian_matrix", "pinvh", "refine_modes_f64",
                 "eigh_banded", "null_mode_gnm", "FFParams"):
        assert name in ops.__all__ and getattr(ops, name) is not None
    for name in ("prs_diag_from_modes", "effector_sensor_from_modes",
                 "effector_sensor_matfree", "prs_diag_stochastic",
                 "msf_stochastic", "msf_stochastic_gnm",
                 "effector_sensor_stochastic"):
        assert name in matfree.__all__
        assert getattr(sct, name) is getattr(ops, name) \
            is getattr(matfree, name)


def test_every_c_entry_point_has_a_wrapper():
    """Each kernel's C entry is named in the build's signatures, and
    every shared-memory or grid limit a wrapper checks is its own."""
    entries = set(_build._SIGNATURES) - {"sc_error_string"}
    assert entries == {"sc_hessian_planes", "sc_hessian_xyz",
                       "sc_kirchhoff", "sc_regularize_stitch",
                       "sc_panel_inverse", "sc_panel_inverse_full",
                       "sc_panel_cholesky", "sc_assembly_stitch",
                       "sc_assembly_row_sums",
                       "sc_banded_bisect",
                       "sc_banded_eigvec", "sc_pair_csr_count",
                       "sc_pair_csr_fill", "sc_hessian_apply_pairs",
                       "sc_hessian_apply_dense", "sc_kirchhoff_apply_pairs",
                       "sc_chol_solve"}
    sources = "".join(p.read_text() for p in _build.SOURCES)
    for entry in entries:
        assert f'extern "C" int {entry}(' in sources, entry


def test_float32_products_stay_full_precision():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_resolve_device():
    """Entry points default to the card: ``None`` is the current CUDA
    device, and raises naming cuda where there is none."""
    assert sct.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        sct.resolve_device(None)
    with pytest.raises(RuntimeError, match="cuda"):
        sct.resolve_device("cuda")


def test_kernel_library_is_named_by_its_sources():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("springcraft_kernels_")
    assert {p.name for p in _build.SOURCES} >= {
        "hessian_planes.cu", "regularize_stitch.cu", "panel_inverse.cu",
        "kirchhoff.cu", "banded_bisect.cu", "banded_eigvec.cu",
        "matfree_hessian.cu", "matfree_kirchhoff.cu", "matfree_pairs.cu",
        "assembly_stitch.cu", "panel_cholesky.cu", "chol_solve.cu"}
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert set(sct.kernel_wrappers()) == {"hessian_planes",
                                          "regularize_stitch",
                                          "panel_inverse", "kirchhoff",
                                          "hessian_xyz", "banded_bisect",
                                          "banded_eigvec",
                                          "hessian_apply_dense",
                                          "hessian_apply_sparse",
                                          "kirchhoff_apply_sparse",
                                          "assembly_stitch",
                                          "panel_cholesky",
                                          "panel_inverse_full",
                                          "pair_csr", "chol_solve"}
    for wrapper in sct.kernel_wrappers().values():
        assert isinstance(wrapper.launches, int)
    for name in ("hessian_planes", "hessian_xyz", "kirchhoff",
                 "hessian_apply_dense", "pair_csr"):
        assert isinstance(sct.kernel_wrappers()[name].table_launches, int)


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
