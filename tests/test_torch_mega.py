"""
PyTorch port, the mega-assembly north star (``bench.py::bench_mega_tpu``)
at small sizes on the CPU: the chain ``hessian_pallas`` ->
``lowest_modes_anm`` -> ``mode_residuals`` -> ``refine_modes_f64`` and
the all-mode ``pinv_diagonal``, each against the JAX package's (Pallas in
interpret mode), float64; the inputs of ``chip_smoke.py``'s north-star
phases against ``bench.make_ca_atoms`` bit for bit; and the metadata of
the committed float64 golden the card's all-mode MSF is held to.

Tolerances: both chains run the same float64 algorithm (the ``"chol"``
engine on the CPU in both packages) from the same start block, so the
eigenvalues agree to 1e-8 relative; ``pinv_diagonal`` is one float64
Cholesky and triangular solves, 1e-10 relative.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from springcraft_tpu.models import TabulatedForceField as JTab  # noqa: E402
from springcraft_tpu.ops import modes as jmodes  # noqa: E402
from springcraft_tpu.ops import pallas_kernels as jkernels  # noqa: E402
from springcraft_tpu.ops import rigid as jrigid  # noqa: E402
import springcraft_tpu_torch as sct  # noqa: E402
from springcraft_tpu_torch.ops import modes, pallas_kernels, rigid  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "golden_mega_msf_20736.npz")
COMPACT_FIELDS = ("type_idx", "chain_code", "bonded_next", "intra_table",
                  "inter_table", "bonded_table")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_{name}_under_test", os.path.join(ROOT, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def makers():
    """``(bench.make_ca_atoms, chip_smoke.make_ca_atoms)``."""
    return _load("bench").make_ca_atoms, _load("chip_smoke").make_ca_atoms


def _systems(makers, n, seed):
    """The same sdENM system in both packages: ``(coord, JAX params,
    port params)``."""
    jatoms, tatoms = (make(n, seed=seed) for make in makers)
    return (jatoms.coord,
            JTab.sd_enm(jatoms).to_compact_params(),
            sct.TabulatedForceField.sd_enm(tatoms).to_compact_params())


def _rel(got, ref):
    got = np.asarray(torch.as_tensor(got).double())
    ref = np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref) / np.abs(ref))


@pytest.mark.parametrize("n, seed", [(10_000, 2), (1000, 3), (6912, 5)])
def test_chip_smoke_inputs_are_the_benchs(makers, monkeypatch, n, seed):
    jatoms, tatoms = (make(n, seed=seed) for make in makers)
    assert tatoms.coord.dtype == jatoms.coord.dtype == np.float32
    assert np.array_equal(tatoms.coord, jatoms.coord)
    for field in ("res_name", "atom_name", "element", "chain_id", "res_id"):
        assert np.array_equal(getattr(tatoms, field),
                              getattr(jatoms, field)), field
    if n != 6912:
        return
    # the JAX force field builds its (n, n, 26) table at construction
    # (9.9 GB here); its compact parameters read only the per-atom
    # metadata, so the table is left out
    monkeypatch.setattr(JTab, "_build_interaction_matrix", lambda self: None)
    jparams = JTab.sd_enm(jatoms).to_compact_params()
    fields = {f.name: getattr(jparams, f.name)
              for f in dataclasses.fields(jparams)}
    for name in COMPACT_FIELDS:
        fields[name] = np.asarray(fields[name])
    carried = sct.from_numpy_params(fields)
    tparams = sct.TabulatedForceField.sd_enm(tatoms).to_compact_params()
    assert carried == tparams
    for name in COMPACT_FIELDS:
        assert np.array_equal(getattr(tparams, name),
                              np.asarray(getattr(jparams, name))), name


def test_golden_metadata():
    golden = np.load(GOLDEN)
    assert int(golden["n_res"]) == 6912 and int(golden["seed"]) == 5
    msf = np.asarray(golden["msf"])
    assert msf.shape == (6912,) and msf.dtype == np.float64
    assert np.all(np.isfinite(msf)) and np.all(msf > 0)
    assert float(golden["sigma"]) > 0


def test_north_star_chain_matches_jax(makers):
    coord, jparams, tparams = _systems(makers, 300, 2)
    k = 8
    jh = jkernels.hessian_pallas(coord, jparams, dtype=jnp.float64,
                                 interpret=True)
    jvals, jvecs = jmodes.lowest_modes_anm(jh, coord, k=k)
    jres = jmodes.mode_residuals(jh, jvals, jvecs)
    jref = jmodes.refine_modes_f64(np.asarray(coord), jparams,
                                   np.asarray(jvecs), layout="xyz")

    h = pallas_kernels.hessian_pallas(coord, tparams, dtype=torch.float64,
                                      device="cpu")
    vals, vecs = modes.lowest_modes_anm(h, torch.from_numpy(coord), k=k)
    res = modes.mode_residuals(h, vals, vecs)
    ref = modes.refine_modes_f64(coord, tparams, vecs, layout="xyz")

    assert h.shape == (900, 900) and vals.dtype == torch.float64
    assert _rel(vals, jvals) <= 1e-8
    # JAX's final block leaves residuals up to 5e-8, the port's up to
    # 8e-9: the port's are held to JAX's
    assert np.all(res.numpy() <= np.asarray(jres) + 1e-8)
    assert float(np.max(np.asarray(jres))) <= 1e-6
    assert _rel(ref[0], jref[0]) <= 1e-8
    assert float(ref[2].max()) <= 1e-8
    truth = np.linalg.eigvalsh(h.numpy())[6:6 + k]
    assert _rel(ref[0], truth) <= 1e-8


def test_pinv_diagonal_matches_jax(makers):
    coord, jparams, tparams = _systems(makers, 240, 5)
    jh = jkernels.hessian_pallas(coord, jparams, dtype=jnp.float64,
                                 interpret=True)
    jt = jrigid.rigid_modes_anm(jnp.asarray(coord, jnp.float64),
                                layout="xyz")
    ref = np.asarray(jrigid.pinv_diagonal(jh, jt, block_size=144))

    h = pallas_kernels.hessian_pallas(coord, tparams, dtype=torch.float64,
                                      device="cpu")
    t = rigid.rigid_modes_anm(torch.from_numpy(coord).double(), layout="xyz")
    got = rigid.pinv_diagonal(h, t, block_size=144, donate=True)
    assert got.shape == (720,)
    assert _rel(got, ref) <= 1e-10
    exact = np.diagonal(np.linalg.pinv(jh, hermitian=True))
    assert _rel(got, exact) <= 1e-8
