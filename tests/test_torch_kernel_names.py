"""
PyTorch port, the JAX kernel modules' public names
(``ops/pallas_kernels.py``, ``ops/pallas_linalg.py``, the three
``*_pallas*`` operators of ``ops/matfree.py``, ``banded_eigenvalues_pallas``,
``eigh_banded_staged`` and the legacy rank-2 path of ``ops/spectrum.py``)
and ``utils/profiling.py``, each held against the JAX function on the same
numpy inputs.  The JAX Pallas kernels run in interpret mode on the CPU;
the port runs its kernels' plain versions.

Tolerances: the names call the wrappers the other port tests hold to these
bounds — assembly 1e-5 of max in float32 and 1e-12 in float64, the
matrix-free operators 1e-5 of max in float32; the bisections share their
float64 Sturm counts (1e-10 of max), and the Householder reduction 1e-9 of
max (its entries depend on every earlier reflector's rounding).
"""

import inspect
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from springcraft_tpu.models import TabulatedForceField as JTab  # noqa: E402
from springcraft_tpu.ops import ffparams as jff  # noqa: E402
from springcraft_tpu.ops import matfree as jmatfree  # noqa: E402
from springcraft_tpu.ops import pallas_kernels as jkernels  # noqa: E402
from springcraft_tpu.ops import pallas_linalg as jlinalg  # noqa: E402
from springcraft_tpu.ops import spectrum as jspectrum  # noqa: E402
from springcraft_tpu.structure import AtomArray as JAtoms  # noqa: E402
import springcraft_tpu_torch as sct  # noqa: E402
from springcraft_tpu_torch import utils  # noqa: E402
from springcraft_tpu_torch.ops import assembly_kernels  # noqa: E402
from springcraft_tpu_torch.ops import matfree, pallas_kernels  # noqa: E402
from springcraft_tpu_torch.ops import pallas_linalg, spd_linalg  # noqa: E402
from springcraft_tpu_torch.ops import spectrum  # noqa: E402
from springcraft_tpu_torch.structure import AtomArray as TAtoms  # noqa: E402

AA20 = ("ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
        "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL")
#: Keywords of the JAX names that plan the TPU kernels; the port drops
#: them and adds ``device=`` where a name takes coordinates.
TPU_KEYWORDS = {"interpret", "batch_chunk", "batch_inner", "vmem_budget",
                "unroll"}


def _atoms(n, seed):
    """The same all-CA structure (random sequence, one chain, protein
    density) in both packages."""
    rng = np.random.RandomState(seed)
    coord = (rng.rand(n, 3) * (n / (300 / 34.0 ** 3)) ** (1 / 3)).astype(
        np.float32)
    names = np.array(AA20)[rng.randint(0, 20, n)]
    out = []
    for cls in (JAtoms, TAtoms):
        atoms = cls(n)
        atoms.coord = coord.copy()
        atoms.atom_name = np.full(n, "CA")
        atoms.element = np.full(n, "C")
        atoms.chain_id = np.full(n, "A")
        atoms.res_id = np.arange(1, n + 1)
        atoms.res_name = names.copy()
        out.append(atoms)
    return coord, out[0], out[1]


def _families(n, seed=2):
    """``{label: (coord, JAX params, port params)}``: the invariant field
    at 13 A and sdENM on the same atoms."""
    coord, jatoms, tatoms = _atoms(n, seed)
    return {
        "invariant": (coord, jff.invariant_params(13.0),
                      sct.invariant_params(13.0)),
        "sdENM": (coord, JTab.sd_enm(jatoms).to_compact_params(),
                  sct.TabulatedForceField.sd_enm(tatoms).to_compact_params()),
    }


def _rel(got, ref):
    got = np.asarray(torch.as_tensor(got).double())
    ref = np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _tolerance(dtype):
    return 1e-5 if dtype == "float32" else 1e-12


@pytest.fixture(scope="module")
def single():
    return _families(120)


@pytest.mark.parametrize("family", ["invariant", "sdENM"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["hessian_pallas", "kirchhoff_pallas"])
def test_single_structure_names_match_jax(single, family, dtype, name):
    coord, jparams, tparams = single[family]
    ref = getattr(jkernels, name)(coord, jparams, dtype=getattr(jnp, dtype),
                                  interpret=True)
    got = getattr(pallas_kernels, name)(coord, tparams,
                                        dtype=getattr(torch, dtype),
                                        device="cpu")
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == ref.shape
    assert _rel(got, ref) <= _tolerance(dtype)


def test_hessian_pallas_with_an_overlay_matches_jax(single):
    coord, jparams, tparams = single["invariant"]
    n = len(coord)
    off = np.zeros((n, n), bool)
    on = np.zeros((n, n), bool)
    values = np.zeros((n, n))
    off[0, 1] = off[1, 0] = True
    on[2, n - 1] = on[n - 1, 2] = True
    values[2, n - 1] = values[n - 1, 2] = 1.5
    ref = jkernels.hessian_pallas(
        coord, jff.with_overlay(jparams, off, on, values, on),
        dtype=jnp.float64, interpret=True)
    got = pallas_kernels.hessian_pallas(
        coord, sct.with_overlay(tparams, off, on, values, on),
        dtype=torch.float64, device="cpu")
    assert _rel(got, ref) <= 1e-12


@pytest.fixture(scope="module")
def ensemble():
    fams = _families(60, seed=4)
    rng = np.random.RandomState(5)
    return {label: ((coord[None] + 0.3 * rng.randn(4, *coord.shape)).astype(
        np.float32), jparams, tparams)
        for label, (coord, jparams, tparams) in fams.items()}


@pytest.mark.parametrize("family", ["invariant", "sdENM"])
@pytest.mark.parametrize("name", ["hessian_pallas_ensemble",
                                  "kirchhoff_pallas_ensemble"])
def test_ensemble_names_match_jax(ensemble, family, name):
    coords, jparams, tparams = ensemble[family]
    ref = getattr(jkernels, name)(coords, jparams, interpret=True)
    got = getattr(pallas_kernels, name)(coords, tparams, device="cpu")
    assert got.shape == ref.shape == (4,) + ref.shape[1:]
    assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("family", ["invariant", "sdENM"])
def test_raw_planes_match_jax(ensemble, family):
    coords, jparams, tparams = ensemble[family]
    n = coords.shape[1]
    ref = jkernels.hessian_pallas_ensemble(coords, jparams, interpret=True,
                                           raw_planes=True)
    got = pallas_kernels.hessian_pallas_ensemble(coords, tparams,
                                                 device="cpu",
                                                 raw_planes=True)
    assert isinstance(got, list) and len(got) == len(ref) == 9
    scale = max(float(np.abs(np.asarray(p)).max()) for p in ref)
    for plane, want in zip(got, ref):
        assert plane.shape == (4, n, n)
        assert np.max(np.abs(plane.numpy() - np.asarray(want)[:, :n, :n])) \
            <= 1e-5 * scale
    xyz = pallas_kernels.hessian_pallas_ensemble(coords, tparams,
                                                 device="cpu")
    assert xyz[:, :n, n:2 * n].equal(got[1])       # planes[3 a + b]


def test_names_refuse_what_the_jax_names_refuse(ensemble):
    coords, _, tparams = ensemble["invariant"]
    n = coords.shape[1]
    table = sct.table_pair_params(np.ones((n, n, 1)), None)
    with pytest.raises(ValueError, match="does not support"):
        pallas_kernels.hessian_pallas(coords[0], table, device="cpu")
    with pytest.raises(ValueError, match="does not support"):
        pallas_kernels.kirchhoff_pallas_ensemble(coords, table, device="cpu")
    mask = np.zeros((n, n), bool)
    mask[0, 1] = mask[1, 0] = True
    patched = sct.with_overlay(tparams, mask, mask * False, np.zeros((n, n)),
                               mask * False)
    with pytest.raises(ValueError, match="raw_planes"):
        pallas_kernels.hessian_pallas_ensemble(coords, patched, device="cpu",
                                               raw_planes=True)
    with pytest.raises(ValueError, match="coordinates"):
        pallas_kernels.hessian_pallas(coords, tparams, device="cpu")
    with pytest.raises(ValueError, match="precision"):
        matfree.hessian_apply_pallas_sparse(
            coords[0], np.zeros((3 * n, 1)), tparams, np.zeros((1, 1)),
            np.ones(1), device="cpu", precision="default")


def test_names_default_to_the_card(single):
    """Without ``device`` a numpy input goes to the current CUDA device;
    without a card that raises, naming cuda."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    coord, _, tparams = single["invariant"]
    with pytest.raises(RuntimeError, match="cuda"):
        pallas_kernels.hessian_pallas(coord, tparams)


def test_names_call_the_kernel_wrappers(single):
    """Each name reaches its kernel wrapper (here the wrapper's plain
    version; on a CUDA tensor the same call launches the kernel)."""
    coord, _, tparams = single["invariant"]
    c = torch.as_tensor(coord)
    want = {
        "hessian_pallas": (assembly_kernels.hessian_xyz_ensemble,
                           lambda: pallas_kernels.hessian_pallas(c, tparams)),
        "kirchhoff_pallas": (assembly_kernels.kirchhoff_ensemble,
                             lambda: pallas_kernels.kirchhoff_pallas(
                                 c, tparams)),
        "raw_planes": (assembly_kernels.hessian_planes_ensemble,
                       lambda: pallas_kernels.hessian_pallas_ensemble(
                           c[None], tparams, raw_planes=True)),
    }
    for label, (wrapper, call) in want.items():
        seen = []
        original = getattr(assembly_kernels, wrapper.__name__)

        def spy(*args, _original=original, **kwargs):
            seen.append(True)
            return _original(*args, **kwargs)

        for module in (assembly_kernels, pallas_kernels):
            setattr(module, wrapper.__name__, spy)
        try:
            call()
        finally:
            for module in (assembly_kernels, pallas_kernels):
                setattr(module, wrapper.__name__, original)
        assert seen, label
    assert matfree.hessian_apply_pallas is matfree.hessian_apply_dense
    assert matfree.kirchhoff_apply_pallas_sparse \
        is matfree.kirchhoff_apply_sparse
    for name in pallas_linalg.__all__:
        assert getattr(pallas_linalg, name) is getattr(spd_linalg, name)


@pytest.mark.parametrize("family", ["invariant", "hinsen", "pfenm",
                                    "table_compact", "table_pair"])
@pytest.mark.parametrize("overlay", [False, True])
def test_supports_params_and_ensemble_answer_as_jax(family, overlay):
    n = 60
    coord, jatoms, tatoms = _atoms(n, 1)
    if family == "table_compact":
        jparams = JTab.sd_enm(jatoms).to_compact_params()
        tparams = sct.TabulatedForceField.sd_enm(tatoms).to_compact_params()
    elif family == "table_pair":
        table = np.ones((n, n, 1))
        jparams = jff.table_pair_params(table, None)
        tparams = sct.table_pair_params(table, None)
    else:
        jparams = getattr(jff, f"{family}_params")(13.0)
        tparams = getattr(sct, f"{family}_params")(13.0)
    if overlay:
        mask = np.zeros((n, n), bool)
        mask[0, 1] = mask[1, 0] = True
        jparams = jff.with_overlay(jparams, mask, mask, mask * 2.0, mask)
        tparams = sct.with_overlay(tparams, mask, mask, mask * 2.0, mask)
    assert pallas_kernels.supports_params(tparams) \
        == jkernels.supports_params(jparams)
    for size in (60, 300, 2000):
        if jkernels.supports_ensemble(jparams, size):
            assert pallas_kernels.supports_ensemble(tparams, size)
    assert pallas_kernels.supports_ensemble(tparams, 60) \
        == pallas_kernels.supports_params(tparams)


@pytest.fixture(scope="module")
def matfree_inputs():
    """600 random atoms at protein density, Morton-sorted, their tile
    lists at 13 A (JAX's), and 8 vectors."""
    rng = np.random.RandomState(4)
    n, k = 600, 8
    coord = (rng.rand(n, 3) * (n / (300 / 34.0 ** 3)) ** (1 / 3)).astype(
        np.float32)
    perm = jmatfree.spatial_sort_permutation(coord)
    coord = coord[perm]
    nbr, counts = jmatfree.tile_neighbor_lists(coord, 13.0, 256)
    return (coord, perm.astype(np.int32), np.asarray(nbr),
            np.asarray(counts), rng.randn(3 * n, k).astype(np.float32))


def test_hessian_apply_pallas_matches_jax(matfree_inputs):
    coord, _, _, _, x = matfree_inputs
    ref = jmatfree.hessian_apply_pallas(coord, x, jff.pfenm_params(None),
                                        interpret=True)
    got = matfree.hessian_apply_pallas(coord, x, sct.pfenm_params(None),
                                       device="cpu")
    assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("node", [False, True])
def test_sparse_apply_names_match_jax(matfree_inputs, node):
    coord, ids, nbr, counts, x = matfree_inputs
    if node:
        x = x[:coord.shape[0]]
    name = ("kirchhoff_apply_pallas_sparse" if node
            else "hessian_apply_pallas_sparse")
    ref = getattr(jmatfree, name)(coord, x, jff.invariant_params(13.0), nbr,
                                  counts, orig_ids=ids, interpret=True)
    got = getattr(matfree, name)(coord, x, sct.invariant_params(13.0), nbr,
                                 counts, orig_ids=ids, device="cpu")
    assert got.shape == ref.shape
    assert _rel(got, ref) <= 1e-5


@pytest.fixture(scope="module")
def symmetric():
    rng = np.random.RandomState(0)
    a = rng.randn(40, 40)
    return (a + a.T) / 2


def test_banded_eigenvalues_pallas_matches_jax(symmetric):
    diags = spectrum.band_reduce(torch.from_numpy(symmetric), 8)
    ref = jspectrum.banded_eigenvalues_pallas(diags.numpy(), interpret=True)
    got = spectrum.banded_eigenvalues_pallas(diags)
    assert _rel(got, ref) <= 1e-10
    assert _rel(got, np.linalg.eigvalsh(symmetric)) <= 1e-10
    assert torch.equal(spectrum.banded_eigenvalues_pallas(diags[None])[0],
                       got)


def test_eigh_banded_staged_matches_jax(symmetric):
    ref_vals, ref_vecs = jspectrum.eigh_banded_staged(symmetric)
    vals, vecs = spectrum.eigh_banded_staged(torch.from_numpy(symmetric))
    assert _rel(vals, ref_vals) <= 1e-10
    overlap = np.abs(np.sum(vecs.numpy() * np.asarray(ref_vecs), axis=1))
    assert np.max(np.abs(overlap - 1.0)) <= 1e-8
    with pytest.raises(ValueError, match="single"):
        spectrum.eigh_banded_staged(torch.zeros(2, 40, 40, dtype=torch.float64))


def test_legacy_rank_2_path_matches_jax(symmetric):
    a = torch.from_numpy(symmetric)
    ref_d, ref_e = (np.array(x) for x in jspectrum.tridiagonalize(symmetric))
    d, e = spectrum.tridiagonalize(a)
    assert _rel(d, ref_d) <= 1e-9 and _rel(e, ref_e) <= 1e-9
    ref = jspectrum.tridiagonal_eigenvalues(ref_d, ref_e)
    assert _rel(spectrum.tridiagonal_eigenvalues(
        torch.from_numpy(ref_d), torch.from_numpy(ref_e)), ref) <= 1e-12
    exact = np.linalg.eigvalsh(symmetric)
    assert _rel(spectrum.eigvalsh_sturm(a), jspectrum.eigvalsh_sturm(
        symmetric)) <= 1e-12
    assert _rel(spectrum.eigvalsh_sturm(a), exact) <= 1e-12
    batch = np.stack([symmetric, 2 * symmetric])
    assert _rel(spectrum.eigvalsh_sturm(torch.from_numpy(batch)),
                jspectrum.eigvalsh_sturm(batch)) <= 1e-12


@pytest.mark.parametrize("module, port, names, device", [
    (jkernels, pallas_kernels, pallas_kernels.__all__[:4], True),
    (jkernels, pallas_kernels, pallas_kernels.__all__[4:], False),
    (jlinalg, pallas_linalg, pallas_linalg.__all__, False),
    (jmatfree, matfree, ("hessian_apply_pallas",
                         "hessian_apply_pallas_sparse",
                         "kirchhoff_apply_pallas_sparse"), True),
    (jspectrum, spectrum, ("banded_eigenvalues_pallas", "eigh_banded_staged",
                           "tridiagonalize", "tridiagonal_eigenvalues",
                           "eigvalsh_sturm"), False),
])
def test_signatures_are_the_jax_ones(module, port, names, device):
    """The JAX parameters and defaults, less the TPU plans (and the
    assembly's ``tile``), plus ``device`` where coordinates come in."""
    for name in names:
        want = inspect.signature(getattr(module, name)).parameters
        got = inspect.signature(getattr(port, name)).parameters
        dropped = TPU_KEYWORDS | ({"tile"} if module is jkernels else set())
        assert [p for p in got if p != "device"] \
            == [p for p in want if p not in dropped], name
        assert ("device" in got) == device, name
        for p, param in got.items():
            if p in want and p != "dtype":
                assert param.default == want[p].default, (name, p)


def test_timer_timed_and_synchronize():
    timer = utils.Timer()
    with timer("matmul"):
        a = torch.ones(64, 64) @ torch.ones(64, 64)
    tree = {"a": a, "b": [a, None]}
    assert utils.synchronize(tree) is tree
    assert timer.counts["matmul"] == 1
    assert timer.totals["matmul"] >= 0
    with timer("matmul", sync=tree):
        pass
    assert timer.counts["matmul"] == 2
    buf = io.StringIO()
    timer.report(stream=buf)
    assert "matmul" in buf.getvalue()
    seconds, result = utils.timed(lambda x: x * 2.0, torch.arange(8.0),
                                  repeats=2)
    assert seconds >= 0
    assert torch.equal(result, torch.arange(8.0) * 2)
    assert sct.synchronize is utils.synchronize


def test_trace_writes_a_chrome_trace(tmp_path):
    with utils.profiling.trace(tmp_path) as log_dir:
        torch.ones(32, 32) @ torch.ones(32, 32)
    assert log_dir == tmp_path
    text = (tmp_path / "trace.json").read_text()
    assert "traceEvents" in text


def test_precision_switches_have_their_torch_meaning():
    assert utils.resolve_backend(np.float64) == "torch"
    assert utils.resolve_backend(np.float32) == "torch"
    before = torch.get_default_dtype()
    try:
        utils.enable_x64()
        assert utils.x64_enabled() and utils.default_dtype() == np.float64
        assert torch.tensor(1.0).dtype == torch.float64
        utils.enable_x64(False)
        assert not utils.x64_enabled()
        assert utils.default_dtype() == np.float32
    finally:
        torch.set_default_dtype(before)
