"""
The port's example scripts (``examples_torch/``) against the JAX
package's (``examples/``) on the CPU, and the guards on the port's.

Each case runs both scripts the way ``python script`` runs them
(``chip_smoke.run_example``: ``runpy.run_path`` semantics, ``sys.argv``
set, the port's with ``--device cpu``; the port in this process, the JAX
example in a process of its own beside it), each in a directory of its
own, with ``matplotlib`` unimportable so that both take their ``except
ImportError`` branch and render nothing, and holds the module
globals by name (``chip_smoke.EXAMPLE_GLOBALS``, the same table the card
run is held to): float64 outputs within 1e-8 of max|ref|, float32 ones
within 1e-4 (the port's ``SLICE_TOL``), the refined eigenvalues within
1e-6 relative, eigenvectors by the overlap of each cluster of eigenvalues
within 1e-3 of the span (a single mode: its sign-aligned product) above
1 - 1e-8 (float64) or 1 - 1e-4 (float32); the ensemble's GNM mode
shapes, from a subspace iteration stopped before it converges, within
1e-3.  The files the examples write are held too: the PDB trajectories
column by column (coordinates within one unit of the last digit, up to
the mode's sign) and each package's checkpoint read by the other's
``load_model``.

Sizes: the defaults, except ``mega_assembly 343``, ``matrix_free_modes
512`` and ``stochastic_observables 216``
(``tests/test_torch_examples_scale.py`` holds four of the longer
examples).
"""

import ast
import importlib.util
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from springcraft_tpu.io import load_model as jax_load_model  # noqa: E402
from springcraft_tpu_torch.io import load_model  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(ROOT, "examples_torch")
JAX_DIR = os.path.join(ROOT, "examples")
SCRIPTS = ("basic_nma", "normal_mode", "analysis_gallery", "mode_arrows_3d",
           "checkpoint_resume", "ensemble_nma", "mega_assembly",
           "matrix_free_modes", "perturbation_scan", "stochastic_observables")
#: Arguments of both runs: the defaults, three examples at a smaller size.
SIZES = {"mega_assembly": ("343",), "matrix_free_modes": ("512",),
         "stochastic_observables": ("216",)}


def load_smoke():
    """``chip_smoke.py`` as a module (its helpers import nothing of JAX)."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke_under_test", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def smoke():
    return load_smoke()


def run_pair(smoke, script, tmp_path, monkeypatch):
    """Run the JAX example and its port on the CPU, each in its own
    directory under `tmp_path` (``jax/``, ``torch/``); returns ``(port
    globals, JAX globals)`` as ``chip_smoke.example_globals`` keeps them.

    The JAX example runs in a process of its own, as ``python script``
    starts it: this suite's configuration (x64 on, XLA at optimization
    level 0) would change its float32 results and slow its loops five
    times.  The port runs here meanwhile.  Each on one thread: two
    OpenMP pools spinning beside each other (and beside the other test
    workers) ran the pair four times slower."""
    args = SIZES.get(script, ())
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    env = {key: value for key, value in os.environ.items()
           if key != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    jax_run = subprocess.Popen(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
         "chip_smoke.dump_example(sys.argv[2], sys.argv[3], sys.argv[4:], "
         "'globals.pkl')", ROOT, script,
         os.path.join(JAX_DIR, f"{script}.py"), *args],
        cwd=tmp_path / "jax", env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
        monkeypatch.chdir(tmp_path / "torch")
        got = smoke.example_globals(script, smoke.run_example(
            os.path.join(PORT_DIR, f"{script}.py"),
            ["--device", "cpu", *args]))
    except BaseException:
        jax_run.kill()
        raise
    finally:
        torch.set_num_threads(threads)
        output = jax_run.communicate(timeout=600)[0]
    assert jax_run.returncode == 0, output
    with open(tmp_path / "jax" / "globals.pkl", "rb") as f:
        ref = pickle.load(f)
    return got, ref


def check_pair(smoke, script, tmp_path, monkeypatch):
    """`script`'s port against the JAX example: the globals, then the
    files it writes."""
    got, ref = run_pair(smoke, script, tmp_path, monkeypatch)
    smoke.compare_example(script, got, ref)
    if script in smoke.EXAMPLE_PDBS:
        name = smoke.EXAMPLE_PDBS[script]
        smoke.compare_pdb(name, str(tmp_path / "torch" / name),
                          str(tmp_path / "jax" / name), ref["ca_coord"])
    return got, ref


@pytest.mark.parametrize("script", ["basic_nma", "normal_mode",
                                    "analysis_gallery", "mode_arrows_3d",
                                    "checkpoint_resume", "perturbation_scan"])
def test_example_matches_jax(smoke, script, tmp_path, monkeypatch):
    got, ref = check_pair(smoke, script, tmp_path, monkeypatch)
    if script == "checkpoint_resume":
        # each package reads the other's checkpoint, MSF from its cache
        port_file = str(tmp_path / "torch" / "anm_checkpoint.npz")
        jax_file = str(tmp_path / "jax" / "anm_checkpoint.npz")
        np.testing.assert_allclose(
            np.asarray(jax_load_model(port_file).mean_square_fluctuation()),
            got["msf"], rtol=1e-12)
        np.testing.assert_allclose(
            load_model(jax_file, device="cpu").mean_square_fluctuation(),
            ref["msf"], rtol=1e-12)


def _sources():
    return {script: ast.parse(open(os.path.join(PORT_DIR, f"{script}.py"))
                              .read())
            for script in SCRIPTS}


def test_every_example_is_ported():
    assert sorted(f[:-3] for f in os.listdir(JAX_DIR)
                  if f.endswith(".py")) == sorted(SCRIPTS)
    assert sorted(f[:-3] for f in os.listdir(PORT_DIR)
                  if f.endswith(".py")) == sorted(SCRIPTS)


@pytest.mark.parametrize("script", SCRIPTS)
def test_example_imports_neither_jax_nor_the_jax_package(script):
    tree = _sources()[script]
    names = [alias.name for node in ast.walk(tree)
             if isinstance(node, ast.Import) for alias in node.names]
    names += [node.module for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module]
    assert names
    for name in names:
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "springcraft_tpu"), name
        assert top in ("sys", "os", "time", "numpy", "torch", "matplotlib",
                       "springcraft_tpu_torch"), name


@pytest.mark.parametrize("script", SCRIPTS)
def test_example_never_asks_for_the_plain_versions(script):
    for node in ast.walk(_sources()[script]):
        if isinstance(node, ast.keyword) and node.arg == "use_pallas":
            pytest.fail(f"{script} passes use_pallas=")
        if isinstance(node, ast.Dict):
            assert not any(isinstance(key, ast.Constant)
                           and key.value == "use_pallas"
                           for key in node.keys), script


@pytest.mark.parametrize("script", SCRIPTS)
def test_example_without_device_raises_without_a_card(smoke, script,
                                                      tmp_path, monkeypatch):
    """No ``--device``: the card, and without one the RuntimeError of
    ``resolve_device`` (no fallback to the CPU)."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        smoke.run_example(os.path.join(PORT_DIR, f"{script}.py"))


def _synthetic_globals(smoke, script):
    """Globals of the shapes `script` keeps, from a seed: eigenpairs of a
    random symmetric matrix and random arrays (no example is run)."""
    rng = np.random.RandomState(0)
    a = rng.randn(30, 30)
    values, vectors = np.linalg.eigh(a + a.T)
    values -= values[0] - 1.0
    if script == "basic_nma":
        return {"eigenval": values, "eigenvec": vectors.T,
                "freq": np.sqrt(values), "msqf": rng.rand(10),
                "bfac": rng.rand(10), "dcc": rng.randn(10, 10)}
    if script == "normal_mode":
        return {"displacements": rng.randn(20, 10, 3)}
    k = smoke.N_MODES + 4
    return {"hessian": a + a.T, "vals": values[:k].astype(np.float32),
            "vecs": vectors.T[:k].astype(np.float32),
            "ref_vals": values[:k], "basis": vectors[:, :6],
            "cov": rng.randn(30, 30), "msf": rng.rand(10)}


@pytest.mark.parametrize("script,name,where", [
    (script, name, where)
    for script, names in (
        ("basic_nma", ("eigenval", "eigenvec", "freq", "msqf", "dcc")),
        ("normal_mode", ("displacements",)),
        ("mega_assembly", ("vals", "vecs", "ref_vals", "basis", "msf")))
    for name in names for where in ("got", "ref")])
def test_compare_example_fails_on_a_nan(smoke, script, name, where):
    """A NaN in one global of either run fails the comparison under every
    kind of EXAMPLE_GLOBALS ("close", "rtol", "mode", "vectors", "span"),
    while the same globals without it pass."""
    ref = _synthetic_globals(smoke, script)
    got = {key: value.copy() for key, value in ref.items()}
    smoke.compare_example(script, got, ref)
    planted = got if where == "got" else ref
    planted[name] = planted[name].copy()
    planted[name].flat[planted[name].size // 2] = np.nan  # a held entry
    with pytest.raises(RuntimeError, match=name):
        smoke.compare_example(script, got, ref)
