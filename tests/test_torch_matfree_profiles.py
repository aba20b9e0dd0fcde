"""
PyTorch port, the second matrix-free slice against ``springcraft_tpu`` on
the same numpy inputs, on the CPU in float64: the seven effector/sensor
and stochastic estimators of ``ops/matfree.py`` (probes drawn from the
same ``np.random.RandomState`` seeds in both packages), their refusals,
the degree passes that the kernel route reads off the pair CSR (fed here
from ``pair_csr_plain``) against the JAX package's O(n^2) passes, and the
matrix-free model routes of ``ANM`` / ``GNM``.

Systems: 1l2y's CA trace (20 atoms, invariant 13 A) and a random cloud
of 120 atoms (invariant 12 A).  The JAX side runs its plain operators
(``use_pallas=False``), the port ``device="cpu"``; CG at ``tol=1e-10``.

Tolerances: the estimators and the model routes 1e-8 of max|x|
(``tests/test_torch_matfree.py``'s CG parity); the CSR degree passes
1e-12 relative; a model route whose deflation modes come from the
float32 matrix-free solver of each package 1e-4 (two float32 solvers).
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import springcraft_tpu as sc  # noqa: E402
from springcraft_tpu.ops import matfree as jmf  # noqa: E402
from springcraft_tpu.structure import load_structure as jload  # noqa: E402
import springcraft_tpu_torch as sct  # noqa: E402
from springcraft_tpu_torch.ops import assembly as tassembly  # noqa: E402
from springcraft_tpu_torch.ops import matfree as tmf  # noqa: E402

from .test_torch_matfree import _one_thread, _params  # noqa: E402
from .test_torch_matfree_tables import _families  # noqa: E402
from .test_torch_pair_csr import _sd_enm  # noqa: E402
from .util import random_coord  # noqa: E402

__all__ = ["_one_thread"]       # the module-scoped thread pin, reused here

DATA = os.path.join(os.path.dirname(os.path.realpath(__file__)), "data")
SYSTEMS = ("1l2y", "cloud")
CG = dict(tol=1e-10, block=32)
TOL = 1e-8


def _ca(module_load):
    atoms = module_load(os.path.join(DATA, "1l2y.pdb"), model=1)
    return atoms[(atoms.atom_name == "CA") & (atoms.element == "C")]


def _system(name):
    """``(coord, jax params, port params)``."""
    if name == "1l2y":
        coord = np.asarray(_ca(sct.load_structure).coord, np.float64)
        return (coord,) + _params("invariant", 13.0)
    return (random_coord(13, 120, box=30.0),) + _params("invariant", 12.0)


def _modes(coord, tp, k, layout="xyz", gnm=False):
    """The `k` lowest non-trivial float64 modes in rows from a dense
    ``eigh`` (the port's float64 assembly), in `layout`."""
    c = torch.as_tensor(coord, dtype=torch.float64)
    if gnm:
        vals, vecs = np.linalg.eigh(tassembly.kirchhoff_matrix(c, tp).numpy())
        return vals[1:1 + k], vecs[:, 1:1 + k].T.copy()
    h = tassembly.hessian_matrix(c, tp, layout="xyz").numpy()
    vals, vecs = np.linalg.eigh(h)
    vals, vecs = vals[6:6 + k], vecs[:, 6:6 + k].T
    if layout == "atom":
        n = coord.shape[0]
        vecs = vecs.reshape(k, 3, n).transpose(0, 2, 1).reshape(k, 3 * n)
    return vals, np.ascontiguousarray(vecs)


def _rel(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    return float(np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) or 1.0))


def _assert_outputs(got, ref, n_floats):
    """The first `n_floats` outputs within TOL, then the CG iteration
    count equal and the residuals below the CG's tolerance."""
    for i in range(n_floats):
        assert got[i].device.type == "cpu"
        assert got[i].dtype == torch.float64
        assert _rel(got[i], ref[i]) < TOL, i
    if len(got) > n_floats:
        assert int(got[n_floats]) == int(ref[n_floats])
        assert float(got[n_floats + 1].max()) < 1e-9


def _both(name, system, **kwargs):
    """The estimator `name` through both packages on `system`."""
    coord, jp, tp = _system(system)
    jargs, targs = [coord, jp], [coord, tp]
    if kwargs.pop("needs_modes", False):
        modes = _modes(coord, tp, 5, kwargs.get("layout", "xyz"),
                       gnm=name.endswith("_gnm"))
        jargs.append(modes)
        targs.append(modes)
    ref = getattr(jmf, name)(*jargs, dtype=jnp.float64, use_pallas=False,
                             **CG, **kwargs)
    got = getattr(tmf, name)(*targs, dtype=torch.float64, device="cpu",
                             **CG, **kwargs)
    return got, ref


# ---------------------------------------------------------------------------
# The seven estimators against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("system", SYSTEMS)
@pytest.mark.parametrize("layout", ["xyz", "atom"])
def test_prs_diag_from_modes_matches_jax(layout, system):
    coord, _, tp = _system(system)
    vals, vecs = _modes(coord, tp, 6, layout)
    got = tmf.prs_diag_from_modes(vals, vecs, layout=layout, device="cpu")
    assert got.shape == (coord.shape[0],)
    assert _rel(got, jmf.prs_diag_from_modes(vals, vecs,
                                             layout=layout)) < TOL


@pytest.mark.parametrize("system", SYSTEMS)
@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("layout", ["xyz", "atom"])
def test_effector_sensor_from_modes_matches_jax(layout, norm, system):
    coord, _, tp = _system(system)
    vals, vecs = _modes(coord, tp, 6, layout)
    got = tmf.effector_sensor_from_modes(vals, vecs, norm=norm,
                                         layout=layout, device="cpu")
    ref = jmf.effector_sensor_from_modes(vals, vecs, norm=norm,
                                         layout=layout)
    _assert_outputs(got, ref, 2)


@pytest.mark.parametrize("system", SYSTEMS)
@pytest.mark.parametrize("norm", [True, False])
def test_effector_sensor_matfree_matches_jax(norm, system):
    coord, _, tp = _system(system)
    n = coord.shape[0]
    prs_diag = None
    if norm:
        prs_diag = jmf.prs_diag_from_modes(*_modes(coord, tp, 6))
    sites = [0, n // 2, n - 1]
    got, ref = _both("effector_sensor_matfree", system, sites=sites,
                     prs_diag=prs_diag, norm=norm, return_diag=True)
    _assert_outputs(got, ref, 2)
    assert _rel(got[4], ref[4]) < TOL
    assert got[3].shape == (9,)


@pytest.mark.parametrize("system", SYSTEMS)
@pytest.mark.parametrize("layout", ["xyz", "atom"])
def test_prs_diag_stochastic_matches_jax(layout, system):
    got, ref = _both("prs_diag_stochastic", system, needs_modes=True,
                     probes=8, seed=3, layout=layout)
    _assert_outputs(got, ref, 2)
    assert got[3].shape == (8,)


@pytest.mark.parametrize("system", SYSTEMS)
@pytest.mark.parametrize("layout", ["xyz", "atom"])
def test_msf_stochastic_matches_jax(layout, system):
    got, ref = _both("msf_stochastic", system, needs_modes=True, probes=8,
                     seed=3, layout=layout)
    _assert_outputs(got, ref, 2)
    assert isinstance(got[2], int)


@pytest.mark.parametrize("system", SYSTEMS)
def test_msf_stochastic_gnm_matches_jax(system):
    got, ref = _both("msf_stochastic_gnm", system, needs_modes=True,
                     probes=8, seed=3)
    _assert_outputs(got, ref, 2)
    assert isinstance(got[2], int)


@pytest.mark.parametrize("system", SYSTEMS)
@pytest.mark.parametrize("modes", [None, "xyz", "atom"])
@pytest.mark.parametrize("norm", [True, False])
def test_effector_sensor_stochastic_matches_jax(norm, modes, system):
    """Both profiles and their standard errors; with `modes` and `norm`
    the solve carries ``2 * probes + k`` columns."""
    coord, _, tp = _system(system)
    kwargs = dict(probes=6, seed=5, norm=norm)
    if modes is not None:
        kwargs.update(modes=_modes(coord, tp, 5, modes), layout=modes)
    prs_diag = jmf.prs_diag_from_modes(*_modes(coord, tp, 6))
    got, ref = _both("effector_sensor_stochastic", system,
                     prs_diag=prs_diag, **kwargs)
    _assert_outputs(got, ref, 4)
    columns = (12 if norm else 6) + (5 if modes and norm else 0)
    assert got[5].shape == (columns,)


@pytest.mark.parametrize("name", ["msf_stochastic", "prs_diag_stochastic",
                                  "effector_sensor_stochastic"])
def test_fixed_seed_fixes_the_estimate(name):
    """A seed gives the same estimate twice, another seed another one."""
    coord, _, tp = _system("1l2y")
    modes = _modes(coord, tp, 5)
    args = ((tmf.prs_diag_from_modes(*modes, device="cpu"),)
            if name == "effector_sensor_stochastic" else (modes,))
    kwargs = dict(modes=modes) if name == "effector_sensor_stochastic" \
        else {}
    fn = getattr(tmf, name)

    def run(seed):
        return fn(coord, tp, *args, probes=6, seed=seed,
                  dtype=torch.float64, device="cpu", **CG, **kwargs)[0]

    first = run(11)
    assert torch.equal(first, run(11))
    assert not torch.equal(first, run(12))


#: case -> (estimator, its arguments after (coord, params), keywords),
#: from ``(n, modes, gnm modes)`` of 1l2y
REFUSALS = {
    "prs_diag_probes": lambda n, md, gm: (
        "prs_diag_stochastic", (md,), dict(probes=3)),
    "msf_probes": lambda n, md, gm: ("msf_stochastic", (md,),
                                     dict(probes=1)),
    "msf_gnm_probes": lambda n, md, gm: ("msf_stochastic_gnm", (gm,),
                                         dict(probes=1)),
    "stochastic_probes": lambda n, md, gm: (
        "effector_sensor_stochastic", (np.ones(n),), dict(probes=1)),
    "msf_layout": lambda n, md, gm: ("msf_stochastic", (md,),
                                     dict(layout="zyx")),
    "prs_diag_layout": lambda n, md, gm: (
        "prs_diag_stochastic", (md,), dict(layout="zyx")),
    "stochastic_layout": lambda n, md, gm: (
        "effector_sensor_stochastic", (np.ones(n),),
        dict(modes=md, layout="zyx")),
    "stochastic_no_diag": lambda n, md, gm: (
        "effector_sensor_stochastic", (None,), {}),
    "stochastic_diag_shape": lambda n, md, gm: (
        "effector_sensor_stochastic", (np.ones(n - 1),), {}),
    "sites_no_diag": lambda n, md, gm: ("effector_sensor_matfree",
                                        ([0, 3],), {}),
    "sites_diag_shape": lambda n, md, gm: (
        "effector_sensor_matfree", ([0, 3],), dict(prs_diag=np.ones(n + 2))),
    "sites_out_of_range": lambda n, md, gm: (
        "effector_sensor_matfree", ([0, n],), dict(norm=False)),
    "sites_negative": lambda n, md, gm: ("effector_sensor_matfree", ([-1],),
                                         dict(norm=False)),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_match_jax(case):
    """The same exception, with the JAX package's message."""
    coord, jp, tp = _system("1l2y")
    name, args, kwargs = REFUSALS[case](
        coord.shape[0], _modes(coord, tp, 4), _modes(coord, tp, 4, gnm=True))
    with pytest.raises(Exception) as ref:
        getattr(jmf, name)(coord, jp, *args, dtype=jnp.float64,
                           use_pallas=False, block=32, **kwargs)
    with pytest.raises(ref.type) as got:
        getattr(tmf, name)(coord, tp, *args, dtype=torch.float64,
                           device="cpu", block=32, **kwargs)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("name", ["prs_diag_from_modes",
                                  "effector_sensor_from_modes"])
def test_mode_sums_refuse_as_jax(name):
    vals, vecs = np.ones(3), np.ones((3, 60))
    for args, kwargs in (((vals, vecs), dict(layout="zyx")),
                         ((vals[:2], vecs), {})):
        if name == "prs_diag_from_modes" and not kwargs:
            continue    # no shape check there, in either package
        with pytest.raises(ValueError) as ref:
            getattr(jmf, name)(*args, **kwargs)
        with pytest.raises(ValueError) as got:
            getattr(tmf, name)(*args, device="cpu", **kwargs)
        assert str(got.value) == str(ref.value)


# ---------------------------------------------------------------------------
# Degree passes over the pair CSR against the O(n^2) passes of JAX
# ---------------------------------------------------------------------------

def _csr_family(name, n):
    if name == "invariant":
        return _params("invariant", 11.0)
    if name == "sd_enm":
        return _sd_enm(n)
    return _families(n)[name]


@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("family", ["invariant", "sd_enm", "table-overlay",
                                    "invariant-overlay"])
def test_pair_csr_degree_passes_match_jax(family, masses):
    """The Gershgorin bound, the block-Jacobi diagonal and the degree
    read off ``pair_csr_plain``'s list in Morton order (parameters
    permuted, original positions for the bonded and overlay lookups),
    back in atom order, against the JAX package's row-block passes."""
    n, tile = 100, 16
    coord = random_coord(17, n, box=28.0)
    jp, tp = _csr_family(family, n)
    m = (50.0 + 100.0 * np.random.RandomState(5).rand(n)) if masses \
        else None
    setup = tmf._sparse_setup(torch.as_tensor(coord), tp,
                              None if m is None else torch.as_tensor(m),
                              tile, False)
    pairs = tmf.pair_csr_plain(setup.coord, setup.params, setup.csr, tile)
    inv = np.argsort(setup.perm)
    args = (setup.coord, setup.params, pairs)
    bound = tmf._pair_degree_bound(*args, setup.masses, setup.csr.ids)
    ref = jmf.hessian_degree_bound(coord, jp, masses=m, dtype=jnp.float64,
                                   block=32)
    assert abs(float(bound) - float(ref)) <= 1e-12 * abs(float(ref))
    blocks = tmf._pair_diag_blocks(*args, setup.csr.ids)[inv]
    ref = jmf.hessian_diag_blocks(coord, jp, dtype=jnp.float64, block=32)
    assert blocks.dtype == torch.float64 and _rel(blocks, ref) < 1e-12
    deg = tmf._pair_degree(*args, setup.csr.ids)[inv]
    ref = jmf.kirchhoff_degree(coord, jp, dtype=jnp.float64, block=32)
    assert _rel(deg, ref) < 1e-12


# ---------------------------------------------------------------------------
# The model routes against springcraft_tpu.ANM / GNM on 1l2y
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """``(port ANM, JAX ANM, port GNM, JAX GNM)`` on 1l2y, invariant
    13 A."""
    tca, jca = _ca(sct.load_structure), _ca(jload)
    ff_t, ff_j = sct.InvariantForceField(13.0), sc.InvariantForceField(13.0)
    return (sct.ANM(tca, ff_t, device="cpu"), sc.ANM(jca, ff_j),
            sct.GNM(tca, ff_t, device="cpu"), sc.GNM(jca, ff_j))


def _eigen_modes(model, trivial, k=5):
    vals, vecs = model.eigen()
    return vals[trivial:trivial + k], vecs[trivial:trivial + k]


#: route -> (family, call(model, modes, keywords)); `modes` are the dense
#: eigensystem's lowest non-trivial modes, atom-interleaved for ANM; the
#: keywords hold the CG options and the float64 dtype of the package
MODEL_ROUTES = {
    "anm_msf": ("anm", lambda m, md, kw: m.mean_square_fluctuation(
        matrix_free=True, modes=md, probes=8, seed=2, tem=300.0, **kw)),
    "anm_bfactor": ("anm", lambda m, md, kw: m.bfactor(
        matrix_free=True, modes=md, probes=8, **kw)),
    "anm_dcc": ("anm", lambda m, md, kw: m.dcc(
        matrix_free=True, sites=[0, 7, 19], modes=md, probes=8, **kw)),
    "anm_prs_sites": ("anm", lambda m, md, kw: m.prs_effector_sensor(
        matrix_free=True, sites=[0, 7, 19], modes=md, **kw)[1:]),
    "anm_prs_sites_raw": ("anm", lambda m, md, kw: m.prs_effector_sensor(
        matrix_free=True, sites=[2, 11], norm=False, **kw)[1:]),
    "anm_prs_modes": ("anm", lambda m, md, kw: m.prs_effector_sensor(
        matrix_free=True, modes=md)[1:]),
    "anm_prs_modes_solved": ("anm", lambda m, md, kw: m.prs_effector_sensor(
        matrix_free=True, modes=4, block=32, dtype=kw["dtype"])[1:]),
    "anm_prs_probes": ("anm", lambda m, md, kw: m.prs_effector_sensor(
        matrix_free=True, probes=8, modes=md, seed=4, **kw)[1:]),
    "gnm_msf": ("gnm", lambda m, md, kw: m.mean_square_fluctuation(
        matrix_free=True, modes=md, probes=8, **kw)),
    "gnm_bfactor": ("gnm", lambda m, md, kw: m.bfactor(
        matrix_free=True, modes=md, probes=8, tem=300.0, **kw)),
    "gnm_dcc": ("gnm", lambda m, md, kw: m.dcc(
        matrix_free=True, sites=[3, 15], modes=md, probes=8, **kw)),
}


@pytest.mark.parametrize("route", sorted(MODEL_ROUTES))
def test_model_routes_match_jax(models, route):
    """Each matrix-free model route against the JAX model, NumPy out,
    the DCC normalizer and the profile normalizer estimated in place."""
    family, call = MODEL_ROUTES[route]
    tm, jm = models[:2] if family == "anm" else models[2:]
    modes = _eigen_modes(jm, 6 if family == "anm" else 1)
    ref = call(jm, modes, dict(CG, dtype=jnp.float64))
    got = call(tm, modes, dict(CG, dtype=torch.float64))
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    for g, r in zip(got, ref, strict=True):
        assert isinstance(g, np.ndarray) and g.shape == np.shape(r)
        assert _rel(g, r) < TOL


def test_integer_modes_solve_the_deflation_subspace(models):
    """``modes=<k>`` runs ``lowest_modes(k, matrix_free=True)`` in each
    package (float32 Chebyshev): the stochastic MSF agrees to the two
    float32 mode sets' 1e-4."""
    tm, jm = models[:2]
    got = tm.mean_square_fluctuation(matrix_free=True, modes=4, probes=8,
                                     dtype=torch.float64, **CG)
    ref = jm.mean_square_fluctuation(matrix_free=True, modes=4, probes=8,
                                     dtype=jnp.float64, **CG)
    for g, r in zip(got, ref, strict=True):
        assert _rel(g, r) < 1e-4


@pytest.mark.parametrize("family", ["anm", "gnm"])
def test_modes_true_is_a_type_error(models, family):
    tm, jm = models[:2] if family == "anm" else models[2:]
    for model in (tm, jm):
        with pytest.raises(TypeError, match="did you mean matrix_free"):
            model.mean_square_fluctuation(matrix_free=True, modes=True)


def test_mode_residual_tol_guards_the_solve():
    """GNM at 7 A on 1l2y: the Chebyshev solve of 4 modes leaves a mode
    unconverged in both packages, and the guard refuses it with the
    message (but for the residual); the tolerance is refused beside
    explicit modes."""
    tca, jca = _ca(sct.load_structure), _ca(jload)
    tg = sct.GNM(tca, sct.InvariantForceField(7.0), device="cpu")
    jg = sc.GNM(jca, sc.InvariantForceField(7.0))
    messages = []
    for model in (tg, jg):
        with pytest.raises(ValueError, match="did not converge") as err:
            model.mean_square_fluctuation(matrix_free=True, modes=4)
        messages.append(str(err.value))
        with pytest.raises(ValueError, match="applies only to modes=<k>"):
            model.dcc(matrix_free=True, sites=[0],
                      modes=_eigen_modes(jg, 1), mode_residual_tol=1e-3)
    # the same message but for the residual each float32 solver left
    assert re.sub(r"residual \S+", "", messages[0]) \
        == re.sub(r"residual \S+", "", messages[1])
