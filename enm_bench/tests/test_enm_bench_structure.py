"""The single-structure cell ``asm10k-sdenm.dense-modes`` on the CPU at a
size a test run holds (300 atoms in 2 chains, 6 modes and 2 buffer
modes): a sound run is correct and reports its host reader, planted
faults come out not correct, the reference agrees with itself, and the
readers' work functions reproduce the bounds of ``PERF.md``'s kernel
table and read nothing without the program's spans."""

from __future__ import annotations

import copy
import importlib
import pathlib

import pytest
import torch

import springcraft_tpu_torch as sct
from enm_bench.harness import inputs, peaks, spec
from enm_bench.harness.session import LayerRun
from enm_bench.harness.trace import DeviceOp, Trace
from enm_bench.reference import springs, structure
from enm_bench.routes.structure import Route
from enm_bench.tests import conftest, tiny

CELL = "asm10k-sdenm.dense-modes"
READERS = ("device_idle_pct.ens", "k5_roofline", "cholesky_roofline",
           "sweeps_roofline", "refine_us_per_solve")
US = 1000  # nanoseconds


def _cell(n=300):
    c = copy.deepcopy(spec.load_cell(CELL))
    c.config["structure"].update(n_atoms=n, chains=2)
    c.config.update(modes=6, mode_buffer=2)
    c.traffic.update(pool=2, sample=4, traced_requests=[1, 2])
    return c


def test_sound_run_is_correct_and_reads_the_refinement():
    result, readings = tiny.run(_cell(), trace=True, requests=3)
    assert result["correct"] is True, readings
    metrics = result["metrics"]
    # on the CPU no device operation: the rooflines read nothing
    assert set(metrics) == {"device_idle_pct.ens", "refine_us_per_solve"}
    assert metrics["refine_us_per_solve"]["value"] > 0
    assert readings["eig_values"] < 1e-7, readings


def test_altered_eigenvalues_fail(monkeypatch):
    refine = sct.refine_modes_f64

    def altered(*args, **kwargs):
        theta, vecs, res = refine(*args, **kwargs)
        return theta * (1 + 1e-3), vecs, res

    monkeypatch.setattr(sct, "refine_modes_f64", altered)
    result, readings = tiny.run(_cell(), requests=2)
    assert result["correct"] is False
    assert readings["eig_values"] > 5e-4, readings


def test_refinement_left_out_fails(monkeypatch):
    """The raw float32 modes of ``lowest_modes_anm`` handed on as the
    refined ones."""
    lowest, raw = sct.lowest_modes_anm, {}

    def keep(*args, **kwargs):
        raw["vals"], raw["vecs"] = lowest(*args, **kwargs)
        return raw["vals"], raw["vecs"]

    def skipped(coord, params, vecs, **kwargs):
        return raw["vals"].double(), raw["vecs"].double(), None

    monkeypatch.setattr(sct, "lowest_modes_anm", keep)
    monkeypatch.setattr(sct, "refine_modes_f64", skipped)
    result, readings = tiny.run(_cell(), requests=2)
    assert result["correct"] is False, readings
    # the control of the same name reads the same
    control, same = tiny.run(_cell(), control="norefine", requests=2)
    assert control["correct"] is False and same == readings


def test_shapes_read_the_configuration_and_the_force_field():
    """The sweeps' block is ``k`` and the configuration's ``oversample``,
    the bins are the force field's."""
    c = _cell(60)
    c.config["engine"]["oversample"] = 5
    route = Route(c, tiny.SEED, "cpu", None, None)
    route.setup()
    shapes = route.shapes()
    assert shapes["block"] == 8 + 5 and shapes["bins"] == 26
    route.release()


def test_ensemble_only_cases_are_named_as_their_files_have_them():
    """Each test that ``conftest.py`` keeps to the ensemble cells exists
    under that name and is parametrized over the cells."""
    here = pathlib.Path(__file__).parent
    for file, tests in conftest.ENSEMBLE_ONLY.items():
        module = importlib.import_module(f"enm_bench.tests.{file[:-3]}")
        for test in tests:
            marks = getattr(module, test).pytestmark
            assert (here / file).exists() and any(
                m.name == "parametrize" and m.args[0] == "name"
                for m in marks), (file, test)


def test_unknown_control_is_refused():
    with pytest.raises(ValueError, match="no control"):
        tiny.run(_cell(), control="fp16", requests=1)


def _structure(n=120, seed=3):
    c = _cell(n)
    s = inputs.conformers(c.config["structure"], seed, 1)
    network = springs.Network(c.config["force_field"], s.res_name,
                              s.chain_id, s.res_id)
    return torch.as_tensor(s.coords[0]), network


def test_reference_hessian_is_the_springs_hessian():
    coord, network = _structure()
    assert torch.equal(structure.hessian_xyz(coord, network, rows=7),
                       springs.hessian_xyz(coord, network))


def test_reference_iteration_meets_eigh():
    coord, network = _structure()
    h = structure.hessian_xyz(coord, network)
    t = springs.rigid_basis(coord)
    dense = structure.lowest_modes(h, t, 10)
    iterated = structure.lowest_modes(h, t, 10, eigh_max_dim=0)
    assert iterated[2] <= structure.RESIDUAL
    assert float((iterated[0] - dense[0]).abs().max()
                 / dense[0].abs().max()) <= 1e-12
    msf = structure.mode_msf(dense[0], dense[1])
    assert float((structure.mode_msf(iterated[0], iterated[1]) - msf)
                 .abs().max() / msf.abs().max()) <= 1e-8


@pytest.mark.parametrize("name, work, bound_ms", [
    # K5 (1, 10000) sdENM: the north star's input
    ("k5_roofline", lambda m: m.work(10000, 26), 1.0747),
    # the float32 Cholesky of the 30,000-dimensional regularized Hessian
    ("cholesky_roofline", lambda m: m.work(10000), 134.3284),
    # one sweep of a 48-column block through its factor
    ("sweeps_roofline", lambda m: m.work(10000, 48), 1.2896),
])
def test_work_reproduces_the_bounds(name, work, bound_ms):
    nbytes, flops = work(spec.load_reader(name))
    assert round(1e3 * peaks.bound_s(nbytes, flops), 4) == bound_ms


def _op(start_us, end_us, *under, name="kernel"):
    return DeviceOp(name, start_us * US, end_us * US,
                    ("enm_bench::call",) + under)


def _run(trace, work=2, sweeps=48):
    return LayerRun(trace=trace, work=work,
                    shapes={"n": 10000, "k": 24, "block": 48, "bins": 26,
                            "sweeps": sweeps},
                    config={}, traffic={}, untraced_work=4,
                    untraced_s=4.0)


def _trace(ops, host):
    rows = [(a * US, b * US, name) for a, b, name in host]
    return Trace(ops, rows, (0, 10_000_000 * US))


def _spans_trace():
    """Two requests: K5 1.3 ms each, the factor 250 ms, 24 sweeps 500 ms,
    a refinement of 150 ms on the host (a 40 ms pair search in it)."""
    ops, host = [], []
    for start in (0, 1_000_000):
        ops += [
            _op(start, start + 1_300, "springcraft::assembly",
                name="hessian_kernel"),
            _op(start + 2_000, start + 252_000,
                "springcraft::lowest_modes_anm", "springcraft::cholesky",
                "aten::linalg_cholesky_ex", name="potrf"),
            _op(start + 260_000, start + 760_000,
                "springcraft::lowest_modes_anm", "springcraft::sweeps",
                "aten::cholesky_solve", name="trsm"),
            _op(start + 800_000, start + 810_000, "springcraft::refine",
                "aten::index_add_", name="index_add")]
        host += [(start + 780_000, start + 930_000, "springcraft::refine"),
                 (start + 785_000, start + 825_000,
                  "springcraft::pair_search")]
    return _trace(ops, host)


def test_reader_values():
    trace = _spans_trace()

    def read(name, **kwargs):
        return spec.load_reader(name).read(_run(trace, **kwargs))

    assert read("k5_roofline") == pytest.approx(100 * 1.0747 / 1.3, 1e-3)
    assert read("cholesky_roofline") == pytest.approx(
        100 * 134.3284 / 250, 1e-5)
    # 24 sweeps a request
    assert read("sweeps_roofline") == pytest.approx(
        100 * 48 * 1.2896 / 1000, 1e-4)
    assert read("refine_us_per_solve") == pytest.approx(150_000)
    assert read("sweeps_roofline", sweeps=None) is None
    busy = 2 * (1_300 + 250_000 + 500_000 + 10_000) * 1e-6
    assert read("device_idle_pct.ens") == pytest.approx(
        100 * (1 - busy / 2 * 4 / 4.0))
    # four device operations a request
    assert read("launches_per_solve") == pytest.approx(4)


@pytest.mark.parametrize("name", READERS[1:])
def test_none_without_spans(name):
    """The parent's program: the same kernels under no ``springcraft::``
    span, and no sweep counter."""
    ops = [_op(0, 1_300, "aten::empty", name="hessian_kernel"),
           _op(2_000, 252_000, "aten::linalg_cholesky_ex", name="potrf"),
           _op(260_000, 760_000, "aten::cholesky_solve", name="trsm")]
    trace = _trace(ops, [(0, 900_000, "aten::cholesky_solve")])
    reader = spec.load_reader(name)
    assert reader.read(_run(trace, sweeps=None)) is None
    assert reader.read(_run(None)) is None
