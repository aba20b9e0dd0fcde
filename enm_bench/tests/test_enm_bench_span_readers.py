"""The readers of the metrics that read the program's ``springcraft::``
spans, on synthetic traces (device operations with the host spans and
operators they were launched under, and the main thread's host rows),
and in a tiny traced run of every cell on the CPU, which holds the
spans but no device operation."""

from __future__ import annotations

import json

import pytest

from enm_bench.harness import spec
from enm_bench.harness.session import LayerRun
from enm_bench.harness.trace import DeviceOp, Trace
from enm_bench.tests import tiny

CELLS = [w["name"] for w in json.loads(
    (spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]
ENTRY = "springcraft::ensemble_anm_fluctuations"
CALL = ("enm_bench::call", ENTRY, "springcraft::chunk")
DEVICE_READERS = ("factor_gemm_us_per_solve", "gram_us_per_solve",
                  "bases_launches_per_solve")
US = 1000  # nanoseconds


def _read(name, trace, work=2):
    run = LayerRun(trace=trace, work=work, shapes={"n": 300}, config={},
                   traffic={}, untraced_work=0, untraced_s=0.0)
    return spec.load_reader(name).read(run)


def _op(start_us, end_us, *under, name="kernel"):
    return DeviceOp(name, start_us * US, end_us * US, tuple(under))


def _rows(*spans):
    """Host rows ``(start, end, name)`` from ``(start_us, end_us,
    short name)``, the entry's own prefix added."""
    return [(a * US, b * US, name if "::" in name else "springcraft::"
             + name) for a, b, name in spans]


def _trace(ops, host, window=(0, 1000)):
    return Trace(ops, host, (window[0] * US, window[1] * US))


def _pipeline_trace():
    """One call of two solves: a factor GEMM of 10 us and a leaf kernel
    in the factor, a plane-trace GEMM of 4 us and a null-space product of
    2 us in the Grams, three QR launches in the bases, an observable
    kernel, and a GEMM under no stage span (the null correction of a
    program that left it out) of 3 us."""
    ops = [
        _op(0, 3, *CALL, "springcraft::rigid_bases", "aten::linalg_qr"),
        _op(3, 5, *CALL, "springcraft::rigid_bases", "aten::linalg_qr"),
        _op(5, 6, *CALL, "springcraft::rigid_bases", "aten::stack"),
        _op(10, 20, *CALL, "springcraft::inverse_factor", "aten::matmul",
            "aten::mm"),
        _op(20, 25, *CALL, "springcraft::inverse_factor", name="leaf"),
        _op(30, 34, *CALL, "springcraft::grams", "aten::matmul",
            "aten::bmm"),
        _op(34, 36, *CALL, "springcraft::grams", "aten::einsum",
            "aten::bmm"),
        _op(40, 41, *CALL, "springcraft::observables", "aten::div"),
        _op(50, 53, *CALL, "aten::matmul", "aten::mm"),
    ]
    host = _rows((0, 100, "ensemble_anm_fluctuations"), (1, 99, "chunk"),
                 (1, 8, "rigid_bases"), (10, 26, "inverse_factor"),
                 (30, 37, "grams"), (40, 42, "observables"),
                 (10, 11, "aten::matmul"))
    return _trace(ops, host)


@pytest.mark.parametrize("name, value", [
    ("factor_gemm_us_per_solve", 10 / 2),
    ("gram_us_per_solve", (4 + 2) / 2),
    ("bases_launches_per_solve", 3 / 2),
    # 100 us of the entry less 7 + 16 + 7 + 2 us of stages
    ("loop_self_us_per_solve", (100 - 32) / 2),
])
def test_reader_values(name, value):
    assert _read(name, _pipeline_trace()) == pytest.approx(value)


@pytest.mark.parametrize("name", DEVICE_READERS
                         + ("loop_self_us_per_solve",))
def test_none_without_spans(name):
    """The parent's program: no ``springcraft::`` span, only operators."""
    ops = [_op(0, 5, "enm_bench::call", "aten::linalg_qr"),
           _op(5, 9, "enm_bench::call", "aten::matmul", "aten::mm")]
    trace = _trace(ops, [(0, 10 * US, "aten::matmul")])
    assert _read(name, trace) is None
    assert _read(name, None) is None


def test_factor_and_grams_sum_to_every_gemm():
    trace = _pipeline_trace()
    trace.ops = [op for op in trace.ops
                 if "springcraft::inverse_factor" in op.launched_under
                 or "springcraft::grams" in op.launched_under
                 or "aten::matmul" not in op.launched_under]
    parts = (_read("factor_gemm_us_per_solve", trace)
             + _read("gram_us_per_solve", trace))
    assert parts == pytest.approx(_read("gemm_us_per_solve", trace))
    # with a GEMM under no stage span, the two fall short of the whole
    whole = _pipeline_trace()
    assert _read("gemm_us_per_solve", whole) - parts == pytest.approx(3 / 2)


def test_factor_gemm_is_zero_when_the_span_holds_no_gemm():
    ops = [_op(0, 5, *CALL, "springcraft::inverse_factor", name="leaf")]
    assert _read("factor_gemm_us_per_solve",
                 _trace(ops, _rows((0, 10, "inverse_factor")))) == 0.0


def test_loop_self_time_subtracts_the_union_of_stage_spans():
    host = _rows((0, 100, "ensemble_gnm_fluctuations"), (0, 100, "chunk"),
                 (10, 40, "assembly"), (30, 50, "prep"),
                 (45, 60, "inverse_factor"), (70, 80, "grams"),
                 # a stage span outside every entry counts for nothing
                 (200, 300, "grams"),
                 (300, 400, "ensemble_anm_fluctuations"),
                 (310, 320, "observables"), (315, 330, "observables"))
    # entries of 100 us each; stages cover 10-60 and 70-80, then 310-330
    self_us = (100 - 60) + (100 - 20)
    assert _read("loop_self_us_per_solve", _trace([], host),
                 work=4) == pytest.approx(self_us / 4)
    # an entry is counted within the traced window only
    assert _read("loop_self_us_per_solve", _trace([], host, (0, 350)),
                 work=4) == pytest.approx(((100 - 60) + (50 - 20)) / 4)


@pytest.mark.parametrize("name", CELLS)
def test_tiny_traced_run_reports_the_host_reader_only(name):
    cell = tiny.cell(name)
    result, _ = tiny.run(cell, trace=True, requests=3)
    metrics = result["metrics"]
    assert metrics["loop_self_us_per_solve"]["value"] > 0
    assert not set(DEVICE_READERS) & set(metrics)
    assert result["correct"] is True
