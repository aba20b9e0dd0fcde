"""The ``replayed_chunks_pct`` reader: on synthetic host rows (every
chunk replayed, none, some, a row outside the traced window, no chunk
span) and in a tiny traced run of every cell on the CPU, where the
program's chunk loop runs eagerly."""

from __future__ import annotations

import json

import pytest

from enm_bench.harness import spec
from enm_bench.harness.session import LayerRun
from enm_bench.harness.trace import Trace
from enm_bench.tests import tiny

CELLS = [w["name"] for w in json.loads(
    (spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]
NAME = "replayed_chunks_pct"
US = 1000  # nanoseconds


def _read(host, window=(0, 1000)):
    trace = Trace([], [(a * US, b * US, name) for a, b, name in host],
                  (window[0] * US, window[1] * US))
    run = LayerRun(trace=trace, work=8, shapes={"n": 300}, config={},
                   traffic={}, untraced_work=0, untraced_s=0.0)
    return spec.load_reader(NAME).read(run)


def _call(start, replayed, chunks=4):
    """One entry span of `chunks` chunk spans of 10 us, the first
    `replayed` of them around a replay span."""
    rows = [(start, start + 10 * chunks + 1,
             "springcraft::ensemble_anm_fluctuations")]
    for i in range(chunks):
        a = start + 10 * i
        rows.append((a, a + 10, "springcraft::chunk"))
        if i < replayed:
            rows.append((a + 1, a + 9, "springcraft::graph_replay"))
        else:
            rows.append((a + 1, a + 4, "springcraft::rigid_bases"))
    return rows


@pytest.mark.parametrize("replayed, value", [(4, 100.0), (0, 0.0),
                                             (3, 75.0)])
def test_share_of_replayed_chunks(replayed, value):
    assert _read(_call(0, replayed) + _call(100, replayed)) \
        == pytest.approx(value)


def test_mixed_calls_and_the_window():
    # a first call that ran eagerly and captured, then two that replayed
    host = _call(0, 2) + _call(100, 4) + _call(200, 4)
    assert _read(host) == pytest.approx(100 * 10 / 12)
    # only the calls inside the traced window count
    assert _read(host, (90, 1000)) == pytest.approx(100.0)


def test_none_without_chunk_spans():
    host = [(0, 50, "aten::matmul"), (0, 40, "springcraft::graph_replay")]
    assert _read(host) is None
    assert _read([]) is None
    run = LayerRun(trace=None, work=0, shapes={}, config={}, traffic={},
                   untraced_work=0, untraced_s=0.0)
    assert spec.load_reader(NAME).read(run) is None


@pytest.mark.parametrize("name", CELLS)
def test_tiny_traced_run_reads_zero(name):
    """On the CPU the chunk loop is the eager one: no chunk replays."""
    result, _ = tiny.run(tiny.cell(name), trace=True, requests=3)
    assert result["metrics"][NAME]["value"] == 0.0
    assert result["correct"] is True
