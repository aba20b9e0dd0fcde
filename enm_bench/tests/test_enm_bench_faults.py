"""A whole run, its look for a card skipped, with the timed path broken
underneath: each fault that a cell can have must make ``correct`` false.
The faults are planted in the program's own functions (monkeypatched),
so the harness, the sample and the reference run as in a benchmark run.
"""

from __future__ import annotations

import pytest

import springcraft_tpu_torch.parallel.pipeline as pipeline
from enm_bench.harness import spec
from enm_bench.tests import tiny

ENSEMBLES = [w["name"] for w in spec.benchmark()["workloads"]]


def _failed(name, requests=3):
    result, readings = tiny.run(tiny.cell(name), requests=requests)
    return result["correct"] is False, readings


@pytest.mark.parametrize("name", ENSEMBLES)
def test_sound_ensemble_is_correct(name):
    result, _ = tiny.run(tiny.cell(name), requests=3)
    assert result["correct"] is True


@pytest.mark.parametrize("name", ENSEMBLES)
def test_altered_answer_fails(name, monkeypatch):
    """Every conformer's normalized DCC off by 1e-3 where it is made."""
    observables = pipeline._anm_trace_observables

    def altered(traces, with_dcc):
        out = observables(traces, with_dcc)
        out["dcc"] = out["dcc"] + 1e-3
        return out

    monkeypatch.setattr(pipeline, "_anm_trace_observables", altered)
    failed, readings = _failed(name)
    assert failed and readings["dcc"] > 1e-4, readings


@pytest.mark.parametrize("name", ENSEMBLES)
def test_half_the_batch_left_out_fails(name, monkeypatch):
    """Each call computes only its first half of conformers and copies
    those answers over the second half."""
    run_chunked = pipeline._run_chunked

    def half(run, coords, chunk):
        b = coords.shape[0] // 2
        out = run_chunked(run, coords[:b], chunk)
        return {k: v.repeat((2,) + (1,) * (v.ndim - 1))
                for k, v in out.items()}

    monkeypatch.setattr(pipeline, "_run_chunked", half)
    failed, readings = _failed(name)
    assert failed, readings

