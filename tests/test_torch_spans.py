"""
PyTorch port, the ``springcraft::`` spans of the ensemble fluctuation
pipelines (:func:`springcraft_tpu_torch.utils.profiling.span`): a shared
no-op without a running profiler, and under ``torch.profiler`` one entry
span a call, a ``chunk`` span a chunk and, inside each chunk, its stages
in order, with every matrix product of the call inside exactly one
stage.  The plain kernel versions run on the CPU; the spans change no
output.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import springcraft_tpu_torch as sct  # noqa: E402
from springcraft_tpu_torch.utils import profiling  # noqa: E402

B, N, CHUNK = 4, 24, 2
STAGES = ("rigid_bases", "assembly", "prep", "inverse_factor", "grams",
          "observables")
MATMULS = ("aten::matmul", "aten::mm", "aten::bmm", "aten::addmm",
           "aten::baddbmm", "aten::addbmm")
ANM_ORDER = STAGES
GNM_ORDER = ("assembly", "rigid_bases") + STAGES[2:]


def _coords():
    # protein-like density, connected at a 13 A cutoff
    rng = np.random.RandomState(24)
    base = (rng.rand(N, 3) * 34.0 * (N / 300) ** (1 / 3)).astype(np.float32)
    return base[None] + 0.05 * rng.randn(B, N, 3).astype(np.float32)


def _anm(**options):
    return lambda coords: sct.ensemble_anm_fluctuations(
        coords, sct.invariant_params(13.0), inverse="blocked", chunk=CHUNK,
        device="cpu", **options)


def _gnm(coords):
    return sct.ensemble_gnm_fluctuations(
        coords, sct.invariant_params(13.0), inverse="blocked", chunk=CHUNK,
        device="cpu")


CASES = {
    "anm-traces": ("ensemble_anm_fluctuations", ANM_ORDER,
                   _anm(with_covariance=False)),
    "anm-cov-prs": ("ensemble_anm_fluctuations", ANM_ORDER,
                    _anm(with_covariance=True, with_prs=True)),
    "gnm": ("ensemble_gnm_fluctuations", GNM_ORDER, _gnm),
}


class _Counting:
    """Stands in for ``torch.profiler.record_function`` and counts the
    spans made."""

    def __init__(self, real):
        self.real, self.calls = real, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.real(*args, **kwargs)


def _host_rows(prof):
    """``(start_ns, end_ns, name)`` of the profiled thread's host events,
    in order of start (outer before inner at equal starts)."""
    events = list(prof.profiler.kineto_results.events())
    thread = next(e.start_thread_id() for e in events
                  if e.name().startswith(profiling.SPAN_PREFIX))
    rows = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            for e in events if e.start_thread_id() == thread]
    return sorted(rows, key=lambda r: (r[0], -r[1]))


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _named(rows, name):
    return [r for r in rows if r[2] == profiling.SPAN_PREFIX + name]


def test_span_is_a_shared_no_op_without_the_profiler(monkeypatch):
    counting = _Counting(torch.profiler.record_function)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert profiling.span("chunk") is profiling.span("grams")
    with profiling.span("chunk"):
        pass
    _anm(with_covariance=False)(_coords())
    assert counting.calls == 0
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("chunk"):
            pass
    assert counting.calls == 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_nest_and_leave_outputs_unchanged(case):
    entry, order, run = CASES[case]
    coords = _coords()
    plain = run(coords)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = run(coords)
    assert set(traced) == set(plain)
    for key in plain:
        assert torch.equal(traced[key], plain[key]), key

    rows = _host_rows(prof)
    spans = [r for r in rows if r[2].startswith(profiling.SPAN_PREFIX)]
    entries = _named(rows, entry)
    assert len(entries) == 1
    chunks = _named(rows, "chunk")
    assert len(chunks) == B // CHUNK
    stages = [r for r in spans if r[2] in
              {profiling.SPAN_PREFIX + s for s in STAGES}]
    assert all(_inside(r, entries[0]) for r in spans)
    for chunk in chunks:
        inner = [r[2][len(profiling.SPAN_PREFIX):] for r in stages
                 if _inside(r, chunk)]
        assert tuple(inner) == order
    assert all(any(_inside(r, c) for c in chunks) for r in stages)
    products = [r for r in rows if r[2] in MATMULS]
    assert products
    for op in products:
        holders = [s[2] for s in stages if _inside(op, s)]
        assert len(holders) == 1, (op[2], holders)
