"""Cases of the ensemble cells' tests that a cell of another route cannot
meet.  They are parametrized over every cell of ``BENCHMARK.json``, but
their faults are planted in ``parallel/pipeline.py`` and their readers
read its chunk loop, neither of which a cell whose traffic names another
route runs (the ``structure`` route's own faults and readers are tested
in ``test_enm_bench_structure.py``).  Such cases are deselected for each
cell whose traffic's ``route`` is not ``"ensemble"``."""

from __future__ import annotations

from enm_bench.harness import spec

ENSEMBLE_ONLY = {
    "test_enm_bench_faults.py": {"test_altered_answer_fails",
                                 "test_half_the_batch_left_out_fails"},
    "test_enm_bench_replayed_chunks.py": {"test_tiny_traced_run_reads_zero"},
    "test_enm_bench_span_readers.py": {
        "test_tiny_traced_run_reports_the_host_reader_only"},
}


def _ensemble_only_elsewhere(item):
    """Whether `item` is a case of an ensemble-only test for a cell of
    another route."""
    if item.originalname not in ENSEMBLE_ONLY.get(item.path.name, ()):
        return False
    callspec = getattr(item, "callspec", None)
    name = callspec.params.get("name") if callspec else None
    return (name is not None
            and spec.load_cell(name).traffic["route"] != "ensemble")


def pytest_collection_modifyitems(config, items):
    dropped = [item for item in items if _ensemble_only_elsewhere(item)]
    if dropped:
        config.hook.pytest_deselected(items=dropped)
        items[:] = [item for item in items if item not in dropped]
