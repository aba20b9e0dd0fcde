"""Cells of the benchmark at a size the CPU runs in seconds, through the
plain versions of the program's kernels."""

from __future__ import annotations

import copy
import time

from enm_bench.harness import session, spec

SEED = 2**31 + 11


def cell(name, root=spec.ROOT):
    """The cell `name` of the ``BENCHMARK.json`` under `root`, cut to a
    tiny size."""
    c = copy.deepcopy(spec.load_cell(name, root))
    c.config["structure"]["n_atoms"] = 24
    c.config["conformers_per_call"] = 16
    c.config["engine"]["chunk"] = 8
    c.traffic.update(pool=2, sample=8, traced_requests=[1, 2])
    return c


def run(c, trace=False, control=None, requests=4, seed=SEED):
    """One run of the tiny cell `c` on the CPU: ``(result, readings)``."""
    return session.run_cell(c, seed, 1e9, trace, time.perf_counter(),
                            device="cpu", control=control,
                            max_requests=requests)
