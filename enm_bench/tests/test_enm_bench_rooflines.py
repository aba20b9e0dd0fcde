"""The roofline metrics' work functions at the shapes of the kernel table in
``PERF.md``, whose bounds (bytes at 3.35 TB/s or operations at 67 TFLOP/s)
they must reproduce."""

from __future__ import annotations

import pytest

from enm_bench.harness import peaks, spec
from enm_bench.harness.counts import padded_size


def _metric(name):
    return spec.load_reader(name)


@pytest.mark.parametrize("name, work, bound_ms", [
    # K1 (128, 300) invariant
    ("k1_roofline", lambda m: [128 * x for x in m.work(300)], 0.1239),
    # K2 (128, n 300, mp 1024)
    ("k2_roofline", lambda m: [128 * x for x in m.work(300, 1024)],
     0.2850),
    # K3 (128, 64, 64): 128 panels of 64 rows
    ("k3_roofline", lambda m: [128 * x for x in m.work(0, 64)],
     0.0013),
])
def test_work_reproduces_the_kernel_table_bounds(name, work, bound_ms):
    nbytes, flops = work(_metric(name))
    assert round(1e3 * peaks.bound_s(nbytes, flops), 4) == bound_ms


def test_padded_size():
    assert padded_size(900) == 1024
    assert padded_size(96) == 96 and padded_size(200) == 256


def test_roofline_is_none_without_device_time():
    assert peaks.roofline_pct(1e9, 1e9, 0.0) is None


def test_solve_mfu_counts_the_inverse_of_the_hessian():
    mfu = _metric("solve_mfu")
    assert mfu.flops(300) == 30 * 300 * 300 + 900 ** 3
    # 7,000 solves a second of N=300 are 7.6% of 67 TFLOP/s
    assert round(100 * mfu.flops(300) * 7000 / peaks.F32_FLOPS, 1) == 7.6
