"""The float32 Cholesky factor's share of its roofline, %: the factor of
the regularized (3n, 3n) Hessian in ``lowest_modes_anm``
(``ops/modes.py``, ``rigid._cholesky_factor``), the device time of the
operations launched inside the program's ``springcraft::cholesky``
span.  Work of one structure of n atoms, from the problem: m^3 / 3
operations at m = 3n (LAPACK's potrf count), the (m, m) input read once
and its factor written once.  None where no device operation lies inside
that span."""

from enm_bench.harness import peaks

SPAN = "springcraft::cholesky"


def work(n):
    """``(bytes, flops)`` of one structure."""
    m = 3 * n
    return 2 * 4 * m * m, m ** 3 / 3


def read(run):
    if run.trace is None or not run.work:
        return None
    seconds = run.trace.seconds(lambda op: SPAN in op.launched_under)
    nbytes, flops = work(run.shapes["n"])
    return peaks.roofline_pct(run.work * nbytes, run.work * flops, seconds)
