"""The whole solve's share of the card's float32 peak, %: the operations
that one conformer needs, counted from the problem at m = 3n (the
Hessian's 30 operations a pair, then its inverse: a Cholesky, the
triangular inverse and the product of the inverse factors, m^3 / 3
each, as LAPACK's potrf, trtri and lauum count them), times the solves a
second of the window's untraced calls, over 67 TFLOP/s."""

from enm_bench.harness import peaks


def flops(n):
    """Operations of one conformer of n atoms."""
    return 30 * n * n + (3 * n) ** 3


def read(run):
    if not run.untraced_work:
        return None
    rate = run.untraced_work / run.untraced_s
    return 100.0 * flops(run.shapes["n"]) * rate / peaks.F32_FLOPS
