"""Device microseconds per solve of the inverse factor's node products
(``ops/spd_linalg.py``): the operations that ``gemm_us_per_solve``
counts (launched under a ``torch.matmul`` family operator, not inside
the QR) whose launch lies inside the program's ``springcraft::
inverse_factor`` span.  None where no device operation lies inside that
span: a program without the span, or a trace without a card."""

from enm_bench.harness import spec

SPAN = "springcraft::inverse_factor"


def gemm_us_under(run, span):
    """Device microseconds a solve of the GEMMs launched inside `span`,
    or None where no device operation was launched inside it."""
    if run.trace is None or not run.work:
        return None
    is_gemm = spec.load_reader("gemm_us_per_solve").is_gemm
    inside = [op for op in run.trace.ops if span in op.launched_under]
    if not inside:
        return None
    return 1e6 * sum(op.seconds for op in inside if is_gemm(op)) / run.work


def read(run):
    return gemm_us_under(run, SPAN)
