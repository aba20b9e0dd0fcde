"""Device microseconds per solve of the Grams (``ops/rigid.py``: the
plane traces, or the covariance Gram and its null-space term): the
operations that ``gemm_us_per_solve`` counts whose launch lies inside
the program's ``springcraft::grams`` span.  None where no device
operation lies inside that span."""

from enm_bench.harness import spec

SPAN = "springcraft::grams"


def read(run):
    return spec.load_reader("factor_gemm_us_per_solve").gemm_us_under(
        run, SPAN)
