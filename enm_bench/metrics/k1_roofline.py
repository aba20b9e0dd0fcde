"""K1's share of its roofline, %: the nine raw Hessian planes of each
conformer (``ops/assembly_kernels.py`` -> ``csrc/hessian_planes.cu``).
Work of one conformer of n atoms: its coordinates read once (3n floats)
and its nine (n, n) planes written once; 30 operations a pair."""

from enm_bench.harness import peaks

KERNEL = "hessian_kernel"


def work(n):
    """``(bytes, flops)`` of one conformer."""
    return 4 * (3 * n + 9 * n * n), 30 * n * n


def read(run):
    if run.trace is None or not run.work:
        return None
    nbytes, flops = work(run.shapes["n"])
    seconds = run.trace.seconds(lambda op: KERNEL in op.name)
    return peaks.roofline_pct(run.work * nbytes, run.work * flops, seconds)
