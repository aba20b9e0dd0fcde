"""K2's share of its roofline, %: the regularized, equilibrated,
identity-padded factor input of each conformer (``ops/rigid.py`` ->
``csrc/regularize_stitch.cu``).  Work of one conformer of n atoms (m = 3n
rows, padded to mp as the blocked engine factors it): the nine (n, n)
planes, the scale and the six scaled rigid-body columns read once, the
(mp, mp) input written once; 14 operations an entry."""

from enm_bench.harness import peaks
from enm_bench.harness.counts import padded_size

KERNEL = "regularize_stitch_kernel"


def work(n, mp=None):
    """``(bytes, flops)`` of one conformer."""
    m = 3 * n
    mp = padded_size(m) if mp is None else mp
    return 4 * (9 * n * n + 7 * m + mp * mp), 14 * m * m


def read(run):
    if run.trace is None or not run.work:
        return None
    nbytes, flops = work(run.shapes["n"])
    seconds = run.trace.seconds(lambda op: KERNEL in op.name)
    return peaks.roofline_pct(run.work * nbytes, run.work * flops, seconds)
