"""K3's share of its roofline, %: the inverse factor's leaves
(``ops/spd_linalg.py`` -> ``csrc/panel_inverse.cu``), the inverse
triangular factor of each diagonal (leaf, leaf) panel of the padded
(mp, mp) input.  Work of one conformer: mp / leaf panels, each read and
written once; leaf^3 / 3 multiply-adds a panel."""

from enm_bench.harness import peaks
from enm_bench.harness.counts import padded_size

KERNEL = "panel_inverse_kernel"
LEAF = 64


def work(n, mp=None, leaf=LEAF):
    """``(bytes, flops)`` of one conformer."""
    mp = padded_size(3 * n) if mp is None else mp
    panels = mp // leaf
    return panels * 2 * 4 * leaf * leaf, panels * 2 * leaf ** 3 // 3


def read(run):
    if run.trace is None or not run.work:
        return None
    nbytes, flops = work(run.shapes["n"])
    seconds = run.trace.seconds(lambda op: KERNEL in op.name)
    return peaks.roofline_pct(run.work * nbytes, run.work * flops, seconds)
