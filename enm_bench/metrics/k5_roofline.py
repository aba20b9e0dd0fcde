"""K5's share of its roofline, %: one structure's xyz Hessian
(``ops/pallas_kernels.py`` ``hessian_pallas`` -> ``csrc/hessian_planes.cu``
``sc_hessian_xyz``), the device time of the operations launched inside
the program's ``springcraft::assembly`` span.  Work of one structure of
n atoms under a tabulated family of `bins` distance bins (the route's
``shapes``; sdENM: 26), from the problem: its coordinates read once (3n floats), the (3n, 3n)
Hessian written once, the family's (bins, 3, 20, 20) tables, `bins` bin
edges and n atom codes read once; 30 operations a pair.  None where no
device operation lies inside that span."""

from enm_bench.harness import peaks

SPAN = "springcraft::assembly"


def work(n, bins):
    """``(bytes, flops)`` of one structure."""
    return (4 * (3 * n + 9 * n * n) + 4 * (bins * 1200 + bins + n),
            30 * n * n)


def read(run):
    if run.trace is None or not run.work:
        return None
    seconds = run.trace.seconds(lambda op: SPAN in op.launched_under)
    nbytes, flops = work(run.shapes["n"], run.shapes["bins"])
    return peaks.roofline_pct(run.work * nbytes, run.work * flops, seconds)
