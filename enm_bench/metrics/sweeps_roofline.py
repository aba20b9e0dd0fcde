"""The shift-invert sweeps' share of their roofline, %: the iterations of
``lowest_modes_anm`` and their Rayleigh-Ritz (``ops/modes.py``
``_shift_invert_iterate``), the device time of the operations launched
inside the program's ``springcraft::sweeps`` span.  Work of one sweep at
m = 3n and a block of b columns, from the problem: the factor's lower
triangle, m (m + 1) / 2 floats, read by each of the two triangular
solves, and 2 m^2 b operations (m^2 b a solve); times the sweeps that the
traced requests ran (the program's counter
``lowest_modes_shift_invert.sweeps``, in the route's ``shapes``).  None
where no device operation lies inside that span, or without the
counter."""

from enm_bench.harness import peaks

SPAN = "springcraft::sweeps"


def work(n, block):
    """``(bytes, flops)`` of one sweep."""
    m = 3 * n
    return 2 * 4 * m * (m + 1) // 2, 2 * m * m * block


def read(run):
    if run.trace is None or not run.work:
        return None
    sweeps = run.shapes.get("sweeps")
    if not sweeps:
        return None
    seconds = run.trace.seconds(lambda op: SPAN in op.launched_under)
    nbytes, flops = work(run.shapes["n"], run.shapes["block"])
    return peaks.roofline_pct(sweeps * nbytes, sweeps * flops, seconds)
