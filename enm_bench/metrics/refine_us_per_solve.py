"""Host microseconds a solve of the float64 refinement: the program's
``springcraft::refine`` spans (``ops/modes.py`` ``refine_modes_f64``,
its host pair search ``springcraft::pair_search`` included), on the main
thread's host rows within the traced window, over the solves in it.  The
profiler's host clock, inflated by its own work on every operator.  None
where the trace holds no such span."""

SPAN = "springcraft::refine"


def span_ns(host, window, name=SPAN):
    """Nanoseconds of the host rows ``(start, end, name)`` called `name`
    within `window`, or None without one."""
    lo, hi = window
    rows = [(max(a, lo), min(b, hi)) for a, b, n in host
            if n == name and b > lo and a < hi]
    if not rows:
        return None
    return sum(b - a for a, b in rows)


def read(run):
    if run.trace is None or not run.work:
        return None
    ns = span_ns(run.trace._host, run.trace.window)
    return None if ns is None else 1e-3 * ns / run.work
