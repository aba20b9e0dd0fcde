"""Host microseconds per solve that the program's entry span
(``springcraft::ensemble_anm_fluctuations`` or ``..._gnm_...``) spends
outside its stage spans (``rigid_bases``, ``assembly``, ``prep``,
``inverse_factor``, ``grams``, ``observables``): the entry's ``_prepare``,
the chunk loop's Python and its writes into the preallocated outputs,
summed over the traced calls.  Read from the main thread's host events
that ``Trace`` keeps, on the profiler's host clock: the profiler's own
work on every operator inflates it, so it reads above the same code's
time without the profiler.  None where the trace holds no entry span."""

from enm_bench.harness.trace import _union

PREFIX = "springcraft::"
ENTRIES = (PREFIX + "ensemble_anm_fluctuations",
           PREFIX + "ensemble_gnm_fluctuations")
STAGES = tuple(PREFIX + s for s in ("rigid_bases", "assembly", "prep",
                                    "inverse_factor", "grams",
                                    "observables"))


def self_ns(host, window):
    """Nanoseconds of the entry spans among the host rows ``(start, end,
    name)`` within `window` that no stage span covers, or None without
    an entry span."""
    lo, hi = window
    entries = [(max(a, lo), min(b, hi)) for a, b, name in host
               if name in ENTRIES and b > lo and a < hi]
    if not entries:
        return None
    stages = _union((a, b) for a, b, name in host if name in STAGES)
    total = 0
    for a, b in entries:
        covered = sum(max(0, min(b, y) - max(a, x)) for x, y in stages)
        total += (b - a) - covered
    return total


def read(run):
    if run.trace is None or not run.work:
        return None
    ns = self_ns(run.trace._host, run.trace.window)
    return None if ns is None else 1e-3 * ns / run.work
