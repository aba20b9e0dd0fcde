"""Device idle share of the window's ensemble calls, %: one less the
device-busy seconds a solve of the traced calls (the union of the device
operations' intervals in ``torch.profiler``'s trace, over the solves in
it) times the solves a second of the window's untraced calls.  The
profiler slows the host, so the traced stretch's own idle share (the
result line's ``busy_s`` and ``window_s``) reads higher than the
window's."""


def read(run):
    if run.trace is None or not run.work or not run.untraced_work:
        return None
    busy_per_solve = run.trace.busy_s / run.work
    return 100.0 * (1.0 - busy_per_solve * run.untraced_work
                    / run.untraced_s)
