"""Share of the traced calls' chunks that replayed a CUDA graph: 100 x
the program's ``springcraft::graph_replay`` spans (``parallel/
pipeline.py`` ``_run_graphed``, one around each replay) over its
``springcraft::chunk`` spans, on the main thread's host rows within the
traced window.  A program whose chunk loop replays no graph reads 0;
None where the trace holds no chunk span."""

CHUNK = "springcraft::chunk"
REPLAY = "springcraft::graph_replay"


def share(host, window):
    """100 x the replay spans over the chunk spans among the host rows
    ``(start, end, name)`` that overlap `window`, or None without a chunk
    span."""
    lo, hi = window
    names = [name for a, b, name in host if b > lo and a < hi]
    chunks = names.count(CHUNK)
    if not chunks:
        return None
    return 100.0 * names.count(REPLAY) / chunks


def read(run):
    if run.trace is None:
        return None
    return share(run.trace._host, run.trace.window)
