"""Device operations (kernels, copies, sets) launched per solve in the
traced ensemble calls: the entry point's and the chunk loop's launch
count (``parallel/pipeline.py``), read from the trace."""


def read(run):
    if run.trace is None or not run.work:
        return None
    count = run.trace.count()
    return count / run.work if count else None
