"""
Wall-clock timing that waits for the card, and a profiler trace.

The port's own copy of ``springcraft_tpu/utils/profiling.py``.  CUDA
launches return before the device finishes, so a host clock stops only
after :func:`synchronize`; :func:`trace` records a ``torch.profiler``
Chrome trace (host and, on a card, device activity), in which
:func:`span` names the program's stages.
"""

from __future__ import annotations

import contextlib
import pathlib
import sys
import time

import torch

__all__ = ["synchronize", "Timer", "timed", "trace", "span"]

#: Where :func:`trace` writes by default: ``build/profile/`` at the root
#: of the checkout (``.gitignore`` lists it).
TRACE_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "profile"

#: The prefix of every span the program records.
SPAN_PREFIX = "springcraft::"

_NO_SPAN = contextlib.nullcontext()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for value in tree.values():
            yield from _tensors(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _tensors(value)


def synchronize(tree=None):
    """
    Wait for the work queued on every CUDA device that holds a tensor of
    `tree` (a tensor, or dicts, lists and tuples of them; other leaves are
    ignored), and return `tree`.  Without a `tree`, wait for the current
    CUDA device.  Tensors on the CPU need no wait.
    """
    if tree is None:
        torch.cuda.synchronize()
        return tree
    for device in {t.device for t in _tensors(tree)
                   if t.device.type == "cuda"}:
        torch.cuda.synchronize(device)
    return tree


class Timer:
    """Accumulating named wall-clock timer.

    >>> timer = Timer()
    >>> with timer("assembly"):
    ...     h = synchronize(build(...))
    >>> timer.report()

    `sync`, a tree for :func:`synchronize`, is waited for before the
    clock stops.
    """

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def __call__(self, name, sync=None):
        start = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                synchronize(sync)
            self.totals[name] = self.totals.get(name, 0.0) + (
                time.perf_counter() - start)
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, stream=None):
        stream = stream or sys.stderr
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            n = self.counts[name]
            print(f"{name:32s} {total:9.3f}s  ({n}x, "
                  f"{total / n * 1000:8.2f} ms/call)", file=stream)


def timed(fn, *args, repeats=3, **kwargs):
    """Best-of-`repeats` wall time of ``fn(*args, **kwargs)``, each call
    to a :func:`synchronize` of its result.

    Returns ``(seconds, result)``; the first call (kernel builds, caches)
    is excluded."""
    result = synchronize(fn(*args, **kwargs))
    best = float("inf")
    for _ in range(repeats):
        start = time.perf_counter()
        result = synchronize(fn(*args, **kwargs))
        best = min(best, time.perf_counter() - start)
    return best, result


@contextlib.contextmanager
def trace(log_dir=None):
    """Record a ``torch.profiler`` trace of the block (CPU activity, and
    CUDA activity when a card is present) and write it as a Chrome trace
    ``trace.json`` in `log_dir` (default :data:`TRACE_DIR`), viewable in
    Perfetto or ``chrome://tracing``.  Yields `log_dir`."""
    log_dir = pathlib.Path(TRACE_DIR if log_dir is None else log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def span(name):
    """
    A context that names a stage of the program ``springcraft::<name>``
    in a running ``torch.profiler`` trace: a ``record_function`` span on
    the profiler's host timeline, which the profiler aligns with the
    device's, so the kernels launched inside it lie under it.  Without a
    running profiler it is one shared no-op context, and no
    ``record_function`` operator is called.
    """
    if not torch._C._autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(SPAN_PREFIX + name)
