"""
The traced part of a ``--trace 1`` run: ``torch.profiler`` (CPU and CUDA
activity) over a bounded, steady stretch of the window, its events read
in memory from the profiler's results, nothing written to disk.

From the events:

* every device operation (kernel, copy, set) with its interval and the
  names of the host spans and operators it was launched under (the
  launch's correlation ID matched to the host call stack of its thread);
* the traced window, the harness's own ``enm_bench::traced`` span;
* ``busy_s``, the union of the device operations' intervals within it;
* the idle gaps, each named by what the host was doing at its middle:
  the harness span and the innermost operator there.
"""

from __future__ import annotations

import bisect
import collections
import contextlib

import torch

WINDOW = "enm_bench::traced"
SPAN = "enm_bench::"


class DeviceOp:
    __slots__ = ("name", "start", "end", "launched_under")

    def __init__(self, name, start, end, launched_under):
        self.name, self.start, self.end = name, start, end
        self.launched_under = launched_under

    @property
    def seconds(self):
        return (self.end - self.start) * 1e-9


class Trace:
    """The device operations of the traced window and its host events."""

    def __init__(self, device_ops, host, window):
        self.window = window
        lo, hi = window
        self.ops = [op for op in device_ops if op.end > lo and op.start < hi]
        self.window_s = (hi - lo) * 1e-9
        self._spans = [e for e in host
                       if e[2].startswith(SPAN) and e[2] != WINDOW]
        self._host = [e for e in host if not e[2].startswith(SPAN)]
        self._host_starts = [e[0] for e in self._host]
        self._segments = _union((max(op.start, lo), min(op.end, hi))
                                for op in self.ops)
        self.busy_s = sum(b - a for a, b in self._segments) * 1e-9

    def seconds(self, match):
        """Device seconds of the operations for which `match(op)` holds."""
        return sum(op.seconds for op in self.ops if match(op))

    def count(self, match=None):
        return sum(1 for op in self.ops if match is None or match(op))

    def gaps(self):
        """``(start, end)`` of every interval of the window in which no
        device operation ran."""
        lo, hi = self.window
        edges = [lo] + [x for seg in self._segments for x in seg] + [hi]
        return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]

    def host_label(self, t):
        """The harness span and the innermost host operator at time `t`."""
        spans = [e for e in self._spans if e[0] <= t <= e[1]]
        span = max(spans)[2][len(SPAN):] if spans else "window"
        i = bisect.bisect_right(self._host_starts, t)
        op = "python"
        for start, end, name in reversed(self._host[max(0, i - 3000):i]):
            if end >= t and not name.startswith("cu"):
                op = name
                break
        return f"{span}: {op}"

    def breakdown(self, top=10):
        """The device operations that took most time and the idle time by
        what the host was doing, each ``[[name, seconds], ...]``."""
        by_op = collections.Counter()
        for op in self.ops:
            by_op[_short(op.name)] += op.seconds
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:500]
        by_host = collections.Counter()
        for a, b in gaps:
            by_host[self.host_label((a + b) // 2)] += (b - a) * 1e-9
        return {"device_ops": [[k, v] for k, v in by_op.most_common(top)],
                "idle_gaps": [[k, v] for k, v in by_host.most_common(top)]}


def _short(name, width=120):
    name = name.removeprefix("void ")
    return name if len(name) <= width else name[:width]


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [tuple(seg) for seg in merged]


def _is_device(event):
    return str(event.device_type()).endswith("CUDA")


def _is_annotation(event):
    """A span of the host drawn on the device's timeline (the profiler
    copies ``record_function`` spans there): no device operation."""
    return event.name().startswith(SPAN) or bool(
        getattr(event, "is_user_annotation", lambda: False)())


def parse(prof):
    """A :class:`Trace` of a stopped ``torch.profiler.profile``."""
    device, host_by_thread, window = [], collections.defaultdict(list), None
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        row = (start, start + e.duration_ns(), e.name())
        if _is_device(e):
            if not _is_annotation(e):
                device.append(row + (e.correlation_id(),))
            continue
        if row[2] == WINDOW:
            window = row[:2]
        host_by_thread[e.start_thread_id()].append(row + (e.correlation_id(),))
    if window is None:
        raise RuntimeError("the traced window's span is not in the trace")
    launched_under, main = {}, []
    for rows in host_by_thread.values():
        rows.sort(key=lambda r: (r[0], -r[1]))
        stack = []
        for start, end, name, corr in rows:
            while stack and stack[-1][1] < start:
                stack.pop()
            if corr:
                launched_under[corr] = tuple(s[2] for s in stack)
            stack.append((start, end, name))
        if any(r[2] == WINDOW for r in rows):
            main = [r[:3] for r in rows]
    ops = [DeviceOp(name, start, end, launched_under.get(corr, ()))
           for start, end, name, corr in device]
    return Trace(ops, main, window)


class Tracer:
    """Starts and stops the profiler around the traced requests; ``span``
    names a stage of a request in the trace (a no-op when not tracing)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self._prof = self._window = None
        self.trace = None

    def _activities(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def warm(self, fn):
        """Profile `fn` once and drop the result: the profiler's own
        start-up belongs to set-up, not to the window."""
        with torch.profiler.profile(activities=self._activities()):
            fn()
            self._sync()

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    @property
    def active(self):
        return self._prof is not None

    def start(self):
        self._sync()
        self._prof = torch.profiler.profile(activities=self._activities())
        self._prof.start()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()

    def stop(self):
        self._sync()
        self._window.__exit__(None, None, None)
        self._prof.stop()
        self.trace = parse(self._prof)
        self._prof = self._window = None

    def span(self, name):
        if self._prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(SPAN + name)
