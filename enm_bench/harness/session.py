"""
One run of one cell: set-up (inputs from the seed, the program's
parameters, warm-up of every shape the traffic uses), the measured window
(requests in a closed loop until ``seconds`` have passed; with tracing, a
bounded stretch of it under the profiler), then, once the window has
closed and the peak memory is read, the check of the sampled answers
against the reference.  Returns the result line.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import math
import sys
import time

import torch

from . import program, spec
from .trace import Tracer


class ForbiddenModules(RuntimeError):
    """JAX or the JAX package was loaded in the run's process."""


@dataclasses.dataclass
class LayerRun:
    """What a per-layer metric's reader reads: the trace of the traced
    requests (``None`` without one), the solves inside it, the cell's
    shapes, the configuration and the
    traffic, and the work units and host-clock seconds of the window
    outside the traced requests, which ran without the profiler."""

    trace: object
    work: int
    shapes: dict
    config: dict
    traffic: dict
    untraced_work: int
    untraced_s: float


def _forbidden_check():
    found = program.forbidden_modules(list(sys.modules))
    if found:
        raise ForbiddenModules(
            "modules of JAX or the JAX package are loaded: "
            + ", ".join(found))


def _device_info(device, peak):
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "memory_peak_bytes": int(peak)}


def run_cell(cell, seed, seconds, trace, started, device="cuda",
             control=None, max_requests=None):
    """Run `cell` (a :class:`spec.Cell`) once and return ``(result,
    checks)``: the result line's object and the compared numbers with
    their limits.  `started` is the process's start on the
    ``time.perf_counter`` clock; `control` a control mode of the route
    and `max_requests` a cap on the window's requests (both for the
    readings that set the limits, never in a benchmark run)."""
    route_mod = importlib.import_module(
        f"enm_bench.routes.{cell.traffic['route']}")
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    tracer = Tracer(device)
    route = route_mod.Route(cell, seed, device, control, tracer)
    route.setup()
    route.warmup()
    traced = range(0)
    if trace:
        first, count = cell.traffic["traced_requests"]
        traced = range(int(first), int(first) + int(count))
        tracer.warm(route.warmup)
    attempted = failed = work = traced_work = 0
    traced_s = 0.0
    t0 = time.perf_counter()
    setup_s = t0 - started
    end = t0
    while True:
        if trace and attempted == traced.start:
            traced_from = time.perf_counter()
            tracer.start()
        attempted += 1
        try:
            units = route.request(attempted - 1)
        except Exception as exc:  # a failed request ends the window
            failed += 1
            print(f"request {attempted - 1} failed: {exc!r}",
                  file=sys.stderr)
            break
        end = time.perf_counter()
        work += units
        if tracer.active:
            traced_work += units
            if attempted == traced.stop:
                tracer.stop()
                end = time.perf_counter()
                traced_s = end - traced_from
        if tracer.active or attempted < traced.stop:
            continue
        if end - t0 >= seconds or (max_requests
                                   and attempted >= max_requests):
            break
    elapsed = end - t0
    _forbidden_check()
    dev = torch.device(device)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    device_info = _device_info(device, peak)
    metrics = {}
    if not trace and work:
        values = dict(route.end_to_end(elapsed, work), setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    breakdown = None
    if trace and tracer.trace is not None:
        t = tracer.trace
        device_info.update(busy_s=t.busy_s, window_s=t.window_s)
        layer = LayerRun(
            trace=t, work=traced_work,
            shapes=route.shapes(), config=cell.config, traffic=cell.traffic,
            untraced_work=work - traced_work,
            untraced_s=elapsed - traced_s)
        for m in cell.per_layer:
            value = spec.load_reader(m["name"]).read(layer)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = t.breakdown()
        tracer.trace = None
    route.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = route.check()
    checks = {name: {"value": readings[name], "limit": limit}
              for name, limit in cell.limits.items()}
    correct = (failed == 0 and work > 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()))
    _forbidden_check()
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result, readings

