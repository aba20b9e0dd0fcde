"""
What the graphed chunk loop of ``ensemble_anm_fluctuations``
(``parallel/pipeline.py`` ``_run_graphed``) costs beside the eager loop
(``_run_chunked``), on ``chip_smoke.py``'s conformers (1,024 x N=300, the
invariant field at 13 A, blocked engine, float32):

* ``steady``: one configuration called again and again (plane traces,
  and covariance with PRS, in chunks of 128), the graph captured once;
* ``alternating``: a caller that alternates the two configurations, so
  that the one graph of the entry point is freed and captured again on
  every call;
* ``single``: ``chunk=None``, the whole batch one chunk, which keeps the
  eager loop on both sides.

For each, in one process, eager and graphed in turns: the median host
time of a call (synchronized), the peak of allocated device memory over
the calls, the memory still allocated and still reserved once the calls
have returned, and the captures and replays the graphed calls made.
Prints one JSON line a case after the card's name and power limit.  GPU
only.

Usage:  python3 tools/chunk_graph_costs.py [--calls 6]
"""

import argparse
import gc
import importlib.util
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def measure(calls, graphed, n_calls):
    """Run `calls` (a list of zero-argument callables, taken in turn)
    `n_calls` times; returns the case's numbers."""
    import torch

    from springcraft_tpu_torch.parallel import pipeline

    saved = pipeline._graphs_apply
    if not graphed:
        pipeline._graphs_apply = lambda *args: False
    try:
        pipeline._CHUNK_GRAPHS.clear()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        captures = pipeline._run_graphed.captures
        replays = pipeline._run_graphed.replays
        seconds = []
        for i in range(n_calls):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = calls[i % len(calls)]()
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            del out
        gc.collect()
        return {
            "graphed": graphed,
            "call_ms": [round(1e3 * s, 3) for s in seconds],
            "median_ms_after_first": round(
                1e3 * statistics.median(seconds[len(calls):]), 3),
            "peak_gib": round((torch.cuda.max_memory_allocated() - base)
                              / 2**30, 3),
            "held_after_gib": round((torch.cuda.memory_allocated() - base)
                                    / 2**30, 3),
            "reserved_after_gib": round(torch.cuda.memory_reserved()
                                        / 2**30, 3),
            "captures": pipeline._run_graphed.captures - captures,
            "replays": pipeline._run_graphed.replays - replays,
        }
    finally:
        pipeline._graphs_apply = saved
        pipeline._CHUNK_GRAPHS.clear()


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--calls", type=int, default=6)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chunk_graph_costs: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import springcraft_tpu_torch as sct

    smoke = load_chip_smoke()
    print(smoke.card_line(), flush=True)
    smoke.build_kernels()
    params = sct.invariant_params(smoke.CUTOFF)
    coords = torch.as_tensor(smoke.make_conformers(
        smoke.N_CONFORMERS, smoke.N_RES, smoke.SEED), device="cuda")

    def call(chunk, **options):
        return lambda: sct.ensemble_anm_fluctuations(
            coords, params, inverse="blocked", chunk=chunk, device="cuda",
            **options)

    traces = call(smoke.CHUNK, with_covariance=False)
    cov_prs = call(smoke.CHUNK, with_covariance=True, with_prs=True)
    cases = {"steady.traces": [traces], "steady.cov-prs": [cov_prs],
             "alternating": [traces, cov_prs],
             "single.traces": [call(None, with_covariance=False)]}
    for name, calls in cases.items():
        for graphed in (False, True, True, False):
            line = {"case": name, "batch": smoke.N_CONFORMERS,
                    **measure(calls, graphed, args.calls)}
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
