"""
Stage breakdown of the PyTorch port's main path on one NVIDIA GPU.

Runs the headline configuration of ``chip_smoke.py`` (1024 conformers of
300 residues, invariant force field at 13 A, float32) and prints:

1. the card's name and power limit, as ``nvidia-smi`` prints them;
2. the device time of each stage on one 128-conformer chunk (CUDA-event
   means), and of one panel-inverse launch;
3. a ``torch.profiler`` trace of one 1024-conformer call: the wall time,
   the union of the kernels' intervals (the device's busy share under
   the profiler) and the kernels with the most device time;
4. the rate and peak device memory at several chunk sizes (three calls
   each).

The table and the Chrome trace go to ``--out``.

Usage:  python tools/profile_torch_slice.py [--out DIR] [--reps N]
"""

import argparse
import json
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.realpath(__file__)), ".."))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import springcraft_tpu_torch as sct  # noqa: E402
from springcraft_tpu_torch.ops import (assembly_kernels, rigid,  # noqa: E402
                                       spd_linalg)
from springcraft_tpu_torch.parallel import pipeline  # noqa: E402

CHUNKS = (64, 128, 256, 512, 1024)


def busy_intervals(trace_path):
    """``(busy_us, per_kernel_us)`` of the kernels in a Chrome trace:
    the union of their intervals and the summed time by kernel name."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    spans, per_kernel = [], defaultdict(float)
    for e in events:
        if e.get("cat") == "kernel" and "dur" in e:
            spans.append((e["ts"], e["ts"] + e["dur"]))
            per_kernel[e["name"]] += e["dur"]
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy, per_kernel


def stage_times(dev, params, reps):
    c = dev[:cs.CHUNK].contiguous()
    n = c.shape[1]
    bases = rigid.rigid_modes_anm(c)
    planes = assembly_kernels.hessian_planes_ensemble(c, params)
    scale, sigma, scale_h, ts = rigid.stitch_inputs(planes, bases)
    mp = spd_linalg.padded_size(3 * n)
    reg = assembly_kernels.regularize_stitch(planes, scale_h, ts, mp)
    parts = rigid._w_parts_from_reg_blocked(reg, scale, 3 * n)
    traces = rigid._plane_traces_from_w_parts(parts, bases, sigma, n)
    leaves = reg[:, :spd_linalg.LEAF, :spd_linalg.LEAF].contiguous()
    stages = {
        "1 rigid bases (torch.linalg.qr)":
            lambda: rigid.rigid_modes_anm(c),
        "2 K1 hessian_planes":
            lambda: assembly_kernels.hessian_planes_ensemble(c, params),
        "3a stitch inputs (scale, sigma, ts)":
            lambda: rigid.stitch_inputs(planes, bases),
        "3b K2 regularize_stitch":
            lambda: assembly_kernels.regularize_stitch(planes, scale_h, ts,
                                                       mp),
        "4 inverse factor (nodes + K3 leaves)":
            lambda: spd_linalg.spd_inverse_factor_parts(reg),
        "4+ inverse factor and column scaling":
            lambda: rigid._w_parts_from_reg_blocked(reg, scale, 3 * n),
        "5 plane-trace Grams":
            lambda: rigid._plane_traces_from_w_parts(parts, bases, sigma, n),
        "6 observables":
            lambda: pipeline._anm_trace_observables(traces, True),
        f"K3, one launch of {leaves.shape[0]} panels":
            lambda: spd_linalg.panel_inverse_batched(leaves),
        "whole chunk": lambda: run(c, params),
    }
    for name, fn in stages.items():
        print(f"stage {name}: {cs.cuda_ms(fn, reps=reps):.4f} ms",
              flush=True)


def run(x, params, chunk=cs.CHUNK):
    return sct.ensemble_anm_fluctuations(
        x, params, inverse="blocked", with_dcc=True, dtype=torch.float32,
        chunk=chunk, device="cuda")


def profiled_call(dev, params, out):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(dev, params)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    trace_path = os.path.join(out, "trace_main_path.json")
    prof.export_chrome_trace(trace_path)
    with open(os.path.join(out, "profile_table.txt"), "w") as fh:
        fh.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                           row_limit=60))
    busy_us, per_kernel = busy_intervals(trace_path)
    launches = sum(e.count for e in prof.key_averages()
                   if e.key == "cudaLaunchKernel")
    print(f"profiled call: wall {wall_ms:.2f} ms, kernels busy "
          f"{busy_us / 1e3:.2f} ms ({busy_us / 1e3 / wall_ms:.3f} of the "
          f"wall, under the profiler), {launches} cudaLaunchKernel",
          flush=True)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:20]
    for name, us in top:
        print(f"  {us / 1e3:9.3f} ms  {name[:100]}", flush=True)


def chunk_sweep(dev, params):
    n_conf = dev.shape[0]
    for chunk in CHUNKS:
        run(dev, params, chunk)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            run(dev, params, chunk)
            torch.cuda.synchronize()
            rates.append(n_conf / (time.perf_counter() - t0))
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"chunk {chunk}: " + ", ".join(f"{r:.1f}" for r in rates)
              + f" solves/s; peak {peak:.2f} GiB", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default="build/profile",
                        help="directory for the trace and the table")
    parser.add_argument("--reps", type=int, default=10,
                        help="calls per stage timing")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_slice: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    card = cs.card_line()
    print(card, flush=True)
    params = sct.invariant_params(cs.CUTOFF)
    dev = torch.as_tensor(cs.make_conformers(cs.N_CONFORMERS, cs.N_RES,
                                             cs.SEED), device="cuda")
    run(dev, params)
    torch.cuda.synchronize()
    stage_times(dev, params, args.reps)
    profiled_call(dev, params, args.out)
    chunk_sweep(dev, params)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
