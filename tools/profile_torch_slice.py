"""
Stage breakdown of the PyTorch port's main path on one NVIDIA GPU.

Runs the headline configuration of ``chip_smoke.py`` (1024 conformers of
300 residues, invariant force field at 13 A, float32) and prints:

1. the card's name and power limit, as ``nvidia-smi`` prints them;
2. the device time of each stage on one 128-conformer chunk (CUDA-event
   means), and of one panel-inverse launch, for the plane-trace path, for
   the path with the covariance and PRS, and for the GNM ensemble; the
   stages of ``prep="direct"`` (K7's row-sum pass, the scale and basis,
   K7's store pass) beside the planes
   path's; then the same chunk under the tabulated sdENM force field
   (the assembly kernels' table branch; ``--skip-tabulated`` leaves it
   out);
3. the same for the spectral pipelines (``--reps-spectral`` calls each):
   ``ensemble_anm_spectral`` with the JAX package's benchmark settings
   (20 modes, 32 halvings) and ``ensemble_anm_banded`` (``--skip-spectral``
   leaves them and their trace out);
4. ``torch.profiler`` traces of one 1024-conformer call of the main path
   and of one 128-conformer chunk of ``ensemble_anm_spectral``: the wall
   time, the union of the kernels' intervals (the device's busy share
   under the profiler) and the kernels with the most device time (a
   banded chunk, with the window refinement's per-matrix QR launches, is
   more than the profiler digests in minutes);
5. the main path's rate and peak device memory at several chunk sizes
   (three calls each).

The tables and the Chrome traces go to ``--out``.

Usage:  python tools/profile_torch_slice.py [--out DIR] [--reps N]
            [--reps-spectral N] [--skip-spectral] [--skip-tabulated]
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
from springcraft_tpu_torch.ops import (assembly_kernels, modes,  # noqa: E402
                                       rigid, spd_linalg, spectrum)
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


def stage_times(dev, params, reps, label=""):
    """Stage times of one chunk of the three fluctuation paths under
    `params`, each line prefixed with `label`; for an analytic family
    also the stages of ``prep="direct"``."""
    c = dev[:cs.CHUNK].contiguous()
    n = c.shape[1]
    bases = rigid.rigid_modes_anm(c)
    planes = assembly_kernels.hessian_planes_ensemble(c, params)
    scale, sigma, scale_h, ts = rigid.stitch_inputs(planes, bases)
    mp = spd_linalg.padded_size(3 * n)
    reg = assembly_kernels.regularize_stitch(planes, scale_h, ts, mp)
    parts = rigid._w_parts_from_reg_blocked(reg, scale)
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
            lambda: rigid._w_parts_from_reg_blocked(reg, scale),
        "5 plane-trace Grams":
            lambda: rigid._plane_traces_from_w_parts(parts, bases, sigma, n),
        "6 observables":
            lambda: pipeline._anm_trace_observables(traces, True),
        f"K3, one launch of {leaves.shape[0]} panels":
            lambda: spd_linalg.panel_inverse_batched(leaves, shrink_block=8),
        "whole chunk": lambda: run(c, params),
    }
    m = 3 * n
    w = rigid._w_from_reg_blocked(reg, scale)
    cov = rigid._gram_lower(w)[..., :m, :m] - rigid._null_projector(bases,
                                                                     sigma)
    stages.update({
        "C4 full inverse factor and column scaling":
            lambda: rigid._w_from_reg_blocked(reg, scale),
        "C5 covariance Gram (_gram_lower) and null-space term":
            lambda: (rigid._gram_lower(w)[..., :m, :m]
                     - rigid._null_projector(bases, sigma)),
        "C6 observables with PRS":
            lambda: pipeline._anm_cov_observables(cov, n, True, True),
        "C whole chunk with the covariance and PRS":
            lambda: run(c, params, with_covariance=True, with_prs=True),
    })
    kirchhoffs = assembly_kernels.kirchhoff_ensemble(c, params)
    t = rigid.null_mode_gnm(n, device=c.device)
    greg, gscale, gsigma = rigid._regularize_equilibrated(
        kirchhoffs, t, pad_to=spd_linalg.padded_size(n))
    gw = rigid._w_from_reg_blocked(greg, gscale)
    gcov = rigid._gram_lower(gw)[..., :n, :n] - rigid._null_projector(
        t, gsigma)
    stages.update({
        "G1 K4 kirchhoff": lambda: assembly_kernels.kirchhoff_ensemble(
            c, params),
        "G2 regularize (plain)": lambda: rigid._regularize_equilibrated(
            kirchhoffs, t, pad_to=spd_linalg.padded_size(n)),
        "G3 inverse factor and column scaling":
            lambda: rigid._w_from_reg_blocked(greg, gscale),
        "G4 covariance Gram and null-space term":
            lambda: (rigid._gram_lower(gw)[..., :n, :n]
                     - rigid._null_projector(t, gsigma)),
        "G5 observables": lambda: pipeline._gnm_cov_observables(gcov, True),
        "G whole chunk": lambda: sct.ensemble_gnm_fluctuations(
            c, params, inverse="blocked", device="cuda"),
    })
    if rigid.direct_prep_applies(params, n):
        row_sums = assembly_kernels.assembly_row_sums(c, params)
        diag = rigid._diagonal_of_row_sums(row_sums)
        stages.update({
            "D3a K7 row-sum pass (the Hessian diagonal)":
                lambda: assembly_kernels.assembly_row_sums(c, params),
            "D3b stitch inputs from the diagonal":
                lambda: rigid._stitch_inputs_from_diag(diag, bases, None),
            "D3c K7 store pass":
                lambda: assembly_kernels.assembly_stitch(c, params, scale_h,
                                                         ts, mp, row_sums),
            "D whole chunk, prep=direct": lambda: run(c, params,
                                                      prep="direct"),
            "D whole chunk, prep=planes (again)": lambda: run(c, params),
        })
    for name, fn in stages.items():
        print(f"stage {label}{name}: {cs.cuda_ms(fn, reps=reps):.4f} ms",
              flush=True)


def run(x, params, chunk=cs.CHUNK, **kwargs):
    kwargs.setdefault("with_covariance", False)
    return sct.ensemble_anm_fluctuations(
        x, params, inverse="blocked", with_dcc=True, dtype=torch.float32,
        chunk=chunk, device="cuda", **kwargs)


def spectral_stage_times(dev, params, reps):
    """Stages of one chunk of ``ensemble_anm_spectral`` and of
    ``ensemble_anm_banded``, each timed over `reps` calls."""
    c = dev[:cs.CHUNK].contiguous()
    h = pipeline._build_hessians_batched(c, params, None)
    bases = rigid.rigid_modes_anm(c)
    cov = rigid.covariance_cholesky(h, bases, inverse="blocked")
    diags, v_all, t_all = spectrum.band_reduce_with_reflectors(h, 8)
    vals = spectrum.banded_eigenvalues(diags, cs.N_ITER_BISECT)
    feed, shifts, floor, _ = spectrum.eigvec_inputs(diags, vals)
    n = shifts.shape[-1]

    def inverse_iteration():
        return torch.cat([spectrum.banded_eigvec(
            feed, shifts[:, c0:c0 + 256].contiguous(), c0, floor, 2, 1.0)
            for c0 in range(0, n, 256)], -1)

    x = inverse_iteration()
    u_band = spectrum._windowed_mgs(x, 8)
    u = spectrum.back_transform(v_all, t_all, u_band)
    min_gap = 0.01 * (vals[:, -1] - vals[:, 0])
    polished = spectrum._perturbative_polish(h, u, vals, min_gap)
    stages = {
        "S1 K5 hessian_xyz": lambda: pipeline._build_hessians_batched(
            c, params, None),
        "S2 covariance (rigid bases, blocked Cholesky with K3)":
            lambda: rigid.covariance_cholesky(
                h, rigid.rigid_modes_anm(c), inverse="blocked"),
        "S3 band reduction": lambda: spectrum.band_reduce(h, 8),
        f"S4 K10 banded_bisect ({cs.N_ITER_BISECT} halvings)":
            lambda: spectrum.banded_eigenvalues(diags, cs.N_ITER_BISECT),
        f"S5 modes_from_covariance (k {cs.N_MODES}, 16 iterations)":
            lambda: modes.modes_from_covariance(cov, h, bases, k=cs.N_MODES),
        "S whole chunk": lambda: sct.ensemble_anm_spectral(
            c, params, n_modes=cs.N_MODES, n_iter_bisect=cs.N_ITER_BISECT,
            device="cuda"),
        "B1 band reduction with reflectors":
            lambda: spectrum.band_reduce_with_reflectors(h, 8),
        "B2 K10 banded_bisect (40 halvings)":
            lambda: spectrum.banded_eigenvalues(diags, 40),
        "B3 K11 banded_eigvec (shift chunks of 256)": inverse_iteration,
        "B4 windowed Gram-Schmidt": lambda: spectrum._windowed_mgs(x, 8),
        "B5 back-transform": lambda: spectrum.back_transform(v_all, t_all,
                                                             u_band),
        "B6 one perturbative polish":
            lambda: spectrum._perturbative_polish(h, u, vals, min_gap),
        "B7 window refinement (QR, projection, eigh)":
            lambda: spectrum._window_refine(h, polished, vals, 32),
        "B whole chunk": lambda: sct.ensemble_anm_banded(
            c, params, with_dcc=True, device="cuda"),
    }
    for name, fn in stages.items():
        print(f"stage {name}: {cs.cuda_ms(fn, reps=reps):.4f} ms",
              flush=True)


def profiled_call(label, fn, out):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    trace_path = os.path.join(out, f"trace_{label}.json")
    prof.export_chrome_trace(trace_path)
    with open(os.path.join(out, f"profile_table_{label}.txt"), "w") as fh:
        fh.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                           row_limit=60))
    busy_us, per_kernel = busy_intervals(trace_path)
    launches = sum(e.count for e in prof.key_averages()
                   if e.key == "cudaLaunchKernel")
    print(f"profiled {label}: wall {wall_ms:.2f} ms, kernels busy "
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
    parser.add_argument("--reps-spectral", type=int, default=3,
                        help="calls per stage timing of the spectral paths")
    parser.add_argument("--skip-spectral", action="store_true",
                        help="leave out the spectral stages and trace")
    parser.add_argument("--skip-tabulated", action="store_true",
                        help="leave out the sdENM chunk")
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
    if not args.skip_tabulated:
        sd_enm = sct.TabulatedForceField.sd_enm(
            cs.make_ca_atoms(cs.N_RES)).to_compact_params()
        stage_times(dev, sd_enm, args.reps, label="sdENM ")
    if not args.skip_spectral:
        spectral_stage_times(dev, params, args.reps_spectral)
    profiled_call("main_path", lambda: run(dev, params), args.out)
    if not args.skip_spectral:
        chunk = dev[:cs.CHUNK].contiguous()
        profiled_call("anm_spectral_chunk",
                      lambda: sct.ensemble_anm_spectral(
                          chunk, params, n_modes=cs.N_MODES,
                          n_iter_bisect=cs.N_ITER_BISECT, device="cuda"),
                      args.out)
    chunk_sweep(dev, params)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
