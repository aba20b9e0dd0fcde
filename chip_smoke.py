"""
Smoke run of the PyTorch/CUDA port (``springcraft_tpu_torch``) on one
NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases:

1. the card's name and power limit, as ``nvidia-smi`` prints them;
2. the build of every CUDA kernel from ``springcraft_tpu_torch/csrc``
   (into ``build/kernels/``, one ``nvcc`` per source, all at once), with
   the compiler's register and spill report;
3. each kernel against its plain PyTorch version on the same CUDA
   tensors, at the shapes its paths give it, timed with CUDA events;
4. the paths, each driven once from zero launch counts and required to
   have launched its own kernels (``PATH_KERNELS``), with finiteness
   checks and a float32 result held against the port's float64
   ``cho_solve`` engine on the card:

   * ``ensemble_anm_fluctuations`` plane traces (the main path) and
     with the covariance and PRS, over 1024 conformers of 300 residues
     in chunks of 128 (invariant force field, 13 A cutoff), first chunk
     against float64;
   * ``ensemble_gnm_fluctuations`` at the same size;
   * ``anm_fluctuations`` (with PRS) and ``gnm_fluctuations`` on one
     structure of 1776 residues (the CA count of the repository's 7cal
     test structure) at protein density.

Then one JSON line with the kernels' numbers, and last
``{"ok": true, "device": {...}}``.  Any failed check ends the run with
a traceback and a non-zero exit; without a CUDA device it stops before
building anything.
"""

import json
import os
import subprocess
import sys
import time

N_CONFORMERS = 1024
N_RES = 300
CHUNK = 128
N_SINGLE = 1776
CUTOFF = 13.0
SEED = 3
TIMING_REPS = 20

#: Kernel name -> (source, the TPU kernel(s) it replaces, tolerance of
#: max|kernel - plain| / max|plain| at its paths' shapes).
KERNELS = {
    "hessian_planes": (
        "springcraft_tpu_torch/csrc/hessian_planes.cu",
        "springcraft_tpu/ops/pallas_kernels.py:688", 1e-5),
    "regularize_stitch": (
        "springcraft_tpu_torch/csrc/regularize_stitch.cu",
        "springcraft_tpu/ops/pallas_kernels.py:1093", 1e-5),
    "panel_inverse": (
        "springcraft_tpu_torch/csrc/panel_inverse.cu",
        "springcraft_tpu/ops/pallas_linalg.py:142", 1e-4),
    "kirchhoff": (
        "springcraft_tpu_torch/csrc/kirchhoff.cu",
        "springcraft_tpu/ops/pallas_kernels.py:766, "
        "springcraft_tpu/ops/pallas_kernels.py:413", 1e-5),
    "hessian_xyz": (
        "springcraft_tpu_torch/csrc/hessian_planes.cu",
        "springcraft_tpu/ops/pallas_kernels.py:191", 1e-5),
}
#: Path -> the kernels it must launch.
PATH_KERNELS = {
    "anm_traces": ("hessian_planes", "regularize_stitch", "panel_inverse"),
    "anm_covariance": ("hessian_planes", "regularize_stitch",
                       "panel_inverse"),
    "gnm_ensemble": ("kirchhoff", "panel_inverse"),
    "anm_single": ("hessian_xyz",),
    "gnm_single": ("kirchhoff",),
}
#: Path outputs against the float64 reference: max|x - ref| / max|ref|,
#: the bound the JAX package holds its float32 Pallas path to.
SLICE_TOL = 1e-4
#: The single structure's covariance and PRS outputs: a float32 Cholesky
#: of a 5328-dimensional matrix, held to 1e-3 (MSF, B-factors and DCC
#: keep SLICE_TOL, against the ~1e-5 of the repository's 7cal check).
SINGLE_COV_TOL = 1e-3


def check(cond, message):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {message}")


def make_conformers(n_conf, n_res, seed):
    """Conformer ensemble of the repository's headline benchmark: one
    random blob at the density of 300 residues in a 34 A cube, jittered
    by 0.05 A."""
    import numpy as np

    rng = np.random.RandomState(seed)
    spread = 34.0 * (n_res / 300) ** (1 / 3)
    base = (rng.rand(n_res, 3) * spread).astype(np.float32)
    return base[None] + 0.05 * rng.randn(n_conf, n_res, 3).astype(
        np.float32)


def cuda_ms(fn, reps=TIMING_REPS):
    """Mean device time of `fn` in milliseconds over `reps` calls, after
    one warm-up call, from CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_errors(got, ref):
    diff = float((got.double() - ref.double()).abs().max())
    return diff, diff / float(ref.double().abs().max())


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def build_kernels():
    import re

    from springcraft_tpu_torch import _build

    t0 = time.perf_counter()
    _build.load()
    seconds = time.perf_counter() - t0
    # ptxas -v: per kernel, its name, then its spills, then its registers
    report, name, spills = [], "?", ""
    for line in (_build.build_log() or "").splitlines():
        found = re.search(r"entry function .*?([a-z_]+_kernel)", line)
        if found:
            name = found.group(1)
        elif "spill stores" in line:
            spills = line.strip()
        elif "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            report.append(f"{name} {regs.group(1) if regs else '?'} "
                          f"registers, {spills}")
    print(f"build: {_build.library_path().name} in {seconds:.1f} s; "
          + " | ".join(report), flush=True)


def kernel_parity(coords, single, params):
    """Each kernel against its plain version at its paths' shapes
    (`coords` a ``(128, 300)`` chunk, `single` a ``(1, 1776)``
    structure); returns ``{name: [(shape, max_abs_err, ms, plain_ms),
    ...]}``, the first shape being the one the JSON line reports."""
    import torch

    from springcraft_tpu_torch.ops import assembly, assembly_kernels, rigid
    from springcraft_tpu_torch.ops import spd_linalg

    results = {}

    def record(name, kernel_fn, plain_fn):
        got, ref = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        check(torch.isfinite(got).all(), f"{name}: non-finite output")
        err, rel = max_errors(got, ref)
        check(rel <= KERNELS[name][2],
              f"{name}: max rel err {rel:.3e} > {KERNELS[name][2]:g}")
        ms, plain_ms = cuda_ms(kernel_fn), cuda_ms(plain_fn)
        print(f"parity {name} {tuple(got.shape)}: max abs err {err:.3e}, "
              f"max rel err {rel:.3e} (tol {KERNELS[name][2]:g}); kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
        results.setdefault(name, []).append(
            (tuple(got.shape), err, ms, plain_ms))
        return ref

    planes = record(
        "hessian_planes",
        lambda: assembly_kernels.hessian_planes_ensemble(coords, params),
        lambda: assembly.hessian_planes_plain(coords, params))

    n = coords.shape[1]
    bases = rigid.rigid_modes_anm(coords)
    _, _, scale_h, ts = rigid.stitch_inputs(planes, bases)
    mp = spd_linalg.padded_size(3 * n)
    reg = record(
        "regularize_stitch",
        lambda: assembly_kernels.regularize_stitch(planes, scale_h, ts, mp),
        lambda: assembly_kernels.regularize_stitch_plain(planes, scale_h,
                                                         ts, mp))
    del planes

    # the first leaf of the recursion: an equilibrated SPD 64-panel
    panels = reg[:, :spd_linalg.LEAF, :spd_linalg.LEAF].contiguous()
    del reg
    record("panel_inverse",
           lambda: spd_linalg.panel_inverse_batched(panels),
           lambda: spd_linalg.panel_inverse_plain(panels))

    # the GNM ensemble's chunk, then the single structure
    for c in (coords, single):
        record("kirchhoff",
               lambda c=c: assembly_kernels.kirchhoff_ensemble(c, params),
               lambda c=c: assembly.kirchhoff_plain(c, params))
    # the single structure (its path), then an ensemble chunk
    for c in (single, coords):
        record("hessian_xyz",
               lambda c=c: assembly_kernels.hessian_xyz_ensemble(c, params),
               lambda c=c: assembly.hessian_xyz_plain(c, params))
    return results


def drive(path, fn):
    """Run `fn` once from zero launch counts and check that it launched
    every kernel of `path`; returns ``(out, seconds, launches)``."""
    import torch

    import springcraft_tpu_torch as sct

    wrappers = sct.kernel_wrappers()
    for wrapper in wrappers.values():
        wrapper.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    print(f"{path} launches: {json.dumps(launches)}", flush=True)
    for name in PATH_KERNELS[path]:
        check(launches[name] > 0, f"{path} never launched kernel {name}")
    return out, seconds, launches


def check_outputs(path, out, shapes):
    import torch

    check(set(out) == set(shapes), f"{path} outputs {sorted(out)}")
    for key, shape in shapes.items():
        check(tuple(out[key].shape) == shape, f"{path} {key} shape")
        check(out[key].device.type == "cuda", f"{path} {key} device")
        check(bool(torch.isfinite(out[key]).all()),
              f"{path} {key} not finite")


def compare(label, out, ref, tols):
    """Every output against the float64 reference, each within its
    tolerance (``tols``, else SLICE_TOL)."""
    errs = {}
    for key in ref:
        _, errs[key] = max_errors(out[key], ref[key])
        tol = tols.get(key, SLICE_TOL)
        check(errs[key] <= tol, f"{label} {key}: max rel err "
              f"{errs[key]:.3e} > {tol:g} vs float64 cho_solve")
    print(f"{label} vs float64 cho_solve: "
          + ", ".join(f"{key} max rel err {err:.3e} (tol "
                      f"{tols.get(key, SLICE_TOL):g})"
                      for key, err in errs.items()), flush=True)


def timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def ensemble_path(path, run, conformers, shapes, card, repeats):
    """Drive an ensemble path over all conformers in chunks (blocked
    engine, float32), hold its first chunk against the float64
    ``cho_solve`` engine and print its rate; returns the launches."""
    import torch

    def blocked():
        return run(conformers, inverse="blocked", dtype=torch.float32,
                   chunk=CHUNK)

    out, seconds, launches = drive(path, blocked)
    check_outputs(path, out, shapes)
    ref = run(conformers[:CHUNK].astype("float64"), inverse="cho_solve",
              dtype=torch.float64, chunk=None)
    compare(f"{path} (first chunk)",
            {key: value[:CHUNK] for key, value in out.items()}, ref, {})
    del out, ref
    rates = [len(conformers) / s
             for s in [seconds] + [timed(blocked) for _ in range(repeats)]]
    print(f"{path} rate: {len(conformers)} conformers x N="
          f"{conformers.shape[1]} in chunks of {CHUNK}: "
          + ", ".join(f"{r:.1f}" for r in rates)
          + f" solves/s (first run counted, then {repeats} repeats) on "
          f"[{card}]", flush=True)
    return launches


def single_path(path, run, coord, shapes, tols, card):
    """Drive a single-structure path in float32, hold it against its
    float64 engine and print the time per structure; returns the
    launches."""
    import torch

    def f32():
        return run(coord, dtype=torch.float32)

    out, seconds, launches = drive(path, f32)
    check_outputs(path, out, shapes)
    compare(path, out, run(coord.astype("float64"), dtype=torch.float64),
            tols)
    del out
    again = timed(f32)
    print(f"{path}: N={coord.shape[0]} float32, {seconds * 1e3:.1f} ms "
          f"per structure (first call), {again * 1e3:.1f} ms (second) on "
          f"[{card}]", flush=True)
    return launches


def paths(conformers, single, params, card):
    """Drive every path once; returns ``{path: launches}``."""
    import torch

    import springcraft_tpu_torch as sct

    n_conf, n = conformers.shape[:2]
    traces = {"msf": (n_conf, n), "bfactor": (n_conf, n),
              "dcc": (n_conf, n, n)}

    def anm(coords, **kwargs):
        return sct.ensemble_anm_fluctuations(coords, params, device="cuda",
                                             **kwargs)

    def gnm(coords, **kwargs):
        return sct.ensemble_gnm_fluctuations(coords, params, device="cuda",
                                             **kwargs)

    def anm_covariance(coords, **kwargs):
        return anm(coords, with_covariance=True, with_prs=True, **kwargs)

    # cuBLAS/cuSOLVER set-up before the first timed run
    anm(conformers[:CHUNK], inverse="blocked", chunk=CHUNK)
    launches = {"anm_traces": ensemble_path("anm_traces", anm, conformers,
                                            traces, card, repeats=3)}
    launches["anm_covariance"] = ensemble_path(
        "anm_covariance", anm_covariance, conformers,
        {**traces, "covariance": (n_conf, 3 * n, 3 * n),
         "prs": (n_conf, n, n), "effector": (n_conf, n),
         "sensor": (n_conf, n)}, card, repeats=2)
    launches["gnm_ensemble"] = ensemble_path(
        "gnm_ensemble", gnm, conformers,
        {**traces, "covariance": (n_conf, n, n)}, card, repeats=2)

    m = single.shape[0]
    single_traces = {"msf": (m,), "bfactor": (m,), "dcc": (m, m)}
    cov_tols = dict.fromkeys(("covariance", "prs", "effector", "sensor"),
                             SINGLE_COV_TOL)
    launches["anm_single"] = single_path(
        "anm_single",
        lambda c, **kw: sct.anm_fluctuations(c, params, with_prs=True,
                                             device="cuda", **kw),
        single, {**single_traces, "covariance": (3 * m, 3 * m),
                 "prs": (m, m), "effector": (m,), "sensor": (m,)},
        cov_tols, card)
    launches["gnm_single"] = single_path(
        "gnm_single",
        lambda c, **kw: sct.gnm_fluctuations(c, params, device="cuda",
                                             **kw),
        single, {**single_traces, "covariance": (m, m)}, cov_tols, card)
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import springcraft_tpu_torch as sct

    card = card_line()
    print(card, flush=True)
    build_kernels()

    params = sct.invariant_params(CUTOFF)
    conformers = make_conformers(N_CONFORMERS, N_RES, SEED)
    single = make_conformers(1, N_SINGLE, SEED)[0]
    parity = kernel_parity(
        torch.as_tensor(conformers[:CHUNK], device="cuda"),
        torch.as_tensor(single[None], device="cuda"), params)
    launches = paths(conformers, single, params, card)

    kernels = []
    for name, (source, replaces, _) in KERNELS.items():
        shapes = parity[name]
        _, _, ms, plain_ms = shapes[0]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces,
                 "launches": sum(count[name] for count in launches.values()),
                 "max_abs_err": max(err for _, err, _, _ in shapes),
                 "ms": ms, "plain_ms": plain_ms}
        if len(shapes) > 1:
            entry["shapes"] = [
                {"shape": list(shape), "max_abs_err": err, "ms": t,
                 "plain_ms": plain_t}
                for shape, err, t, plain_t in shapes]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
