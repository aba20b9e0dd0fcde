"""
Smoke run of the PyTorch/CUDA port (``springcraft_tpu_torch``) on one
NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, one line of output each:

1. the card's name and power limit, as ``nvidia-smi`` prints them;
2. the build of every CUDA kernel from ``springcraft_tpu_torch/csrc``
   (into ``build/kernels/``), with the compiler's register and spill
   report;
3. each kernel of the main path against its plain PyTorch version on
   the same CUDA tensors, at the main path's shapes, timed with CUDA
   events;
4. the main path itself, ``ensemble_anm_fluctuations`` over 1024
   conformers of 300 residues in chunks of 128 (invariant force field,
   13 A cutoff), with every kernel's launch count, finiteness checks and
   the first chunk held against the port's float64 ``cho_solve`` engine.

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
CUTOFF = 13.0
SEED = 3
TIMING_REPS = 20

#: Kernel name -> (source, the TPU kernel it replaces, tolerance of
#: max|kernel - plain| / max|plain| at the main path's shapes).
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
}
#: Main-path outputs against the float64 reference: max|x - ref| /
#: max|ref|, the bound the JAX package holds its float32 Pallas path to.
SLICE_TOL = 1e-4


def check(cond, message):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {message}")


def make_conformers(n_conf, n_res, seed):
    """Conformer ensemble of the repository's headline benchmark: one
    random 300-residue blob at protein density, jittered by 0.05 A."""
    import numpy as np

    rng = np.random.RandomState(seed)
    base = (rng.rand(n_res, 3) * 34.0).astype(np.float32)
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
    from springcraft_tpu_torch import _build

    t0 = time.perf_counter()
    _build.load()
    seconds = time.perf_counter() - t0
    report = [line.strip() for line in (_build.build_log() or "").splitlines()
              if "registers" in line or "spill" in line]
    print(f"build: {_build.library_path().name} in {seconds:.1f} s; "
          + " | ".join(report), flush=True)


def kernel_parity(coords, params):
    """Each kernel against its plain version at the main path's shapes;
    returns ``{name: (max_abs_err, ms, plain_ms)}``."""
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
        results[name] = (err, ms, plain_ms)
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

    # the first leaf of the recursion: an equilibrated SPD 64-panel
    panels = reg[:, :spd_linalg.LEAF, :spd_linalg.LEAF].contiguous()
    record("panel_inverse",
           lambda: spd_linalg.panel_inverse_batched(panels),
           lambda: spd_linalg.panel_inverse_plain(panels))
    return results


def main_path(conformers, params, card):
    """Drive the main path once from a zero launch count; returns the
    launch counts."""
    import torch

    import springcraft_tpu_torch as sct

    def run(coords, **kwargs):
        return sct.ensemble_anm_fluctuations(
            coords, params, inverse="blocked", with_covariance=False,
            with_dcc=True, dtype=torch.float32, chunk=CHUNK, device="cuda",
            **kwargs)

    run(conformers[:CHUNK])                   # cuBLAS/cuSOLVER set-up
    wrappers = sct.kernel_wrappers()
    for wrapper in wrappers.values():
        wrapper.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run(conformers)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    print(f"main path launches: {json.dumps(launches)}", flush=True)
    for name, count in launches.items():
        check(count > 0, f"main path never launched kernel {name}")

    n_conf, n = conformers.shape[:2]
    shapes = {"msf": (n_conf, n), "bfactor": (n_conf, n),
              "dcc": (n_conf, n, n)}
    check(set(out) == set(shapes), f"outputs {sorted(out)}")
    for key, shape in shapes.items():
        check(tuple(out[key].shape) == shape, f"{key} shape")
        check(out[key].device.type == "cuda", f"{key} device")
        check(bool(torch.isfinite(out[key]).all()), f"{key} not finite")

    ref = sct.ensemble_anm_fluctuations(
        conformers[:CHUNK].astype("float64"), params, inverse="cho_solve",
        with_dcc=True, dtype=torch.float64, device="cuda")
    errs = {}
    for key in shapes:
        _, errs[key] = max_errors(out[key][:CHUNK], ref[key])
        check(errs[key] <= SLICE_TOL,
              f"{key}: max rel err {errs[key]:.3e} vs float64 cho_solve")

    repeats = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(conformers)
        torch.cuda.synchronize()
        repeats.append(time.perf_counter() - t0)
    rates = [n_conf / s for s in [seconds] + repeats]
    print(f"main path vs float64 cho_solve (first chunk): "
          + ", ".join(f"{k} max rel err {v:.3e}" for k, v in errs.items())
          + f" (tol {SLICE_TOL:g})", flush=True)
    print(f"rate: {n_conf} conformers x N={n} in chunks of {CHUNK}: "
          + ", ".join(f"{r:.1f}" for r in rates)
          + f" solves/s (first run counted, then 3 repeats) on [{card}]",
          flush=True)
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
    chunk = torch.as_tensor(conformers[:CHUNK], device="cuda")
    parity = kernel_parity(chunk, params)
    launches = main_path(conformers, params, card)

    kernels = []
    for name, (source, replaces, _) in KERNELS.items():
        err, ms, plain_ms = parity[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
