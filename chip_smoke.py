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
   tensors, at the shapes its paths give it, timed with CUDA events (the
   two banded kernels on the band of the first chunk's Hessians, the
   bisection also on the single structure's band, their slow plain
   versions timed over one call);
4. the paths, each driven once from zero launch counts and required to
   have launched its own kernels (``PATH_KERNELS``), with finiteness
   checks and a float32 result held against the port's float64 engines
   on the card:

   * ``ensemble_anm_fluctuations`` plane traces (the main path) and
     with the covariance and PRS, over 1024 conformers of 300 residues
     in chunks of 128 (invariant force field, 13 A cutoff), first chunk
     against float64 ``cho_solve``;
   * ``ensemble_gnm_fluctuations`` at the same size;
   * ``anm_fluctuations`` (with PRS) and ``gnm_fluctuations`` on one
     structure of 1776 residues (the CA count of the repository's 7cal
     test structure) at protein density;
   * the spectral pipelines on the same conformers:
     ``ensemble_anm_spectral`` and ``ensemble_gnm_spectral`` (20 modes,
     32 halvings, as the JAX package's benchmark), ``ensemble_anm_banded``
     and ``ensemble_gnm_banded``, and ``anm_spectral`` / ``gnm_spectral``
     on the 1776-residue structure; eigenvalues against float64
     ``torch.linalg.eigh`` (``ensemble_anm``), covariance observables
     against float64 ``cho_solve``, eigenvectors and mode shapes through
     their residuals and orthonormality.

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
    "banded_bisect": (
        "springcraft_tpu_torch/csrc/banded_bisect.cu",
        "springcraft_tpu/ops/spectrum.py:1132", 1e-5),
    # eigenvectors are free up to sign: held by residuals and overlaps
    # (EIGVEC_*), the tolerance here bounds the sign-aligned difference
    # on well-separated eigenvalues
    "banded_eigvec": (
        "springcraft_tpu_torch/csrc/banded_eigvec.cu",
        "springcraft_tpu/ops/spectrum.py:770", 1e-4),
}
#: Path -> the kernels it must launch.
PATH_KERNELS = {
    "anm_traces": ("hessian_planes", "regularize_stitch", "panel_inverse"),
    "anm_covariance": ("hessian_planes", "regularize_stitch",
                       "panel_inverse"),
    "gnm_ensemble": ("kirchhoff", "panel_inverse"),
    "anm_single": ("hessian_xyz",),
    "gnm_single": ("kirchhoff",),
    "anm_spectral_ensemble": ("hessian_xyz", "panel_inverse",
                              "banded_bisect"),
    "anm_banded_ensemble": ("hessian_xyz", "banded_bisect",
                            "banded_eigvec"),
    "gnm_spectral_ensemble": ("kirchhoff", "panel_inverse",
                              "banded_bisect"),
    "gnm_banded_ensemble": ("kirchhoff", "banded_bisect", "banded_eigvec"),
    "anm_spectral_single": ("hessian_xyz", "banded_bisect"),
    "gnm_spectral_single": ("kirchhoff", "banded_bisect"),
}
#: Spectral settings of the JAX package's benchmark (bench.py:328-331).
N_MODES = 20
N_ITER_BISECT = 32
#: Subspace iterations of the GNM mode shapes.  The benchmark has no GNM
#: spectral setting, and the default 16 leaves the 20th Kirchhoff mode at
#: N=300 with a residual of 1.9e-3 ||K|| even in float64 (its lowest
#: spectrum is flatter than the Hessian's); 32 reach 3e-5.
GNM_ITER_MODES = 32
#: Path outputs against the float64 reference: max|x - ref| / max|ref|,
#: the bound the JAX package holds its float32 Pallas path to.
SLICE_TOL = 1e-4
#: The single structure's covariance and PRS outputs: a float32 Cholesky
#: of a 5328-dimensional matrix, held to 1e-3 (MSF, B-factors and DCC
#: keep SLICE_TOL, against the ~1e-5 of the repository's 7cal check).
SINGLE_COV_TOL = 1e-3
#: Eigenvectors and mode shapes: ||H u - lambda u|| / ||H||_2 and
#: max |U U^T - I|, the JAX package's own float32 bounds
#: (tests/test_ops.py:561-574).
RESIDUAL_TOL = 5e-4
ORTHO_TOL = 1e-3
#: K11 against its plain version: median band-space residual over ||B||
#: (tests/test_ops.py:577-604), the kernel's largest residual (every
#: column of both routes measured below 1e-4 ||B|| on the H100), and
#: |u_kernel . u_plain| on every eigenvalue whose gaps to both neighbours
#: exceed EIGVEC_GAP of the spectrum's span: inside a cluster any two
#: roundings may return different vectors.
EIGVEC_RESIDUAL_TOL = 1e-3
EIGVEC_MAX_RESIDUAL = 1e-4
EIGVEC_OVERLAP_TOL = 1e-3
EIGVEC_GAP = 1e-3


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


def timed_once(fn):
    """``(fn(), device ms)`` of one call, from CUDA events: for the plain
    versions whose Python loops take seconds."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


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
    # ptxas -v: per kernel, its name, then its spills, then its registers;
    # a template's window width W follows its name
    report, name, spills = [], "?", ""
    for line in (_build.build_log() or "").splitlines():
        found = re.search(r"entry function .*?([a-z_]+_kernel)(ILi(\d+)E)?",
                          line)
        if found:
            name = found.group(1) + (f"<{found.group(3)}>"
                                     if found.group(3) else "")
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
    banded_parity(coords, single, params, results)
    return results


def bisect_parity(diags, n_iter, results):
    """K10 against its plain version on band diagonals `diags` ``(B, w,
    n)``, the plain version (a Python loop over the band) timed over one
    call; returns the kernel's eigenvalues and ``(lo, hi)``."""
    import torch

    from springcraft_tpu_torch.ops import spectrum

    batch, w, n = diags.shape
    feed, lo, hi = spectrum.bisect_inputs(diags)

    def bisect():
        return spectrum.banded_bisect(feed, lo, hi, n_iter)

    vals = bisect()
    ref, plain_ms = timed_once(
        lambda: spectrum.banded_bisect_plain(feed, lo, hi, n_iter))
    check(bool(torch.isfinite(vals).all()), "banded_bisect: non-finite")
    err, rel = max_errors(vals, ref)
    tol = KERNELS["banded_bisect"][2]
    check(rel <= tol, f"banded_bisect {(batch, w, n)}: max rel err "
          f"{rel:.3e} > {tol:g}")
    ms = cuda_ms(bisect, reps=5)
    print(f"parity banded_bisect {(batch, w, n)} (feed "
          f"{4 * w * (n + w) / 1024:.1f} KB), {n_iter} halvings: max abs err "
          f"{err:.3e}, max rel err {rel:.3e} (tol {tol:g}); kernel {ms:.4f} "
          f"ms (5 calls), plain {plain_ms:.4f} ms (1 call)", flush=True)
    results.setdefault("banded_bisect", []).append(
        ((batch, w, n), err, ms, plain_ms))
    return vals, lo, hi


def banded_parity(coords, single, params, results):
    """K10 and K11 against their plain versions on the band of the chunk's
    Hessians ``(128, 9, 900)``, K10 also on the single structure's
    ``(1, 9, 5328)``, whose 188 KB feed takes the kernel's opt-in
    shared-memory branch; the plain versions, Python loops over the band,
    are timed over one call each."""
    import torch

    from springcraft_tpu_torch.ops import assembly_kernels, spectrum

    diags = spectrum.band_reduce(
        assembly_kernels.hessian_xyz_ensemble(coords, params), 8)
    batch, n = diags.shape[0], diags.shape[-1]
    vals, lo, hi = bisect_parity(diags, N_ITER_BISECT, results)
    # the single structure's path runs the default 40 halvings
    bisect_parity(spectrum.band_reduce(
        assembly_kernels.hessian_xyz_ensemble(single, params), 8), 40,
        results)

    feed, shifts, floor, _ = spectrum.eigvec_inputs(diags, vals)

    def eigvec(fn):
        # the path's chunks of 256 shifts
        return torch.cat([fn(feed, shifts[:, c:c + 256].contiguous(), c,
                             floor, 2, 1.0) for c in range(0, n, 256)], -1)

    x = eigvec(spectrum.banded_eigvec)
    x_plain, plain_ms = timed_once(
        lambda: eigvec(spectrum.banded_eigvec_plain))
    check(bool(torch.isfinite(x).all()), "banded_eigvec: non-finite")
    band = torch.zeros((batch, n, n), device=diags.device)
    for d in range(diags.shape[1]):
        idx = torch.arange(n - d, device=diags.device)
        band[:, idx, idx + d] = diags[:, d, :n - d]
        band[:, idx + d, idx] = diags[:, d, :n - d]
    norm = vals.abs().amax(dim=1)[:, None]
    medians, largest = {}, {}
    for label, u in (("kernel", x), ("plain", x_plain)):
        res = torch.linalg.vector_norm(band @ u - u * vals[:, None, :],
                                       dim=1) / norm
        medians[label], largest[label] = float(res.median()), float(res.max())
        check(medians[label] <= EIGVEC_RESIDUAL_TOL,
              f"banded_eigvec {label}: median residual "
              f"{medians[label]:.3e} > {EIGVEC_RESIDUAL_TOL:g} ||B||")
    check(largest["kernel"] <= EIGVEC_MAX_RESIDUAL,
          f"banded_eigvec: largest residual {largest['kernel']:.3e} > "
          f"{EIGVEC_MAX_RESIDUAL:g} ||B|| (plain {largest['plain']:.3e})")
    gaps = torch.diff(vals, dim=1)
    big = float("inf") * torch.ones_like(vals[:, :1])
    gap = torch.minimum(torch.cat([big, gaps], 1), torch.cat([gaps, big], 1))
    apart = gap > EIGVEC_GAP * (hi - lo)[:, None]
    overlap = (x * x_plain).sum(dim=1).abs()[apart]
    sign = torch.sign((x * x_plain).sum(dim=1, keepdim=True))
    diff = (x - sign * x_plain).abs().amax(dim=1)[apart]
    worst, err = float(1 - overlap.min()), float(diff.max())
    tol = KERNELS["banded_eigvec"][2]
    check(worst <= EIGVEC_OVERLAP_TOL and err <= tol,
          f"banded_eigvec: 1 - |overlap| {worst:.3e}, sign-aligned max "
          f"abs err {err:.3e} on separated eigenvalues")
    ms = cuda_ms(lambda: eigvec(spectrum.banded_eigvec), reps=5)
    print(f"parity banded_eigvec {tuple(x.shape)}, w 9, 2 solves, chunks of "
          f"256 shifts: median residual kernel {medians['kernel']:.3e}, "
          f"plain {medians['plain']:.3e} ||B|| (tol "
          f"{EIGVEC_RESIDUAL_TOL:g}), largest kernel "
          f"{largest['kernel']:.3e}, plain {largest['plain']:.3e} ||B|| "
          f"(tol {EIGVEC_MAX_RESIDUAL:g}); on {int(apart.sum())} of "
          f"{apart.numel()} separated eigenvalues 1 - |u_k . u_p| <= "
          f"{worst:.3e} (tol {EIGVEC_OVERLAP_TOL:g}), sign-aligned max abs "
          f"err {err:.3e} (tol {tol:g}); kernel {ms:.4f} ms (5 calls, 4 "
          f"launches each), plain {plain_ms:.4f} ms (1 call)", flush=True)
    results["banded_eigvec"] = [((batch, n, n), err, ms, plain_ms)]


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


def float64_references(model, coords, params):
    """Float64 references of `coords` ``(B, n, 3)`` on the card: the dense
    ``torch.linalg.eigh`` route merged with the ``cho_solve`` covariance
    observables (which replace its MSF, B-factors and DCC), and the
    matrices themselves."""
    import torch

    import springcraft_tpu_torch as sct
    from springcraft_tpu_torch.parallel import pipeline

    x = torch.as_tensor(coords, dtype=torch.float64, device="cuda")
    if model == "anm":
        eig = sct.ensemble_anm(x, params, with_dcc=True, dtype=x.dtype)
        cov = sct.ensemble_anm_fluctuations(x, params, inverse="cho_solve",
                                            dtype=x.dtype)
        matrices = pipeline._build_hessians_batched(x, params, None)
    else:
        eig = sct.ensemble_gnm(x, params, with_dcc=True, dtype=x.dtype)
        cov = sct.ensemble_gnm_fluctuations(x, params, inverse="cho_solve",
                                            dtype=x.dtype)
        matrices = pipeline._build_kirchhoffs_batched(x, params, None)
    return {**eig, **cov}, matrices


def eigen_errors(vals, vecs, matrices, norm):
    """Largest ``||M u - lambda u|| / ||M||_2`` over the rows `vecs` ``(B,
    k, m)`` and largest ``|U U^T - I|``, in float64."""
    import torch

    u = vecs.double().transpose(-1, -2)
    res = torch.linalg.vector_norm(
        matrices @ u - u * vals.double()[..., None, :], dim=-2) / norm
    eye = torch.eye(u.shape[-1], dtype=u.dtype, device=u.device)
    return float(res.max()), float((vecs.double() @ u - eye).abs().max())


def check_spectral(label, out, ref, matrices, n_trivial, tols):
    """Every output of a spectral path against the float64 references:
    values within their tolerance of max|ref| (frequencies past the
    `n_trivial` null modes, whose frequencies are square roots of
    rounding noise; ``mode_values`` against the lowest non-trivial
    eigenvalues), eigenvectors and mode shapes by their residuals and
    orthonormality."""
    scale = ref["eig_values"].abs().amax(dim=-1)
    errs = {}
    for key, value in out.items():
        if key.endswith("_vectors"):
            continue
        if key == "mode_values":
            lowest = ref["eig_values"][..., n_trivial:n_trivial
                                       + value.shape[-1]]
            errs[key] = max_errors(value, lowest)[0] / float(scale.max())
        elif key == "frequencies":
            errs[key] = max_errors(value[..., n_trivial:],
                                   ref[key][..., n_trivial:])[1]
        else:
            errs[key] = max_errors(value, ref[key])[1]
        tol = tols.get(key, SLICE_TOL)
        check(errs[key] <= tol, f"{label} {key}: max rel err "
              f"{errs[key]:.3e} > {tol:g} vs float64")
    line = ", ".join(f"{key} {err:.3e}" for key, err in errs.items())
    for vals, vecs in (("eig_values", "eig_vectors"),
                       ("mode_values", "mode_vectors")):
        if vecs in out:
            res, orth = eigen_errors(out[vals], out[vecs], matrices,
                                     scale[:, None])
            check(res <= RESIDUAL_TOL and orth <= ORTHO_TOL,
                  f"{label} {vecs}: residual {res:.3e} (tol "
                  f"{RESIDUAL_TOL:g} ||M||), orthonormality {orth:.3e} (tol "
                  f"{ORTHO_TOL:g})")
            line += (f"; {vecs} residual {res:.3e} ||M|| (tol "
                     f"{RESIDUAL_TOL:g}), orthonormality {orth:.3e} (tol "
                     f"{ORTHO_TOL:g})")
    print(f"{label} vs float64 (max rel err, tol {SLICE_TOL:g} unless "
          f"stated): {line}", flush=True)


def spectral_ensemble_path(path, run, conformers, shapes, refs, n_trivial,
                           card, repeats):
    """Drive a spectral ensemble path over `conformers` in chunks, hold
    its first chunk against the float64 references `refs` and print its
    rate; returns the launches."""
    out, seconds, launches = drive(path, lambda: run(conformers))
    check_outputs(path, out, shapes)
    check_spectral(f"{path} (first chunk)",
                   {key: value[:CHUNK] for key, value in out.items()},
                   *refs, n_trivial, {})
    del out
    rates = [len(conformers) / s for s in
             [seconds] + [timed(lambda: run(conformers))
                          for _ in range(repeats)]]
    print(f"{path} rate: {len(conformers)} conformers x N="
          f"{conformers.shape[1]} in chunks of {CHUNK}: "
          + ", ".join(f"{r:.1f}" for r in rates)
          + f" solves/s (first run counted, then {repeats} repeats) on "
          f"[{card}]", flush=True)
    return launches


def spectral_single_path(path, run, coord, shapes, model, params,
                         n_trivial, tols, card):
    """Drive a single-structure spectral path in float32, hold it against
    the float64 references and print the time per structure."""
    out, seconds, launches = drive(path, lambda: run(coord))
    check_outputs(path, out, shapes)
    check_spectral(path, {key: value[None] for key, value in out.items()},
                   *float64_references(model, coord[None], params),
                   n_trivial, tols)
    del out
    again = timed(lambda: run(coord))
    print(f"{path}: N={coord.shape[0]} float32, {seconds * 1e3:.1f} ms "
          f"per structure (first call), {again * 1e3:.1f} ms (second) on "
          f"[{card}]", flush=True)
    return launches


def spectral_paths(conformers, single, params, card):
    """Drive the six spectral paths; returns ``{path: launches}``."""
    import springcraft_tpu_torch as sct

    n_conf, n = conformers.shape[:2]
    m = 3 * n
    covariance = {"msf": (n_conf, n), "bfactor": (n_conf, n),
                  "dcc": (n_conf, n, n)}
    modes = {"mode_values": (n_conf, N_MODES)}
    spectral = dict(n_modes=N_MODES, n_iter_bisect=N_ITER_BISECT,
                    chunk=CHUNK, device="cuda")
    banded = dict(with_dcc=True, chunk=CHUNK, device="cuda")
    launches = {}
    for model, dim, n_trivial, options in (
            ("anm", m, 6, {}), ("gnm", n, 1,
                                {"n_iter_modes": GNM_ITER_MODES})):
        refs = float64_references(model, conformers[:CHUNK], params)
        eigen = {"eig_values": (n_conf, dim), "frequencies": (n_conf, dim)}
        launches[f"{model}_spectral_ensemble"] = spectral_ensemble_path(
            f"{model}_spectral_ensemble",
            lambda c, fn=getattr(sct, f"ensemble_{model}_spectral"),
            options=options: fn(c, params, **spectral, **options),
            conformers, {**covariance, **eigen, **modes,
                         "covariance": (n_conf, dim, dim),
                         "mode_vectors": (n_conf, N_MODES, dim)},
            refs, n_trivial, card, repeats=2)
        launches[f"{model}_banded_ensemble"] = spectral_ensemble_path(
            f"{model}_banded_ensemble",
            lambda c, fn=getattr(sct, f"ensemble_{model}_banded"):
                fn(c, params, **banded),
            conformers, {**covariance, **eigen,
                         "eig_vectors": (n_conf, dim, dim)},
            refs, n_trivial, card, repeats=1)
        del refs

    n1 = single.shape[0]
    one = {"msf": (n1,), "bfactor": (n1,), "dcc": (n1, n1)}
    launches["anm_spectral_single"] = spectral_single_path(
        "anm_spectral_single",
        lambda c: sct.anm_spectral(c, params, n_modes=N_MODES,
                                   device="cuda"),
        single, {**one, "covariance": (3 * n1, 3 * n1),
                 "eig_values": (3 * n1,), "frequencies": (3 * n1,),
                 "mode_values": (N_MODES,), "mode_vectors": (N_MODES, 3 * n1)},
        "anm", params, 6, {"covariance": SINGLE_COV_TOL}, card)
    launches["gnm_spectral_single"] = spectral_single_path(
        "gnm_spectral_single",
        lambda c: sct.gnm_spectral(c, params, device="cuda"),
        single, {**one, "covariance": (n1, n1), "eig_values": (n1,),
                 "frequencies": (n1,)},
        "gnm", params, 1, {"covariance": SINGLE_COV_TOL}, card)
    return launches


def paths(conformers, single, params, card):
    """Drive every path once; returns ``{path: launches}``."""
    import torch

    import springcraft_tpu_torch as sct

    n_conf, n = conformers.shape[:2]
    traces = {"msf": (n_conf, n), "bfactor": (n_conf, n),
              "dcc": (n_conf, n, n)}

    def anm(coords, **kwargs):
        kwargs.setdefault("with_covariance", False)
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
    launches.update(spectral_paths(conformers, single, params, card))
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
