"""
Times of the banded eigensolver kernels K10 (``banded_bisect``) and K11
(``banded_eigvec``) of one checkout at the shapes of its paths, and of the
four ensemble spectral and banded paths, to compare two checkouts on one
card.

K10 on the bands of ``chip_smoke.py``'s first chunk (128 conformers of 300
residues, invariant 13 A): the ANM band (128, 9, 900) and the GNM band
(128, 9, 300) at 32 halvings (the spectral paths) and 40 (the banded
paths), and the single structure's bands (1, 9, 5328) and (1, 9, 1776) at
40; K11 at (128, 900) per call of four launches of 256 shifts (the path's
``shift_chunk``) and per launch, and at (128, 300) per call of two; CUDA
events over `--reps` calls after one warm-up.  Then
``ensemble_{anm,gnm}_{spectral,banded}`` over `--conformers` conformers
with ``chip_smoke.py``'s settings, host clock to a synchronize, `--repeats`
calls each after one warm-up.  The package and ``chip_smoke.py`` are
imported from `--root`, so a second checkout (``git archive``) times the
same work with its own kernels; run them in turns (parent, this, this,
parent) in one command on one card.

Usage:  python3 tools/banded_ab.py --root PATH [--reps 5] [--conformers 128]
        [--repeats 2]
"""

import argparse
import os
import sys
import time


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=os.path.join(
        os.path.dirname(os.path.realpath(__file__)), ".."))
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--conformers", type=int, default=128)
    parser.add_argument("--repeats", type=int, default=2)
    args = parser.parse_args()
    root = os.path.realpath(args.root)
    sys.path.insert(0, root)

    import torch

    import chip_smoke as cs
    import springcraft_tpu_torch as sct
    from springcraft_tpu_torch.ops import assembly_kernels, spectrum

    cs.check(torch.cuda.is_available(), "needs a CUDA device")
    cs.check(os.path.dirname(os.path.realpath(sct.__file__)).startswith(
        root), f"springcraft_tpu_torch not imported from {root}")
    print(f"{root}: {cs.card_line()}", flush=True)
    sct._build.load()
    params = sct.invariant_params(cs.CUTOFF)
    conformers = cs.make_conformers(args.conformers, cs.N_RES, cs.SEED)
    chunk = torch.as_tensor(conformers[:cs.CHUNK], device="cuda")
    single = torch.as_tensor(
        cs.make_conformers(1, cs.N_SINGLE, cs.SEED)[0][None], device="cuda")
    bands = {
        "anm": spectrum.band_reduce(
            assembly_kernels.hessian_xyz_ensemble(chunk, params), 8),
        "gnm": spectrum.band_reduce(
            assembly_kernels.kirchhoff_ensemble(chunk, params), 8),
        "anm single": spectrum.band_reduce(
            assembly_kernels.hessian_xyz_ensemble(single, params), 8),
        "gnm single": spectrum.band_reduce(
            assembly_kernels.kirchhoff_ensemble(single, params), 8),
    }
    del chunk, single

    def k10(diags, n_iter):
        feed, lo, hi = spectrum.bisect_inputs(diags)
        return cs.cuda_ms(lambda: spectrum.banded_bisect(feed, lo, hi,
                                                         n_iter), args.reps)

    for label, n_iter in (("anm", 32), ("anm", 40), ("gnm", 32),
                          ("gnm", 40), ("anm single", 40),
                          ("gnm single", 40)):
        diags = bands[label]
        print(f"{root}: K10 {label} {tuple(diags.shape)}, {n_iter} "
              f"halvings: {k10(diags, n_iter):.4f} ms", flush=True)

    for label in ("anm", "gnm"):
        diags = bands[label]
        vals = spectrum.banded_bisect(*spectrum.bisect_inputs(diags), 40)
        feed, shifts, floor, _ = spectrum.eigvec_inputs(diags, vals)
        n = diags.shape[-1]
        chunks = [(c, shifts[:, c:c + 256].contiguous())
                  for c in range(0, n, 256)]

        def call(chunks=chunks, feed=feed, floor=floor):
            return [spectrum.banded_eigvec(feed, sh, c, floor, 2, 1.0)
                    for c, sh in chunks]

        per_call = cs.cuda_ms(call, args.reps)
        c0, sh0 = chunks[0]
        per_launch = cs.cuda_ms(
            lambda: spectrum.banded_eigvec(feed, sh0, c0, floor, 2, 1.0),
            args.reps)
        print(f"{root}: K11 {label} ({diags.shape[0]}, {n}): "
              f"{per_call:.4f} ms per call of {len(chunks)} launches, "
              f"{per_launch:.4f} ms per launch of {sh0.shape[1]} shifts",
              flush=True)
    del bands

    spectral = dict(n_modes=cs.N_MODES, n_iter_bisect=cs.N_ITER_BISECT,
                    chunk=cs.CHUNK, device="cuda")
    banded = dict(with_dcc=True, chunk=cs.CHUNK, device="cuda")
    for name, options in (
            ("ensemble_anm_spectral", spectral),
            ("ensemble_gnm_spectral",
             {**spectral, "n_iter_modes": cs.GNM_ITER_MODES}),
            ("ensemble_anm_banded", banded),
            ("ensemble_gnm_banded", banded)):
        fn = getattr(sct, name)
        times = []
        for _ in range(args.repeats + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(conformers, params, **options)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            cs.check(all(bool(torch.isfinite(v).all()) for v in out.values()
                         if torch.is_tensor(v)), f"{name}: non-finite")
            del out
        print(f"{root}: {name} {args.conformers} x N={cs.N_RES}: "
              + ", ".join(f"{t * 1e3:.1f}" for t in times[1:])
              + f" ms per call (warm-up {times[0] * 1e3:.1f})", flush=True)


if __name__ == "__main__":
    main()
