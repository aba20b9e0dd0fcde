"""
Times of the assembly-fused prep K7 (``assembly_stitch``, with its row-sum
pass) and its prep stage, the Kirchhoff kernel K4/K6
(``kirchhoff_ensemble``) and the other users of the table lookup
(K1, K5, the pair-CSR build) of one checkout, to compare two checkouts on
one card.

On ``chip_smoke.py``'s inputs:

* K7 on the first chunk (128 conformers of 300 residues, mp 1024) under
  the invariant field (13 A) and hinsen, both passes as the parity check
  calls them (one call of the wrapper in a checkout without the row-sum
  pass; then each pass alone), with its share of the byte bound
  (coordinates, scale and basis read once, the output written once, at
  3.35 TB/s);
* the chunk's two prep stages: direct (the diagonal, the stitch inputs
  and K7) and planes (K1, the stitch inputs and K2);
* K4/K6 at (128, 300) invariant and sdENM, at (1, 1776) invariant and
  eANM on 7cal's CA trace, and at 8,192 atoms invariant and sdENM; at
  (128, 299) and (1, 1777) invariant, where n % 4 != 0;
* the table branch's other kernels: K1 on the sdENM chunk, K5 on 7cal
  under eANM, the pair-CSR build under sdENM at 30,000 atoms;
* a SHA-256 of each output, so that two checkouts' outputs can be
  compared bit for bit across processes.

Kernels are timed by replaying a CUDA graph of `--calls` calls
`--replays` times (the host's enqueue time drops out), beside the
CUDA-event time per eager call; the prep stages, K1, K5 and the pair-CSR
build by CUDA events.

The package is imported from `--root`, the helpers from this checkout's
``chip_smoke.py``; run the parent's ``git archive`` and this tree in turns
(parent, this, this, parent) in one command on one card.  GPU only.

Usage:  python3 tools/assembly_ab.py --root PATH [--reps 20] [--calls 20]
        [--replays 10]
"""

import argparse
import hashlib
import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def digest(t):
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--calls", type=int, default=20)
    parser.add_argument("--replays", type=int, default=10)
    args = parser.parse_args()
    root = os.path.realpath(args.root)
    sys.path.insert(0, root)

    import torch

    cs = load_chip_smoke()
    import springcraft_tpu_torch as sct
    from springcraft_tpu_torch.ops import assembly_kernels, matfree, rigid
    from springcraft_tpu_torch.ops import spd_linalg

    cs.check(torch.cuda.is_available(), "needs a CUDA device")
    cs.check(os.path.dirname(os.path.realpath(sct.__file__)).startswith(
        root), f"springcraft_tpu_torch not imported from {root}")
    print(f"{root}: {cs.card_line()}", flush=True)
    sct._build.load()
    params = sct.invariant_params(cs.CUTOFF)
    chunk = torch.as_tensor(cs.make_conformers(cs.CHUNK, cs.N_RES, cs.SEED),
                            device="cuda")
    batch, n = chunk.shape[:2]
    m = 3 * n
    mp = spd_linalg.padded_size(m)
    bases = rigid.rigid_modes_anm(chunk)

    def say(text):
        print(f"{root}: {text}", flush=True)

    def bound_of(nbytes):
        return nbytes / cs.HBM_BYTES_PER_S * 1e3

    def timed(fn, reps=args.reps):
        """`(graph replay ms, eager CUDA-event ms)` of `fn`."""
        return (cs.graph_ms(fn, args.calls, args.replays),
                cs.cuda_ms(fn, reps))

    # K7, both passes (one wrapper call in a checkout without the
    # row-sum pass), and the two prep stages
    two_passes = hasattr(assembly_kernels, "assembly_row_sums")
    k7_bound = bound_of(4 * (3 * batch * n + 7 * batch * m
                             + batch * mp * mp))
    for label, p in (("invariant", params), ("hinsen", sct.hinsen_params())):
        _, _, scale_h, ts = rigid._stitch_inputs_from_diag(
            rigid._hessian_diag_xyz_batched(chunk, p), bases, None)

        def k7(p=p, scale_h=scale_h, ts=ts):
            if not two_passes:
                return assembly_kernels.assembly_stitch(chunk, p, scale_h,
                                                        ts, mp)
            return assembly_kernels.assembly_stitch(
                chunk, p, scale_h, ts, mp,
                assembly_kernels.assembly_row_sums(chunk, p))

        ms, eager = timed(k7)
        say(f"K7 {label} ({batch}, n {n}, mp {mp}): {ms:.4f} ms by graph "
            f"replay ({eager:.4f} per eager call), bound {k7_bound:.4f} ms "
            f"(bytes), {k7_bound / ms:.1%} of the bound; sha256 "
            f"{digest(k7())}")
        if two_passes:
            row_sums = assembly_kernels.assembly_row_sums(chunk, p)
            passes = {
                "row-sum pass": lambda p=p: assembly_kernels.
                assembly_row_sums(chunk, p),
                "store pass": lambda p=p, scale_h=scale_h, ts=ts, r=row_sums:
                assembly_kernels.assembly_stitch(chunk, p, scale_h, ts, mp,
                                                 r)}
            for name, fn in passes.items():
                ms, eager = timed(fn)
                say(f"K7 {label} {name}: {ms:.4f} ms by graph replay "
                    f"({eager:.4f} per eager call)")
    stages = {
        "direct prep (diagonal, stitch inputs, K7)":
            lambda: rigid._regularize_equilibrated_direct(chunk, params,
                                                          bases),
        "planes prep (K1, stitch inputs, K2)":
            lambda: rigid._regularize_equilibrated_planes(
                assembly_kernels.hessian_planes_ensemble(chunk, params), n,
                bases),
    }
    for name, fn in stages.items():
        say(f"stage {name}: {cs.cuda_ms(fn, args.reps):.4f} ms")

    # K4/K6 and the table branch's other kernels
    sd_enm = sct.TabulatedForceField.sd_enm(
        cs.make_ca_atoms(n)).to_compact_params()
    ca_7cal = cs.load_7cal_ca()
    e_anm = sct.TabulatedForceField.e_anm(ca_7cal).to_compact_params()
    single = torch.as_tensor(cs.make_conformers(1, cs.N_SINGLE, cs.SEED),
                             device="cuda")
    cal = torch.as_tensor(ca_7cal.coord[None], device="cuda")
    large = torch.as_tensor(cs.matfree_coord(cs.N_LARGE)[None],
                            device="cuda")
    cases = (("(128, 300) invariant", chunk, params),
             ("(128, 300) sdENM", chunk, sd_enm),
             ("(128, 299) invariant", chunk[:, :299].contiguous(), params),
             ("(1, 1776) invariant", single, params),
             ("(1, 1777) invariant", torch.as_tensor(cs.make_conformers(
                 1, cs.N_SINGLE + 1, cs.SEED), device="cuda"), params),
             ("(1, 1776) eANM on 7cal", cal, e_anm),
             ("(1, 8192) invariant", large, params),
             ("(1, 8192) sdENM", large, cs.sd_enm_compact(cs.N_LARGE)))
    for label, c, p in cases:
        b, nc = c.shape[:2]

        def k4(c=c, p=p):
            return assembly_kernels.kirchhoff_ensemble(c, p)

        bound = bound_of(4 * (3 * b * nc + b * nc * nc))
        ms, eager = timed(k4, 5 if nc > 4096 else args.reps)
        say(f"K4/K6 {label}: {ms:.4f} ms by graph replay ({eager:.4f} per "
            f"eager call), bound {bound:.4f} ms (bytes), {bound / ms:.1%} of "
            f"the bound; sha256 {digest(k4())}")
    for label, fn, reps in (
            ("K1 (128, 300) sdENM", lambda: assembly_kernels.
             hessian_planes_ensemble(chunk, sd_enm), args.reps),
            ("K5 (1, 1776) eANM on 7cal", lambda: assembly_kernels.
             hessian_xyz_ensemble(cal, e_anm), args.reps)):
        say(f"{label}: {cs.cuda_ms(fn, reps):.4f} ms; sha256 {digest(fn())}")
    sd30 = cs.sd_enm_compact(cs.N_MATFREE)
    c30, perm, csr = cs.sorted_layout(cs.matfree_coord(cs.N_MATFREE),
                                      float(sd30.cutoff_sq) ** 0.5)
    sorted30 = sd30.permuted(perm)

    def build():
        return matfree.pair_csr(c30, sorted30, csr, 256)

    say(f"pair CSR (1, {cs.N_MATFREE}) sdENM: {cs.cuda_ms(build, 5):.4f} "
        f"ms; sha256 of the constants {digest(build().k)}")


if __name__ == "__main__":
    main()
