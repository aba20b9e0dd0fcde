"""
Times of the assembly kernels K1 and K5 (``hessian_planes_ensemble``,
``hessian_xyz_ensemble``), the assembly-fused prep K7 (``assembly_stitch``,
with its row-sum pass) and the two prep stages, the Kirchhoff kernel
K4/K6 (``kirchhoff_ensemble``), the pair-CSR build (the table lookup's
other user) and the headline trace path, of one checkout, to compare two
checkouts on one card.

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
* K1 and K5 at (128, 300), (128, 299), (1, 1777) and (1, 8192) under the
  invariant field and sdENM, K5 also at (1, 1776) invariant, on 7cal
  under eANM and on one structure of 30,000 atoms (a 32.4 GB Hessian),
  each with its share of the byte bound (coordinates and tables read
  once, the output written once) and two SHA-256s: of the output with
  its diagonal superelements zeroed (the off-diagonal part, to compare
  bit for bit across checkouts) and of those diagonal entries alone;
* the pair-CSR build under sdENM at 30,000 atoms;
* the headline trace path: ``ensemble_anm_fluctuations`` plane traces
  over 1,024 conformers in chunks of 128, host clock, solves/s.

Kernels are timed by replaying a CUDA graph of `--calls` calls
`--replays` times (the host's enqueue time drops out), beside the
CUDA-event time per eager call; the 30,000-atom K5, the prep stages and
the pair-CSR build by CUDA events.

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
import time

HERE = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def digest(t):
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def hessian_digests(h):
    """``(off-diagonal, diagonal)``: SHA-256s (16 hex digits) of K1's
    planes ``(9, B, n, n)`` or K5's Hessians ``(B, 3n, 3n)`` with the
    entries of their diagonal superelements (atoms p == q) zeroed, and of
    those entries alone, streamed over slices of 64 MB of rows (a
    30,000-atom Hessian is 32.4 GB)."""
    import torch

    n = h.shape[-1] if h.ndim == 4 else h.shape[-1] // 3
    rows = h.reshape(-1, h.shape[-1])
    spread = torch.arange(1 if h.ndim == 4 else 3, device=h.device) * n
    step = max(1, (64 << 20) // (4 * rows.shape[1]))
    off, diag = hashlib.sha256(), hashlib.sha256()
    for r0 in range(0, rows.shape[0], step):
        part = rows[r0:r0 + step].clone()
        cols = (torch.arange(r0, r0 + part.shape[0], device=h.device)
                % n)[:, None] + spread
        diag.update(part.gather(1, cols).cpu().numpy().tobytes())
        part.scatter_(1, cols, 0.0)
        off.update(part.cpu().numpy().tobytes())
    return off.hexdigest()[:16], diag.hexdigest()[:16]


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
    torch.cuda.empty_cache()

    # K1 and K5 at every shape of their paths, both branches
    def table_bytes(p, nc):
        if p.kind != "table_compact":
            return 0
        return 4 * (p.n_bins * 1200 + len(p.edges_sq or ()) + nc)

    c299 = chunk[:, :n - 1].contiguous()
    sd_299 = sct.TabulatedForceField.sd_enm(
        cs.make_ca_atoms(n - 1)).to_compact_params()
    c1777 = torch.as_tensor(cs.make_conformers(1, cs.N_SINGLE + 1, cs.SEED),
                            device="cuda")
    sd_1777 = cs.sd_enm_compact(cs.N_SINGLE + 1)
    sd_large = cs.sd_enm_compact(cs.N_LARGE)
    hessians = [
        ("(128, 300) invariant", chunk, params),
        ("(128, 300) sdENM", chunk, sd_enm),
        ("(128, 299) invariant", c299, params),
        ("(128, 299) sdENM", c299, sd_299),
        ("(1, 1777) invariant", c1777, params),
        ("(1, 1777) sdENM", c1777, sd_1777),
        ("(1, 8192) invariant", large, params),
        ("(1, 8192) sdENM", large, sd_large)]
    for name, wrapper, extra in (
            ("K1", assembly_kernels.hessian_planes_ensemble, []),
            ("K5", assembly_kernels.hessian_xyz_ensemble,
             [("(1, 1776) invariant", single, params),
              ("(1, 1776) eANM on 7cal", cal, e_anm)])):
        for label, c, p in hessians[:2] + extra + hessians[2:]:
            b, nc = c.shape[:2]

            def fn(c=c, p=p, wrapper=wrapper):
                return wrapper(c, p)

            bound = bound_of(4 * (3 * b * nc + 9 * b * nc * nc)
                             + table_bytes(p, nc))
            ms, eager = timed(fn, 5 if nc > 4096 else args.reps)
            off, diag = hessian_digests(fn())
            torch.cuda.empty_cache()
            say(f"{name} {label}: {ms:.4f} ms by graph replay ({eager:.4f} "
                f"per eager call), bound {bound:.4f} ms (bytes), "
                f"{bound / ms:.1%} of the bound; sha256 off-diagonal {off}, "
                f"diagonal {diag}")
    del single, cal, c299, c1777, large
    torch.cuda.empty_cache()
    n30 = cs.N_MATFREE
    c30 = torch.as_tensor(cs.matfree_coord(n30)[None], device="cuda")
    invariant30 = sct.invariant_params(cs.MATFREE_CUTOFF)

    def k5_30():
        return assembly_kernels.hessian_xyz_ensemble(c30, invariant30)

    ms = cs.cuda_ms(lambda: k5_30() is None, 3)
    bound = bound_of(4 * (3 * n30 + 9 * n30 * n30))
    off, diag = hessian_digests(k5_30())
    torch.cuda.empty_cache()
    say(f"K5 (1, {n30}) invariant: {ms:.4f} ms by CUDA events (3 calls), "
        f"bound {bound:.4f} ms (bytes), {bound / ms:.1%} of the bound; "
        f"sha256 off-diagonal {off}, diagonal {diag}")
    del c30

    sd30 = cs.sd_enm_compact(cs.N_MATFREE)
    c30, perm, csr = cs.sorted_layout(cs.matfree_coord(cs.N_MATFREE),
                                      float(sd30.cutoff_sq) ** 0.5)
    sorted30 = sd30.permuted(perm)

    def build():
        return matfree.pair_csr(c30, sorted30, csr, 256)

    say(f"pair CSR (1, {cs.N_MATFREE}) sdENM: {cs.cuda_ms(build, 5):.4f} "
        f"ms; sha256 of the constants {digest(build().k)}")
    del c30, csr, sorted30
    torch.cuda.empty_cache()

    # the headline trace path
    conformers = cs.make_conformers(cs.N_CONFORMERS, cs.N_RES, cs.SEED)
    rates = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sct.ensemble_anm_fluctuations(
            conformers, params, inverse="blocked", with_covariance=False,
            chunk=cs.CHUNK, device="cuda")
        torch.cuda.synchronize()
        rates.append(cs.N_CONFORMERS / (time.perf_counter() - t0))
        cs.check(all(bool(torch.isfinite(v).all()) for v in out.values()
                     if torch.is_tensor(v)), "trace path: non-finite")
    say(f"trace path ({cs.N_CONFORMERS} x N={cs.N_RES}, chunk {cs.CHUNK}), "
        f"host clock: " + ", ".join(f"{r:.1f}" for r in rates[1:])
        + f" solves/s (warm-up {rates[0]:.1f})")


if __name__ == "__main__":
    main()
