"""
Times of the prep kernel K2 (``regularize_stitch``) and the leaf kernel K3
(``panel_inverse_batched``) of one checkout at the shapes of the trace main
path, with the trace chunk's prep and inverse-factor stages and the whole
chunk, to compare two checkouts on one card.

On ``chip_smoke.py``'s first chunk (128 conformers of 300 residues,
invariant 13 A):

* K3 on the first leaf of the chunk's factor input, (128, 64, 64), and on
  its first panel alone, (1, 64, 64), the single-structure leaf: device
  time per call from a CUDA graph of `--calls` back-to-back calls replayed
  `--replays` times (the host's time to enqueue a call drops out), beside
  the CUDA-event time per call of `--reps` eager calls.  K9
  (``panel_inverse_full``) and ``torch.linalg.solve_triangular`` of the
  panels' Cholesky factor are timed the same way, in turns (K3, K9,
  solve, solve, K9, K3).  K3 must equal K9 and its plain version bit for
  bit.
* K2 on the chunk's planes, (128, n 300, mp 1024), under the invariant
  field and under sdENM, CUDA events, with its share of the bound (bytes:
  planes, scale and basis read once, the output written once, at
  3.35 TB/s).
* A SHA-256 of each K2 and K3 output, so that two checkouts' outputs can
  be compared bit for bit across processes.
* The chunk's stages, CUDA events over `--reps` calls: prep (stitch
  inputs and K2), the inverse factor (nodes and K3 leaves, with the column
  scaling); and the whole chunk of ``ensemble_anm_fluctuations``
  (plane traces) by host clock to a synchronize, `--repeats` calls after
  one warm-up.

The package is imported from `--root`, the helpers from this checkout's
``chip_smoke.py``; run the parent's ``git archive`` and this tree in turns
(parent, this, this, parent) in one command on one card.  GPU only.

Usage:  python3 tools/panel_stitch_ab.py --root PATH [--reps 20]
        [--calls 20] [--replays 10] [--repeats 10]
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


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--calls", type=int, default=20)
    parser.add_argument("--replays", type=int, default=10)
    parser.add_argument("--repeats", type=int, default=10)
    args = parser.parse_args()
    root = os.path.realpath(args.root)
    sys.path.insert(0, root)

    import torch

    cs = load_chip_smoke()
    import springcraft_tpu_torch as sct
    from springcraft_tpu_torch.ops import (assembly_kernels, rigid,
                                           spd_linalg)

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

    def graph_and_events(fn):
        return (cs.graph_ms(fn, args.calls, args.replays),
                cs.cuda_ms(fn, args.reps))

    # K2 under both families
    sd_enm = sct.TabulatedForceField.sd_enm(
        cs.make_ca_atoms(n)).to_compact_params()
    k2_bytes = 4 * (9 * batch * n * n + 7 * batch * m + batch * mp * mp)
    bound = k2_bytes / cs.HBM_BYTES_PER_S * 1e3
    for label, p in (("invariant", params), ("sdENM", sd_enm)):
        planes = assembly_kernels.hessian_planes_ensemble(chunk, p)
        scale, _, scale_h, ts = rigid.stitch_inputs(planes, bases)

        def k2(planes=planes, scale_h=scale_h, ts=ts):
            return assembly_kernels.regularize_stitch(planes, scale_h, ts,
                                                      mp)

        reg = k2()
        ms = cs.cuda_ms(k2, args.reps)
        print(f"{root}: K2 {label} ({batch}, n {n}, mp {mp}): {ms:.4f} ms, "
              f"bound {bound:.4f} ms (bytes), {bound / ms:.1%} of the "
              f"bound; sha256 {digest(reg)}", flush=True)
        if label == "invariant":
            kept = planes, reg, scale
        del planes, reg
    planes, reg, scale = kept

    # K3, K9, solve_triangular on the first leaf and on its first panel
    leaf = reg[:, :spd_linalg.LEAF, :spd_linalg.LEAF].contiguous()
    for panels in (leaf, leaf[:1].contiguous()):
        got = spd_linalg.panel_inverse_batched(panels, shrink_block=8)
        cs.check(torch.equal(got, spd_linalg.panel_inverse_plain(panels))
                 and torch.equal(got, spd_linalg.panel_inverse_full(panels)),
                 "K3 differs from K9 or its plain version")
        factor = torch.linalg.cholesky(panels)
        eye = torch.eye(panels.shape[-1], device="cuda").expand_as(factor)
        fns = {
            "K3": lambda p=panels: spd_linalg.panel_inverse_batched(
                p, shrink_block=8),
            "K9": lambda p=panels: spd_linalg.panel_inverse_full(p),
            "solve_triangular":
                lambda f=factor, e=eye: torch.linalg.solve_triangular(
                    f, e, upper=False),
        }
        order = list(fns) + list(reversed(list(fns)))
        times = {name: [] for name in fns}
        for name in order:
            times[name].append(graph_and_events(fns[name]))
        print(f"{root}: K3 {tuple(panels.shape)} sha256 {digest(got)}; in "
              "turns, ms per call as graph replay / CUDA events: "
              + "; ".join(f"{name} " + ", ".join(
                  f"{g:.4f} / {e:.4f}" for g, e in times[name])
                          for name in fns), flush=True)

    stages = {
        "prep (stitch inputs + K2)":
            lambda: rigid._regularize_equilibrated_planes(planes, n, bases),
        "inverse factor with column scaling":
            lambda: rigid._w_parts_from_reg_blocked(reg, scale),
    }
    for name, fn in stages.items():
        print(f"{root}: stage {name}: {cs.cuda_ms(fn, args.reps):.4f} ms",
              flush=True)

    times = []
    for _ in range(args.repeats + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sct.ensemble_anm_fluctuations(
            chunk, params, inverse="blocked", with_covariance=False,
            chunk=cs.CHUNK, device="cuda")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        cs.check(all(bool(torch.isfinite(v).all()) for v in out.values()
                     if torch.is_tensor(v)), "trace chunk: non-finite")
    print(f"{root}: whole trace chunk ({batch} x N={n}), host clock: "
          + ", ".join(f"{t:.3f}" for t in times[1:])
          + f" ms (warm-up {times[0]:.3f}; median "
          f"{sorted(times[1:])[len(times[1:]) // 2]:.3f})", flush=True)


if __name__ == "__main__":
    main()
