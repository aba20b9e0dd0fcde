"""
Times of the panel Cholesky kernel K8 (``panel_cholesky``) of one checkout
at (128, 64, 64), (1, 64, 64), (128, 128, 128) and (1, 128, 128), to
compare two checkouts on one card.

The panels are the leading 64- and 128-blocks of ``chip_smoke.py``'s first
chunk's factor input (128 conformers of 300 residues, invariant 13 A,
after the planes prep), and their first panel alone.  At each shape:

* K8, K3 (``panel_inverse_batched(shrink_block=8)``, the same elimination
  on twice the columns) and ``torch.linalg.cholesky_ex`` (the library
  call; ``torch.linalg.cholesky`` itself reads its error code on the host
  and cannot be captured) by replaying a CUDA graph of `--calls`
  back-to-back calls `--replays` times, in turns (K8, K3, library,
  library, K3, K8): the host's time to enqueue a call drops out;
* K8 and ``torch.linalg.cholesky`` per eager call (CUDA events over
  `--reps` calls), and the plain version over one call;
* a SHA-256 of K8's output, so that two checkouts' outputs can be
  compared bit for bit across processes; K8 must equal its plain version
  bit for bit.

The package is imported from `--root`, the helpers from this checkout's
``chip_smoke.py``; run the parent's ``git archive`` and this tree in turns
(parent, this, this, parent) in one command on one card.  GPU only.

Usage:  python3 tools/panel_cholesky_ab.py --root PATH [--reps 20]
        [--calls 20] [--replays 10]
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
    from springcraft_tpu_torch.ops import assembly_kernels, rigid, spd_linalg

    cs.check(torch.cuda.is_available(), "needs a CUDA device")
    cs.check(os.path.dirname(os.path.realpath(sct.__file__)).startswith(
        root), f"springcraft_tpu_torch not imported from {root}")
    print(f"{root}: {cs.card_line()}", flush=True)
    sct._build.load()
    chunk = torch.as_tensor(cs.make_conformers(cs.CHUNK, cs.N_RES, cs.SEED),
                            device="cuda")
    planes = assembly_kernels.hessian_planes_ensemble(
        chunk, sct.invariant_params(cs.CUTOFF))
    reg, _, _ = rigid._regularize_equilibrated_planes(
        planes, chunk.shape[1], rigid.rigid_modes_anm(chunk))
    del planes

    for pb in (spd_linalg.LEAF, spd_linalg.MAX_CHOLESKY_PANEL):
        block = reg[:, :pb, :pb].contiguous()
        for panels in (block, block[:1].contiguous()):
            got = spd_linalg.panel_cholesky(panels)
            plain, plain_ms = cs.timed_once(
                lambda p=panels: spd_linalg.panel_cholesky_plain(p))
            cs.check(torch.equal(got, plain),
                     f"K8 {tuple(panels.shape)} differs from its plain "
                     f"version")
            fns = {
                "K8": lambda p=panels: spd_linalg.panel_cholesky(p),
                "K3": lambda p=panels: spd_linalg.panel_inverse_batched(
                    p, shrink_block=8),
                "cholesky_ex": lambda p=panels: torch.linalg.cholesky_ex(p),
            }
            order = list(fns) + list(reversed(list(fns)))
            times = {name: [] for name in fns}
            for name in order:
                times[name].append(cs.graph_ms(fns[name], args.calls,
                                               args.replays))
            k8_ms = sum(times["K8"]) / 2
            events = cs.cuda_ms(fns["K8"], args.reps)
            library = cs.cuda_ms(lambda p=panels: torch.linalg.cholesky(p),
                                 args.reps)
            count = panels.shape[0]
            bound = 2 * 4 * count * pb * pb / cs.HBM_BYTES_PER_S * 1e3
            print(f"{root}: K8 {tuple(panels.shape)} sha256 {digest(got)}; "
                  "in turns by graph replay, ms per call: "
                  + "; ".join(f"{name} " + ", ".join(f"{t:.4f}" for t in ts)
                              for name, ts in times.items())
                  + f"; K8 {k8_ms * 1e3 / pb:.3f} us a step, bound "
                  f"{bound:.6f} ms (bytes); per eager call (CUDA events) K8 "
                  f"{events:.4f}, torch.linalg.cholesky {library:.4f}; plain "
                  f"{plain_ms:.4f} (one call)", flush=True)


if __name__ == "__main__":
    main()
