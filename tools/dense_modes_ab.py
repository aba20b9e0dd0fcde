"""
Seconds of the dense-grid matrix-free mode paths (K12) of one checkout,
to compare two checkouts on one card: ``lowest_modes_matfree`` at
``chip_smoke.py``'s n = 10,000 under the cutoff-free ``pfenm`` family and
under sdENM with ``sparse=False``, with ``chip_smoke.py``'s settings, each
timed over `--repeats` calls (host clock to a synchronize) with the number
of K12 launches per call.  The package and ``chip_smoke.py`` are imported
from `--root`, so a second checkout (``git archive``) times the same paths
with its own kernels; run them in turns in one command on one card.

Usage:  python3 tools/dense_modes_ab.py --root PATH [--repeats 2]
"""

import argparse
import os
import sys
import time


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=os.path.join(
        os.path.dirname(os.path.realpath(__file__)), ".."))
    parser.add_argument("--repeats", type=int, default=2)
    args = parser.parse_args()
    root = os.path.realpath(args.root)
    sys.path.insert(0, root)

    import torch

    import chip_smoke as cs
    import springcraft_tpu_torch as sct
    from springcraft_tpu_torch.ops import matfree

    cs.check(torch.cuda.is_available(), "needs a CUDA device")
    cs.check(os.path.dirname(os.path.realpath(sct.__file__)).startswith(
        root), f"springcraft_tpu_torch not imported from {root}")
    print(f"{root}: {cs.card_line()}", flush=True)
    sct._build.load()
    n = cs.N_MATFREE_DENSE
    coord = cs.matfree_coord(n)
    for label, params, options, n_outer, tol in (
            ("pfenm", sct.pfenm_params(None), {}, 10, cs.MATFREE_TOL),
            ("sdENM sparse=False", cs.sd_enm_compact(n), {"sparse": False},
             cs.TABULATED_OUTER, cs.TABULATED_TOL)):
        times = []
        for _ in range(args.repeats):
            before = matfree.hessian_apply_dense.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vals, _, _ = sct.lowest_modes_matfree(
                coord, params, cs.MATFREE_MODES, degree=96, n_outer=n_outer,
                tol=tol, **options)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            launches = matfree.hessian_apply_dense.launches - before
        cs.check(bool(torch.isfinite(vals).all()), f"{label}: non-finite")
        print(f"{root}: anm_matfree_modes_dense {label}, n={n}: "
              + ", ".join(f"{t:.3f}" for t in times)
              + f" s; {launches} K12 launches per call", flush=True)


if __name__ == "__main__":
    main()
