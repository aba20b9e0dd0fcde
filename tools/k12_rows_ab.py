"""
K12 (``sc_hessian_apply_dense``) of one checkout at ``chip_smoke.py``'s
parity shape, to compare two checkouts on one card: the SHA-256 of the
full call's output (n = 10,000, k = 48, ``pfenm``, the seeded inputs of
``chip_smoke.dense_parity``) and its time (CUDA events, 20 calls); where
the checkout's K12 takes a row range, the SHA-256 and time of each of the
four row shards of a 4-entry mesh and whether their rows are the full
call's bit for bit.  The package and ``chip_smoke.py`` are imported from
`--root`; run two checkouts in turns in one command on one card.

Usage:  python3 tools/k12_rows_ab.py --root PATH
"""

import argparse
import hashlib
import inspect
import os
import sys


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=os.path.join(
        os.path.dirname(os.path.realpath(__file__)), ".."))
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
    nd, k = cs.N_MATFREE_DENSE, cs.MATFREE_BLOCK
    cd = torch.as_tensor(cs.matfree_coord(nd), device="cuda")
    xd = torch.randn(3 * nd, k, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(
                         cs.MATFREE_SEED + 1))
    params = sct.pfenm_params(None)

    def sha(t):
        return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()

    full = matfree.hessian_apply_dense(cd, xd, params)
    ms = cs.cuda_ms(lambda: matfree.hessian_apply_dense(cd, xd, params))
    print(f"{root}: K12 ({nd}, {k}) pfenm full call {ms:.4f} ms, SHA-256 "
          f"{sha(full)}", flush=True)
    if "row_start" not in inspect.signature(matfree._launch_dense).parameters:
        print(f"{root}: no row range in this checkout's K12", flush=True)
        return
    rows = nd // 4
    for start in range(0, nd, rows):
        part = matfree._launch_dense(cd, xd, params, 256, start, rows)
        same = torch.equal(part, full.reshape(3, nd, k)[
            :, start:start + rows].reshape(3 * rows, k))
        ms = cs.cuda_ms(lambda: matfree._launch_dense(cd, xd, params, 256,
                                                      start, rows))
        print(f"{root}: K12 rows [{start}, {start + rows}) {ms:.4f} ms, "
              f"SHA-256 {sha(part)}, the full call's rows bit for bit: "
              f"{same}", flush=True)


if __name__ == "__main__":
    main()
