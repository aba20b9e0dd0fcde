"""
The two redesigned kernels on the card, each held against its plain
version and timed with CUDA events in turns.

* K9 (``panel_inverse_full``, ``csrc/panel_inverse.cu``) on the main
  path's shape, 128 equilibrated SPD panels of 64, in turns with
  ``torch.linalg.solve_triangular`` of the Cholesky factor and the shrink
  kernel K3; its output must equal the plain version and K3 bit for bit.
* K12 (``hessian_apply_dense``, ``csrc/matfree_hessian.cu``) at
  ``chip_smoke.py``'s n = 10,000 under the cutoff-free ``pfenm`` family at
  k = 48, 24 and 64 and under sdENM at k = 48, each within 1e-5 of max of
  the plain version.

Prints the card (name, power limit) first.  GPU only.

Usage:  python3 tools/sweep_k9_k12.py [--reps 20]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.realpath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import springcraft_tpu_torch as sct  # noqa: E402
from springcraft_tpu_torch.ops import matfree, spd_linalg  # noqa: E402


def spd_panels(count, pb, seed):
    rng = np.random.RandomState(seed)
    a = rng.randn(count, pb, pb)
    a = a @ a.transpose(0, 2, 1) / pb + 0.5 * np.eye(pb)
    d = 1.0 / np.sqrt(np.diagonal(a, axis1=1, axis2=2))
    return torch.as_tensor((a * d[:, :, None] * d[:, None, :]).astype(
        np.float32), device="cuda")


def in_turns(fns, reps):
    """Mean ms of each of `fns` over the order a, b, ..., ..., b, a."""
    order = list(range(len(fns))) + list(reversed(range(len(fns))))
    times = [[] for _ in fns]
    for i in order:
        times[i].append(cs.cuda_ms(fns[i], reps))
    return [sum(t) / len(t) for t in times]


def time_k9(reps):
    panels = spd_panels(128, spd_linalg.LEAF, seed=1)
    got = spd_linalg.panel_inverse_full(panels)
    torch.cuda.synchronize()
    cs.check(torch.equal(got, spd_linalg.panel_inverse_plain(panels))
             and torch.equal(got, spd_linalg.panel_inverse_batched(
                 panels, shrink_block=8)),
             "K9 differs from the plain version or K3")
    factor = torch.linalg.cholesky(panels)
    eye = torch.eye(spd_linalg.LEAF, device="cuda").expand_as(factor)
    times = in_turns(
        [lambda: torch.linalg.solve_triangular(factor, eye, upper=False),
         lambda: spd_linalg.panel_inverse_full(panels),
         lambda: spd_linalg.panel_inverse_batched(panels, shrink_block=8)],
        reps)
    print(f"K9 (128, 64, 64): solve_triangular {times[0]:.4f} ms; K9 "
          f"{times[1]:.4f} ms; K3 {times[2]:.4f} ms", flush=True)


def time_k12(reps):
    n = cs.N_MATFREE_DENSE
    coord = torch.as_tensor(cs.matfree_coord(n), device="cuda")
    gen = torch.Generator("cuda").manual_seed(cs.MATFREE_SEED + 1)
    for params, label, widths in (
            (sct.pfenm_params(None), "pfenm", (48, 24, 64)),
            (cs.sd_enm_compact(n), "sdENM 16.5 A", (48,))):
        for k in widths:
            x = torch.randn(3 * n, k, device="cuda", generator=gen)
            ref = matfree.hessian_apply_dense_plain(coord, x, params)
            got = matfree.hessian_apply_dense(coord, x, params)
            torch.cuda.synchronize()
            _, rel = cs.max_errors(got, ref)
            cs.check(rel <= 1e-5, f"K12 {label} k={k}: max rel err "
                     f"{rel:.3e}")
            ms = cs.cuda_ms(
                lambda: matfree.hessian_apply_dense(coord, x, params), reps)
            print(f"K12 {label} n={n} k={k}: {ms:.4f} ms, max rel err "
                  f"{rel:.3e}", flush=True)
            del ref


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    cs.check(torch.cuda.is_available(), "needs a CUDA device")
    print(cs.card_line(), flush=True)
    cs.build_kernels()
    time_k9(args.reps)
    time_k12(max(args.reps // 4, 3))


if __name__ == "__main__":
    main()
