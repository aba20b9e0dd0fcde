"""
Pair counts of the matrix-free block-sparse operators (the pair CSR, K13,
K14).

For random atoms at protein density (the JAX package's matrix-free
benchmark draw, ``bench.py:665-668``: ``rand(n, 3) * (n / rho) ** (1/3)``,
seed 4) at a 13 A cutoff and 256-atom tiles, prints per n the row tiles,
the neighbour tiles per row tile (mean / max), the atom pairs the tile
walk visits, the ordered pairs within the cutoff (the pair CSR) and
their share; then, per block of 32 consecutive rows (Morton order), how
many distinct neighbour slots the block reads and over how wide a range
of slots they spread (10th / 50th / 90th percentile): a window of X
staged per block in shared memory would have to hold that range, or
that many rows gathered one by one.  A count from the port's host set-up
and the plain pair-CSR build (``springcraft_tpu_torch.ops.matfree``),
not a timing: it runs on the CPU or, given ``--device cuda``, on the
card.

Usage:  python tools/matfree_pair_counts.py [--n 10000 30000 100000]
            [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.realpath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import springcraft_tpu_torch as sct  # noqa: E402
from springcraft_tpu_torch.ops import matfree  # noqa: E402

CUTOFF = 13.0
TILE = 256
SEED = 4
CA_DENSITY = 300 / 34.0 ** 3
BLOCK_ROWS = 32


def counts(n, device):
    rng = np.random.RandomState(SEED)
    coord = rng.rand(n, 3) * (n / CA_DENSITY) ** (1 / 3)
    perm = matfree.spatial_sort_permutation(coord)
    nbr, per_row = matfree.tile_neighbor_lists(coord[perm], CUTOFF, TILE)
    csr = matfree.tile_csr(nbr, per_row, perm, n, TILE, device)
    c = torch.as_tensor(coord[perm], dtype=torch.float32, device=device)
    pairs = matfree.pair_csr_plain(c, sct.invariant_params(CUTOFF), csr,
                                   TILE)
    row_ptr = pairs.row_ptr.cpu().numpy()
    slots = pairs.slots.cpu().numpy()
    spans, distinct = [], []
    for r0 in range(0, n, BLOCK_ROWS):
        block = slots[row_ptr[r0]:row_ptr[min(n, r0 + BLOCK_ROWS)]]
        if len(block):
            spans.append(int(block.max()) - int(block.min()) + 1)
            distinct.append(len(np.unique(block)))
    visited = int(per_row.sum()) * TILE ** 2
    return (len(per_row), per_row.mean(), per_row.max(), visited, len(slots),
            np.percentile(distinct, [10, 50, 90]),
            np.percentile(spans, [10, 50, 90]))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, nargs="+",
                        default=[10_000, 30_000, 100_000])
    parser.add_argument("--device", default="cpu")
    args = parser.parse_args()
    print(f"| n | row tiles | neighbour tiles per row, mean / max | atom "
          f"pairs visited | within 13 A | share | distinct neighbour slots "
          f"per {BLOCK_ROWS} rows, p10 / p50 / p90 | their slot range, "
          f"p10 / p50 / p90 |")
    for n in args.n:
        tiles, mean, most, visited, within, distinct, spans = counts(
            n, args.device)
        print(f"| {n:,} | {tiles} | {mean:.1f} / {most} | {visited:.3e} | "
              f"{within:,} | {within / visited:.4%} | "
              + " / ".join(f"{v:.0f}" for v in distinct) + " | "
              + " / ".join(f"{v:.0f}" for v in spans) + " |", flush=True)


if __name__ == "__main__":
    main()
