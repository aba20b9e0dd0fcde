"""
Matrix-free modes beyond device memory
======================================

For very large assemblies the ``(3n, 3n)`` Hessian outgrows device
memory (20k residues -> 14.4 GB f32, 100k -> 360 GB; one H100 holds 80
GB) — and the reference's dense ``eigh`` path (reference ``nma.py:61``)
was never an option.  The matrix-free pipeline of the PyTorch port (the
counterpart of ``examples/matrix_free_modes.py``) keeps the operator
implicit:

1. atoms are Morton-sorted so 256-atom tiles are spatially compact;
2. tile-level AABB neighbor lists prune the pair plane (a cell list —
   O(n * neighbors) per product, not O(n^2));
3. on the GPU a CUDA kernel walks those tiles once per solve into a
   compressed list of the interacting atom pairs, and a gather kernel
   computes ``H @ X`` over it on every product (the Hessian never
   exists, even tiled, in device memory);
4. Chebyshev-filtered subspace iteration extracts the lowest modes,
   with the rigid-body null space shifted into the damped band and a
   Gershgorin degree bound as the guaranteed spectral edge.

Always check the returned residuals — iterative mode solvers are only
as good as their convergence.

Run:  python examples_torch/matrix_free_modes.py [--device DEVICE] [n_residues]

``--device`` defaults to ``cuda``; pass ``--device cpu`` to run without
a GPU (the plain PyTorch operators).
"""

import sys
from os.path import abspath, dirname

sys.path.insert(0, dirname(dirname(abspath(__file__))))  # in-repo run

import time

import numpy as np

from springcraft_tpu_torch import synchronize
from springcraft_tpu_torch.ops import ffparams, matfree

argv = sys.argv[1:]
device = "cuda"
if argv[:1] == ["--device"]:
    device, argv = argv[1], argv[2:]

N = int(argv[0]) if argv else 1536
K_MODES = 6

# Synthetic CA cloud: perturbed cubic lattice at protein-like density
# (connected at the 13 A cutoff).
rng = np.random.RandomState(0)
side = int(np.ceil(N ** (1 / 3)))
grid = np.stack(
    np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1
).reshape(-1, 3)[:N]
coord = (grid * 5.5 + 0.8 * rng.randn(N, 3)).astype(np.float32)

params = ffparams.invariant_params(13.0)

t0 = time.perf_counter()
vals, vecs, res = synchronize(matfree.lowest_modes_matfree(
    coord, params, K_MODES,
    degree=64, n_outer=8,
    device=device,
))
vals = vals.cpu().numpy()
print(f"{K_MODES} lowest modes of the {3 * N}x{3 * N} operator in "
      f"{time.perf_counter() - t0:.2f}s (Hessian never materialized)")
print("eigenvalues:", np.array2string(vals, precision=4))
print("max relative residual:", float(res.max()))

# Independent convergence check through the plain PyTorch operator
res2 = matfree.matfree_mode_residuals(coord, params, vals, vecs,
                                      device=device)
print("independent residual check:", float(res2.max()))

# MSF contribution of the computed low modes (the physically dominant
# part of the fluctuation spectrum; reference mode_subset semantics)
u = vecs.cpu().numpy().reshape(K_MODES, 3, N)
msf = np.sum(np.sum(u**2, axis=1) / vals[:, None], axis=0)
print("low-mode MSF range:", float(msf.min()), "-", float(msf.max()))
