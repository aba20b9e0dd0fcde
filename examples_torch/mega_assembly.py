"""
Mega-assembly ANM
=================

Large-system workflow on the GPU through the PyTorch port (the
counterpart of ``examples/mega_assembly.py``): build the Hessian with the
port's CUDA assembly kernel, then either (a) extract only the lowest
functional modes iteratively (Cholesky shift-invert subspace iteration
with analytic rigid-body deflation — O(k n^2) instead of O(n^3)), or (b)
get all fluctuation observables from the regularized Cholesky
covariance.  Beyond the dense regime entirely, see
examples_torch/matrix_free_modes.py.  On several GPUs,
parallel.sharded_hessian builds the matrix row-sharded over a mesh.

On ``--device cpu`` the Hessian comes from the plain float32 assembly.

Run:  python examples_torch/mega_assembly.py [--device DEVICE] [n_residues]

``--device`` defaults to ``cuda``; pass ``--device cpu`` to run without
a GPU.
"""

import sys
from os.path import abspath, dirname

sys.path.insert(0, dirname(dirname(abspath(__file__))))  # in-repo run

import time

import numpy as np
import torch

from springcraft_tpu_torch import resolve_device, synchronize
from springcraft_tpu_torch.ops import ffparams, modes, pallas_kernels, rigid

argv = sys.argv[1:]
device = "cuda"
if argv[:1] == ["--device"]:
    device, argv = argv[1], argv[2:]

N = int(argv[0]) if argv else 2048
K_MODES = 20

# Synthetic CA cloud: perturbed cubic lattice at protein-like density.
# (A uniform random ball leaves isolated atoms -> extra zero modes; the
# analytic-null-space fast paths require a *connected* network — check
# with springcraft_tpu_torch.utils.network.is_connected.)
rng = np.random.RandomState(0)
side = int(np.ceil(N ** (1 / 3)))
grid = np.stack(
    np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1
).reshape(-1, 3)[:N]
coord = (grid * 5.5 + 0.8 * rng.randn(N, 3)).astype(np.float32)

params = ffparams.invariant_params(13.0)

t0 = time.perf_counter()
if resolve_device(device).type == "cuda":
    hessian = pallas_kernels.hessian_pallas(coord, params, device=device)
else:
    from springcraft_tpu_torch.ops import assembly

    hessian = assembly.hessian_matrix(torch.as_tensor(coord, device=device),
                                      params, layout="xyz")
synchronize(hessian)
print(f"Hessian {tuple(hessian.shape)} built in "
      f"{time.perf_counter() - t0:.2f}s")

# (a) lowest functional modes, iteratively
t0 = time.perf_counter()
vals, vecs = synchronize(modes.lowest_modes_anm(hessian, coord,
                                                k=K_MODES + 4))
vals = vals.cpu().numpy()
print(f"{K_MODES}+4 lowest modes in {time.perf_counter() - t0:.2f}s; "
      f"eigenvalues {np.round(vals[:5], 5)}")

# f64 accuracy pass: Rayleigh-Ritz on the device's float64 operator
# upgrades the f32 eigenvalues to ~1e-9 rtol (solve k+4, report k — the
# subspace-boundary modes converge slowest)
t0 = time.perf_counter()
ref_vals, ref_vecs, ref_res = (
    t.cpu().numpy() for t in synchronize(modes.refine_modes_f64(
        coord, params, vecs, layout="xyz")))
print(f"f64 refinement in {time.perf_counter() - t0:.2f}s; raw-vs-"
      f"refined rtol {np.max(np.abs(vals[:K_MODES] - ref_vals[:K_MODES])
                             / ref_vals[:K_MODES]):.1e}, "
      f"f64 residuals max {ref_res[:K_MODES].max():.1e}")

# (b) fluctuations via the fast covariance path
t0 = time.perf_counter()
basis = rigid.rigid_modes_anm(torch.as_tensor(coord, device=hessian.device),
                              layout="xyz")
cov = rigid.covariance_cholesky(hessian, basis)
n = N
msf = torch.einsum("aiai->i", cov.reshape(3, n, 3, n)).cpu().numpy()
print(f"covariance + MSF in {time.perf_counter() - t0:.2f}s; "
      f"MSF mean {msf.mean():.4f}")
