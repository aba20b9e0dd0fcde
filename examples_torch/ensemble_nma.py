"""
Ensemble NMA on the GPU
=======================

Batched NMA over many conformers of one protein (e.g. MD snapshots)
through the PyTorch port (the counterpart of ``examples/ensemble_nma.py``):
each conformer gets a complete ANM solve (Hessian, eigensolve,
observables), and the batch goes through the device in chunks, every
conformer of a chunk in the same launches.

On several GPUs, pass a mesh (springcraft_tpu_torch.parallel.make_mesh)
to parallel.sharded_ensemble_anm instead to spread conformers across
cards.

Run:  python examples_torch/ensemble_nma.py [--device DEVICE]

``--device`` defaults to ``cuda``; pass ``--device cpu`` to run without
a GPU.
"""

import sys
from os.path import abspath, dirname, join

sys.path.insert(0, dirname(dirname(abspath(__file__))))  # in-repo run

import numpy as np

import springcraft_tpu_torch as sct
from springcraft_tpu_torch.parallel import (ensemble_anm,
                                            ensemble_anm_fluctuations)
from springcraft_tpu_torch.structure import load_structure

N_CONFORMERS = 32

argv = sys.argv[1:]
device = "cuda"
if argv[:1] == ["--device"]:
    device, argv = argv[1], argv[2:]

path = join(dirname(dirname(abspath(__file__))), "tests", "data",
            "1l2y.pdb")
atoms = load_structure(path, model=1)
ca = atoms[(atoms.atom_name == "CA") & (atoms.element == "C")]

# Synthesize an ensemble by jittering the experimental structure
rng = np.random.RandomState(0)
conformers = ca.coord[None] + 0.3 * rng.randn(
    N_CONFORMERS, ca.array_length(), 3
).astype(np.float32)

params = sct.InvariantForceField(13.0).to_params()

# Full spectral pipeline (eigensolve per conformer)
out = ensemble_anm(conformers, params, device=device)
print("eig_values:", out["eig_values"].shape)     # (B, 3n)
print("msf:       ", out["msf"].shape)            # (B, n)
print("mean MSF profile:",
      np.round(out["msf"].cpu().numpy().mean(0)[:5], 3))

# Fast covariance-only pipeline (regularized Cholesky, no eigensolve):
# an order of magnitude faster when only fluctuation observables are
# needed.  On the GPU this routes the whole batch through the blocked
# panel-Cholesky inverse and its CUDA kernels (inverse="auto"); pass
# inverse="cho_solve" to force the per-conformer torch.linalg route.
fluc = ensemble_anm_fluctuations(conformers, params, with_dcc=True,
                                 device=device)
print("fast-path MSF matches:",
      bool(np.allclose(fluc["msf"].cpu().numpy(),
                       out["msf"].cpu().numpy(), rtol=5e-3, atol=1e-4)))

# GNM spectral ensemble: all Kirchhoff eigenvalues via the natively
# batched two-stage banded solver + covariance observables + the 3
# lowest mode shapes, no dense eigh anywhere
from springcraft_tpu_torch.parallel import ensemble_gnm_spectral

gnm = ensemble_gnm_spectral(conformers, params, n_modes=3, device=device)
print("GNM eig_values:", gnm["eig_values"].shape)    # (B, n)
print("GNM mode_values[0]:",
      np.round(gnm["mode_values"][0].cpu().numpy(), 4))
