"""
Perturbation scanning with the matrix-free solvers
==================================================

Linear response and perturbation-response scanning (PRS) both apply the
pseudo-inverse covariance.  The dense route materializes the
``(3n, 3n)`` covariance (reference ``anm.py:133-136``) — impossible
beyond ~15k residues.  The matrix-free route of the PyTorch port (the
counterpart of ``examples/perturbation_scan.py``) solves
``pinv(H) @ rhs`` directly by deflated, block-Jacobi-preconditioned
conjugate gradients on the implicit operator: rigid-body modes are
projected out, each column gets its own step sizes, and all right-hand
sides of a call share one block solve.

This example pokes a real structure with directed forces and scans
candidate effector sites, then cross-checks against the dense model
(possible at this size).  It solves in float64, native on the H100 as
on the CPU; at real mega scale use float32 (the CUDA kernels' route)
and float32 tolerances.

Run:  python examples_torch/perturbation_scan.py [--device DEVICE]

``--device`` defaults to ``cuda``; pass ``--device cpu`` to run without
a GPU.
"""

import sys
from os.path import abspath, dirname, join

sys.path.insert(0, dirname(dirname(abspath(__file__))))  # in-repo run

import numpy as np
import torch

import springcraft_tpu_torch as sct
from springcraft_tpu_torch.ops import ffparams, matfree
from springcraft_tpu_torch.structure import load_structure

argv = sys.argv[1:]
device = "cuda"
if argv[:1] == ["--device"]:
    device, argv = argv[1], argv[2:]

path = join(dirname(dirname(abspath(__file__))), "tests", "data",
            "1l2y.pdb")
atoms = load_structure(path, model=1)
ca = atoms[(atoms.atom_name == "CA") & (atoms.element == "C")]
n = ca.array_length()

anm = sct.ANM(ca, sct.InvariantForceField(13.0), device=device)
params = ffparams.invariant_params(13.0)

# --- linear response: push residue 5 in +z, pull residue 12 in -x ---
force = np.zeros((n, 3))
force[4, 2] = 5.0
force[11, 0] = -3.0

disp = anm.linear_response(force, matrix_free=True, tol=1e-8,
                           dtype=torch.float64)
dense = anm.linear_response(force)
print(f"linear response: max |displacement| = "
      f"{np.max(np.linalg.norm(disp, axis=1)):.4f} A; "
      f"matrix-free vs dense max diff = "
      f"{np.max(np.abs(np.asarray(disp) - np.asarray(dense))):.2e}")

# --- PRS rows for candidate effector sites ---
sites = [0, 4, 9, 14, 19]
rows, n_it, res = matfree.prs_rows_matfree(
    np.asarray(ca.coord, dtype=np.float64), params, sites,
    tol=1e-9, dtype=torch.float64, device=device)
rows = rows.cpu().numpy()
print(f"PRS rows for sites {sites}: {int(n_it)} CG iterations, "
      f"max rel residual {float(res.max()):.1e}")

prs_full, effector, _ = anm.prs_effector_sensor()
best = sites[int(np.argmax([rows[i].mean() for i in range(len(sites))]))]
print(f"strongest effector among candidates: residue {best + 1} "
      f"(global effector ranking #"
      f"{int(np.argsort(np.asarray(effector))[::-1].tolist().index(best)) + 1})")
print("dense-PRS cross-check max diff:",
      float(np.max(np.abs(rows - np.asarray(prs_full)[sites]))))
