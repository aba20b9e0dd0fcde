"""
Checkpoint / resume
===================

Persist a computed model to disk and resume analyses later without
recomputation — the framework's replacement for the reference's manual
"assign a precomputed matrix to the setter" pattern — on the GPU
through the PyTorch port (the counterpart of
``examples/checkpoint_resume.py``; the file layout is the JAX
package's, so either package reads the other's checkpoint).

Run:  python examples_torch/checkpoint_resume.py [--device DEVICE]

``--device`` defaults to ``cuda``; pass ``--device cpu`` to run without
a GPU.
"""

import sys
from os.path import abspath, dirname, join

sys.path.insert(0, dirname(dirname(abspath(__file__))))  # in-repo run

import numpy as np

import springcraft_tpu_torch as sct
from springcraft_tpu_torch.io import load_model, save_model
from springcraft_tpu_torch.structure import load_structure

argv = sys.argv[1:]
device = "cuda"
if argv[:1] == ["--device"]:
    device, argv = argv[1], argv[2:]

path = join(dirname(dirname(abspath(__file__))), "tests", "data",
            "1l2y.pdb")
atoms = load_structure(path, model=1)
ca = atoms[(atoms.atom_name == "CA") & (atoms.element == "C")]

# Compute once ...
anm = sct.ANM(ca, sct.TabulatedForceField.e_anm(ca), device=device)
_ = anm.covariance  # populate the expensive caches
save_model("anm_checkpoint.npz", anm)
print("saved anm_checkpoint.npz")

# ... resume later: no force field needed, matrices come from disk
restored = load_model("anm_checkpoint.npz", device=device)
msf = restored.mean_square_fluctuation()
print("resumed MSF matches:",
      bool(np.allclose(msf, anm.mean_square_fluctuation())))
prs, eff, sens = restored.prs_effector_sensor()
print("PRS from checkpoint:", prs.shape)
