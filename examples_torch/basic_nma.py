"""
Basic NMA of a protein elastic network model
============================================

Normal mode analysis of a coarse-grained CA elastic network, using the
eANM tabulated force field: eigenvalues, frequencies and mean-square
fluctuations, on the GPU through the PyTorch port (the counterpart of
``examples/basic_nma.py`` and of the reference gallery script
``doc/examples/scripts/basic_nma.py``).  The model API computes in
float64 on the device and returns NumPy arrays.

Run:  python examples_torch/basic_nma.py [--device DEVICE] [path/to/structure.pdb]

``--device`` defaults to ``cuda``; pass ``--device cpu`` to run without
a GPU.
"""

import sys
from os.path import abspath, dirname, join

sys.path.insert(0, dirname(dirname(abspath(__file__))))  # in-repo run

import numpy as np

import springcraft_tpu_torch as sct
from springcraft_tpu_torch.structure import load_structure

argv = sys.argv[1:]
device = "cuda"
if argv[:1] == ["--device"]:
    device, argv = argv[1], argv[2:]

path = argv[0] if argv else join(
    dirname(dirname(abspath(__file__))), "tests", "data", "1l2y.pdb"
)

# Load the structure and reduce it to the CA trace
atoms = load_structure(path, model=1)
ca = atoms[(atoms.atom_name == "CA") & (atoms.element == "C")]
print(f"{ca.array_length()} CA atoms")

# Anisotropic network model with the eANM force field
# (Miyazawa-Jernigan intra-chain / Keskin inter-chain parameters)
ff = sct.TabulatedForceField.e_anm(ca)
eanm = sct.ANM(ca, ff, device=device)

# Eigenvalues / frequencies (first six modes are rigid-body motions)
eigenval, eigenvec = eanm.eigen()
freq = eanm.frequencies()
msqf = eanm.mean_square_fluctuation()
bfac = eanm.bfactor()

print("lowest non-trivial eigenvalues:", np.round(eigenval[6:12], 4))
print("corresponding frequencies:    ", np.round(freq[6:12], 4))
print("MSF range: %.4f .. %.4f" % (msqf.min(), msqf.max()))
print("B-factor of most flexible residue: %.2f (residue %d)"
      % (bfac.max(), int(np.argmax(bfac)) + 1))

# Dynamic cross-correlation between the first and last residue
dcc = eanm.dcc()
print("DCC(first, last) = %.3f" % dcc[0, -1])

# Optional plot if matplotlib is available
try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(12, 3.2), dpi=150,
                             constrained_layout=True)
    axes[0].bar(np.arange(7, len(eigenval) + 1), eigenval[6:])
    axes[0].set(xlabel="Mode", ylabel="Eigenvalue")
    axes[1].bar(np.arange(1, len(msqf) + 1), msqf)
    axes[1].set(xlabel="Residue", ylabel="MSF")
    im = axes[2].imshow(dcc, cmap="coolwarm", vmin=-1, vmax=1)
    axes[2].set(xlabel="Residue", ylabel="Residue", title="DCC")
    fig.colorbar(im, ax=axes[2])
    fig.savefig("basic_nma.png")
    print("wrote basic_nma.png")
except ImportError:
    pass
