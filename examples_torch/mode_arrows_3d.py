"""
3D normal-mode scene
====================

The molecular counterpart of the reference's PyMOL gallery scene
(``doc/examples/scripts/normal_mode.py`` renders displacement arrows
on a cartoon with ammolite/PyMOL), computed on the GPU through the
PyTorch port (the counterpart of ``examples/mode_arrows_3d.py``) and
rendered headlessly with matplotlib's 3D axes —

* left panel: backbone trace with the lowest non-trivial ANM mode
  drawn as displacement arrows, colored by displacement magnitude;
* right panel: backbone colored and thickness-modulated by the
  mean-square fluctuation (the "B-factor putty" view).

Writes ``gallery_mode_arrows.png``; without matplotlib it computes the
mode and the fluctuations and stops before rendering.

Run:  python examples_torch/mode_arrows_3d.py [--device DEVICE] [path/to/structure.pdb [MODE]]

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

# The normal mode to visualize: 6 is the slowest one that is not a
# rigid-body translation/rotation.  Arrow lengths only mean anything
# relative to each other; AMPLITUDE sets the longest arrow in Angstrom.
MODE = int(argv[1]) if len(argv) > 1 else 6
AMPLITUDE = 10.0

path = argv[0] if argv else join(
    dirname(dirname(abspath(__file__))), "tests", "data", "7cal.pdb"
)

atoms = load_structure(path, model=1)
ca = atoms[(atoms.atom_name == "CA") & (atoms.element == "C")]
# First chain only — one connected backbone reads best as a trace
ca = ca[ca.chain_id == ca.chain_id[0]]
n = ca.array_length()
print(f"{n} CA atoms (chain {ca.chain_id[0]})")

anm = sct.ANM(ca, sct.InvariantForceField(13.0), device=device)
_, vectors = anm.eigen()
disp = np.asarray(vectors[MODE]).reshape(n, 3)
disp = disp / np.max(np.linalg.norm(disp, axis=1)) * AMPLITUDE
mag = np.linalg.norm(disp, axis=1)
msf = np.asarray(anm.mean_square_fluctuation())

try:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.cm import ScalarMappable
    from matplotlib.colors import Normalize
except ImportError:
    print("matplotlib not available - skipping PNG rendering")
    sys.exit(0)

xyz = np.asarray(ca.coord, np.float64)
BACKBONE = "#9aa3ad"          # neutral ink for geometry
SEQ = plt.get_cmap("Blues")   # one-hue sequential for magnitude


def _clipped(cmap, values, lo=0.35, hi=0.95):
    """Map values onto the readable middle of a sequential ramp (the
    light end vanishes on a white surface)."""
    norm = Normalize(vmin=float(values.min()), vmax=float(values.max()))
    return cmap(lo + (hi - lo) * norm(values)), norm


def _equal_aspect(ax, pts):
    center = (pts.max(axis=0) + pts.min(axis=0)) / 2
    half = float((pts.max(axis=0) - pts.min(axis=0)).max()) / 2 * 1.05
    ax.set_xlim(center[0] - half, center[0] + half)
    ax.set_ylim(center[1] - half, center[1] + half)
    ax.set_zlim(center[2] - half, center[2] + half)
    ax.set_box_aspect((1, 1, 1))
    ax.set_axis_off()


fig = plt.figure(figsize=(11, 5.6), constrained_layout=True)

# --- left: displacement arrows on the backbone trace ---------------
ax = fig.add_subplot(1, 2, 1, projection="3d")
ax.plot(*xyz.T, color=BACKBONE, lw=1.4, alpha=0.9, zorder=1)
colors, norm = _clipped(SEQ, mag)
step = max(1, n // 400)       # at most ~400 arrows keep the scene legible
sel = np.arange(0, n, step)
ax.quiver(*xyz[sel].T, *disp[sel].T, colors=colors[sel],
          length=1.0, arrow_length_ratio=0.25, lw=1.3, zorder=2)
_equal_aspect(ax, xyz)
ax.view_init(elev=18, azim=-60)
ax.set_title(f"ANM mode {MODE} displacement", fontsize=11)
sm = ScalarMappable(cmap=SEQ, norm=norm)
fig.colorbar(sm, ax=ax, shrink=0.6, pad=0.0,
             label="displacement (rel.)")

# --- right: MSF putty (color + width follow the fluctuation) -------
ax = fig.add_subplot(1, 2, 2, projection="3d")
seg_msf = (msf[:-1] + msf[1:]) / 2
colors, norm = _clipped(SEQ, seg_msf)
r = (seg_msf - seg_msf.min()) / np.ptp(seg_msf)
widths = 1.0 + 4.5 * r
for i in range(n - 1):       # per-segment color/width needs a loop
    ax.plot(*xyz[i:i + 2].T, color=colors[i], lw=widths[i],
            solid_capstyle="round")
_equal_aspect(ax, xyz)
ax.view_init(elev=18, azim=-60)
ax.set_title("mean-square fluctuation", fontsize=11)
sm = ScalarMappable(cmap=SEQ, norm=norm)
fig.colorbar(sm, ax=ax, shrink=0.6, pad=0.0, label="MSF (arb. units)")

fig.savefig("gallery_mode_arrows.png", dpi=150)
print("wrote gallery_mode_arrows.png")
