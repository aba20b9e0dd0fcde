"""
Rendered analysis gallery
=========================

Produces the standard ENM analysis figures as PNGs plus a normal-mode
animation trajectory, on the GPU through the PyTorch port (the
counterpart of ``examples/analysis_gallery.py`` and of the reference's
sphinx/PyMOL gallery: ``doc/scraper.py`` renders PyMOL scenes; here mode
animations are written as multi-model PDB for any molecular viewer, and
the 2D analyses are rendered directly):

* ``gallery_msf.png``       — MSF / B-factor profile per residue
* ``gallery_dcc.png``       — normalized dynamic cross-correlation map
* ``gallery_prs.png``       — perturbation-response scan + effector /
  sensor profiles
* ``gallery_spectrum.png``  — low-frequency spectrum
* ``gallery_mode7.pdb``     — lowest non-trivial mode animation
  (open in PyMOL/ChimeraX and play the trajectory)

Without matplotlib only the PDB trajectory is written.

Run:  python examples_torch/analysis_gallery.py [--device DEVICE] [path/to/structure.pdb]

``--device`` defaults to ``cuda``; pass ``--device cpu`` to run without
a GPU.
"""

import sys
from os.path import abspath, dirname, join

sys.path.insert(0, dirname(dirname(abspath(__file__))))  # in-repo run

import numpy as np

import springcraft_tpu_torch as sct
from springcraft_tpu_torch.structure import load_structure, write_pdb

argv = sys.argv[1:]
device = "cuda"
if argv[:1] == ["--device"]:
    device, argv = argv[1], argv[2:]

path = argv[0] if argv else join(
    dirname(dirname(abspath(__file__))), "tests", "data", "1l2y.pdb"
)

atoms = load_structure(path, model=1)
ca = atoms[(atoms.atom_name == "CA") & (atoms.element == "C")]
n = ca.array_length()
print(f"{n} CA atoms")

anm = sct.ANM(ca, sct.TabulatedForceField.e_anm(ca), masses=True,
              device=device)
msf = anm.mean_square_fluctuation()
bfac = anm.bfactor()
dcc = anm.dcc()
prs, effector, sensor = anm.prs_effector_sensor()
freq = anm.frequencies()

try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
except ImportError:
    print("matplotlib not available - skipping PNG rendering")
    plt = None

if plt is not None:
    res = np.asarray(ca.res_id)

    fig, ax1 = plt.subplots(figsize=(7, 3.2), constrained_layout=True)
    ax1.plot(res, msf, lw=1.6, color="tab:blue")
    ax1.set_xlabel("residue")
    ax1.set_ylabel("MSF", color="tab:blue")
    ax2 = ax1.twinx()
    ax2.plot(res, bfac, lw=1.0, ls="--", color="tab:red")
    ax2.set_ylabel("B-factor", color="tab:red")
    ax1.set_title("eANM mean-square fluctuations")
    fig.savefig("gallery_msf.png", dpi=150)

    fig, ax = plt.subplots(figsize=(4.6, 4), constrained_layout=True)
    im = ax.imshow(dcc, cmap="RdBu_r", vmin=-1, vmax=1, origin="lower")
    fig.colorbar(im, ax=ax, label="DCC")
    ax.set_xlabel("residue index")
    ax.set_ylabel("residue index")
    ax.set_title("Dynamic cross-correlation")
    fig.savefig("gallery_dcc.png", dpi=150)

    fig, axes = plt.subplots(1, 2, figsize=(8.6, 3.4),
                             constrained_layout=True,
                             gridspec_kw={"width_ratios": [1.1, 1]})
    im = axes[0].imshow(prs, cmap="viridis", origin="lower")
    fig.colorbar(im, ax=axes[0], label="response")
    axes[0].set_title("PRS matrix")
    axes[0].set_xlabel("sensor residue")
    axes[0].set_ylabel("perturbed residue")
    axes[1].plot(res, effector, label="effector")
    axes[1].plot(res, sensor, label="sensor")
    axes[1].set_xlabel("residue")
    axes[1].legend()
    axes[1].set_title("Effector / sensor profiles")
    fig.savefig("gallery_prs.png", dpi=150)

    fig, ax = plt.subplots(figsize=(5, 3), constrained_layout=True)
    k = min(30, len(freq) - 6)
    ax.bar(np.arange(6, 6 + k), freq[6:6 + k], color="tab:purple")
    ax.set_xlabel("mode index")
    ax.set_ylabel("frequency (arb. units)")
    ax.set_title("Low-frequency spectrum (trivial modes excluded)")
    fig.savefig("gallery_spectrum.png", dpi=150)

    print("wrote gallery_msf.png gallery_dcc.png gallery_prs.png "
          "gallery_spectrum.png")

# Mode animation: displacements along the lowest non-trivial mode
disp = anm.normal_mode(index=6, amplitude=4.0, frames=20)
frames = ca.coord[None, :, :] + np.asarray(disp)
write_pdb("gallery_mode7.pdb", ca, coord_models=frames)
print("wrote gallery_mode7.pdb (20-frame mode-7 animation)")

if plt is not None:
    # Rendered animation (the counterpart of the reference gallery's
    # PyMOL mode movie, doc/scraper.py): the CA trace oscillating along
    # the mode, colored by per-atom mode amplitude, saved as an animated
    # GIF via Pillow.
    from matplotlib.animation import FuncAnimation, PillowWriter

    amp = np.linalg.norm(np.asarray(disp), axis=2).max(axis=0)
    colors = plt.cm.viridis(amp / amp.max())
    center = frames.mean(axis=(0, 1))
    span = np.max(np.abs(frames - center)) * 1.05

    fig = plt.figure(figsize=(4.5, 4.5))
    ax3 = fig.add_subplot(projection="3d")
    ax3.set_axis_off()
    ax3.set_title("mode 7 (lowest non-trivial)", fontsize=10)

    def draw(f):
        ax3.cla()
        ax3.set_axis_off()
        c = frames[f] - center
        for i in range(n - 1):
            ax3.plot(c[i:i + 2, 0], c[i:i + 2, 1], c[i:i + 2, 2],
                     color=colors[i], lw=2.5)
        ax3.scatter(c[:, 0], c[:, 1], c[:, 2], c=amp, cmap="viridis",
                    s=14, depthshade=False)
        ax3.set_xlim(-span, span)
        ax3.set_ylim(-span, span)
        ax3.set_zlim(-span, span)
        ax3.view_init(elev=18, azim=35 + 0.8 * f)
        return []

    anim = FuncAnimation(fig, draw, frames=len(frames), blit=False)
    anim.save("gallery_mode_anim.gif",
              writer=PillowWriter(fps=10), dpi=80)
    plt.close(fig)
    print("wrote gallery_mode_anim.gif (rendered mode animation)")
