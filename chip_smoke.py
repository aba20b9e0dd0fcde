"""
Smoke run of the PyTorch/CUDA port (``springcraft_tpu_torch``) on one
NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases:

1. the card's name and power limit, as ``nvidia-smi`` prints them;
2. the build of every CUDA kernel from ``springcraft_tpu_torch/csrc``
   (into ``build/kernels/``, one ``nvcc`` per source, all at once), with
   the compiler's register and spill report;
3. each kernel against its plain PyTorch version on the same CUDA
   tensors, at the shapes its paths give it, timed with CUDA events (the
   two banded kernels on the band of the first chunk's Hessians, the
   bisection also on the single structure's band at its path's 40
   halvings, their slow plain versions timed over one call, and the
   bisection again at the paths' 40 halvings on the chunk's band, each
   bisection with its bound on the halvings this run's data needs and
   with every eigenvalue taking them all; the inverse iteration per call
   of four launches and per launch; the leaf panel inverse K3 on the
   chunk's first leaf (128, 64, 64) and on one panel, then on the largest
   leaf (128, 128, 128) and (1, 128, 128), bit for bit its plain version
   and K9, a non-SPD panel non-finite, timed by replaying a CUDA graph of
   20 calls (the host's enqueue time per call drops out) in turns with K9
   and ``torch.linalg.solve_triangular``, beside its time per eager call;
   the full-window panel inverse K9 at both sizes in turns with
   ``torch.linalg.solve_triangular``; the panel Cholesky K8 at the same
   four shapes, bit for bit its plain version (each output's SHA-256
   printed), a non-SPD panel non-finite, by graph replay in turns with
   K3 and ``torch.linalg.cholesky_ex``; K2 also on the sdENM chunk; K7
   (its row-sum pass and store pass together) under the invariant field
   and hinsen and on a chunk of 299 atoms, the row-sum pass alone against
   its plain version; the Kirchhoff kernel on the chunk and on the single
   structures (1776 atoms, eANM on 7cal) and the Hessian kernels K1 and K5
   on the chunk, on the single structures and at n % 4 != 0 (a chunk of
   299 atoms, one structure of 1777), timed by replaying a CUDA graph,
   beside their time per eager call; the pair-CSR build, whose rows and
   slots must equal its plain version's, and K13 / K14 over its list,
   timed in turns with ``torch.sparse.mm``);
4. the paths, each driven once from zero launch counts and required to
   have launched its own kernels (``PATH_KERNELS``), with finiteness
   checks and a float32 result held against the port's float64 engines
   on the card:

   * ``ensemble_anm_fluctuations`` plane traces (the main path) and
     with the covariance and PRS, over 1024 conformers of 300 residues
     in chunks of 128 (invariant force field, 13 A cutoff), first chunk
     against float64 ``cho_solve``;
   * ``ensemble_gnm_fluctuations`` at the same size;
   * ``anm_fluctuations`` (with PRS) and ``gnm_fluctuations`` on one
     structure of 1776 residues (the CA count of the repository's 7cal
     test structure) at protein density;
   * the spectral pipelines on the same conformers:
     ``ensemble_anm_spectral`` and ``ensemble_gnm_spectral`` (20 modes,
     32 halvings, as the JAX package's benchmark), ``ensemble_anm_banded``
     and ``ensemble_gnm_banded``, and ``anm_spectral`` / ``gnm_spectral``
     on the 1776-residue structure; eigenvalues against float64
     ``torch.linalg.eigh`` (``ensemble_anm``), covariance observables
     against float64 ``cho_solve``, eigenvectors and mode shapes through
     their residuals and orthonormality;
   * the matrix-free paths (``bench.py:656-868``): random atoms at protein
     density (seed 4), invariant field at 13 A, float32, each block-sparse
     solver building its pair CSR once (``pair_csr``) and gathering over
     it on every apply — ``lowest_modes_matfree`` (14 modes, degree 96, 10
     outer iterations, tol 2e-4; K13) at n = 30,000, twice;
     ``dcc_rows_matfree`` on 8 sites (24 CG columns) and
     ``linear_response_matfree`` on 4 forces (K13);
     ``lowest_modes_matfree_gnm`` (10 modes, tol 5e-4; K14) at 30,000; the
     cutoff-free ``pfenm`` family's ``lowest_modes_matfree`` (K12) at
     n = 10,000; each mode set through its float64 residuals and
     orthonormality, each CG solution through its float64 true residual,
     and at n = 3,000 the eigenvalues against float64
     ``torch.linalg.eigvalsh`` and the covariance columns against float64
     ``covariance_cholesky``; the peak device memory of each path;
   * the tabulated force fields: sdENM (26 distance bins, residue types
     drawn as the JAX package's benchmark draws them, one chain) over the
     same 1024 conformers — plane traces, covariance with PRS, GNM — each
     required to have taken its assembly kernel's table branch and held
     against float64 ``cho_solve``; eANM on the CA trace of
     ``tests/data/7cal.pdb`` (1776 residues) through ``anm_fluctuations``
     and ``gnm_fluctuations``, with the relative RMSE of the float32 MSF
     against the float64 engine (``bench.py:1229-1250`` fails above 1e-3;
     here above 2e-5: the single structures factor in float64);
   * the tabulated matrix-free paths: sdENM (26 bins, 16.5 A; three
     chains, so bonded, intra-chain and inter-chain pairs all occur) on
     the same random atoms — ``lowest_modes_matfree``,
     ``dcc_rows_matfree`` with ``linear_response_matfree`` and
     ``lowest_modes_matfree_gnm`` at n = 30,000 (the pair-CSR build
     through its table branch, K13, K14) and the dense grid
     (``sparse=False``, K12) at 10,000, with the float64 checks of the
     analytic paths through the plain float64 tabulated operators;
   * patch overlays (a ``PatchedForceField``: two atoms shut down and
     re-attached by switched-on pairs with their own constants, a few
     pairs off, a few on beyond the cutoff): around the invariant field
     through the three ensemble paths, around eANM on 7cal through
     ``anm_fluctuations``, ``gnm_fluctuations`` and ``gnm_spectral``, each
     against the float64 engine with the same overlay; and on the
     matrix-free paths at n = 3,000 (invariant and sdENM) against float64
     dense assembly;
   * the assembly kernels at large n: K1, K5 and K6 at n = 8,192
     against their plain versions (both families), and one
     ``hessian_xyz`` at n = 30,000 (32.4 GB) timed and held by ``H @ X``
     against K13 on the same coordinates;
   * ``prep="direct"`` of ``ensemble_anm_fluctuations`` (the
     coordinates-to-factor-input kernel, invariant field), plane traces
     and covariance, held against float64 ``cho_solve`` and against the
     planes path of the same call, with both rates in turns, and the two
     prep stages of a chunk beside each other in turns (direct: the
     row-sum pass, the stitch inputs and K7's store pass; planes: K1, the
     stitch inputs and K2);
   * the public panel functions ``panel_cholesky_batched``,
     ``panel_inverse_batched(shrink_block=None)`` and
     ``spd_inverse_blocked`` on a chunk's equilibrated factor input
     ``(128, 1024, 1024)``; then at the largest leaf,
     ``spd_inverse_factor_parts(block=128)`` and
     ``spd_inverse_blocked(block=128)`` (K3 at (128, 128, 128), eight
     leaves a call) and ``panel_inverse_batched`` (K9 by default) on the
     first 128-block, against float64 ``cho_solve``; and the leaf as a
     measurement, the factor at ``block=64`` and ``block=128`` in turns;
   * a structure's lowest modes by shift-invert and their float64
     refinement: 7cal's CA trace under eANM (K5 through its table branch,
     ``lowest_modes_anm`` with the ``"invfactor"`` engine, K3 at the
     inverse factor's leaves, ``refine_modes_f64``), its GNM twin (K6,
     ``lowest_modes_shift_invert``, ``refine_modes_f64_gnm``) and 8,192
     atoms under the invariant field (``"chol"``, the sparse refinement):
     24 modes, the 20 lowest held against float64 ``eigvalsh`` of the
     same matrix (1e-4 of max|lambda|, residuals, orthonormality) and,
     refined, to 1e-6 relative of the float64 matrix's; at 8,192 atoms
     the refined residuals to 1e-3; time per structure, first and second
     call;
   * the reference-compatible model API on 7cal's CA trace, float64 on
     the card (``model_api_paths``): ``ANM`` under eANM with residue
     masses and ``GNM`` under the invariant field at 7 A, every
     observable with its first and second call's time, the covariance's
     Moore-Penrose identities on probe blocks, ``lowest_modes(10,
     refine=True)`` (K3) and ``lowest_modes(10, matrix_free=True)``
     (K13 / K14) from zero launch counts against the dense spectrum,
     ``compute_hessian`` / ``compute_kirchhoff`` against the models'
     matrices, and the golden files of ``tests/test_anm.py`` (eANM
     against BioPhysConnectoR, bio3d's mass-weighted eigenvalues under
     three force fields) at that file's tolerances;
   * the mega-assembly north star (``bench.py::bench_mega_tpu``) after
     the matrix-free phases: 10,000 CA atoms under sdENM as the JAX
     benchmark draws them, the 30,000-dimensional float32 Hessian through
     ``pallas_kernels.hessian_pallas`` (K5, also held against its plain
     version there), 20 (+4) modes by ``lowest_modes_anm`` (``"chol"``)
     with ``mode_residuals`` and ``refine_modes_f64``, each stage timed
     on its first and second call beside the 10 s clause (printed, not
     asserted); the raw residuals, the mode-sum MSF and 64-row DCC block
     against the refined modes, and at 1,000 atoms the refined
     eigenvalues against float64 ``eigvalsh``; then the all-mode MSF at
     20,736 dimensions (``pinv_diagonal``, K5 at (1, 6912) held too)
     against the committed float64 golden
     ``tests/data/golden_mega_msf_20736.npz``;
   * the large-structure path after the xl phase
     (``large_structure_paths``): the 100,000 xl ANM atoms rounded to 3
     decimals as a CA trace of four chains of 25,000 residues (one chain
     "AA"), written as gzipped mmCIF and as BinaryCIF (the PDB encoder's
     codecs, this script's writers) and read back by ``load_structure``
     and ``load_ensemble`` to the written annotations and coordinates;
     from the BinaryCIF coordinates the xl ANM (K13) and GNM (K14) solves
     from zero launch counts: twice uninterrupted (bit for bit),
     checkpointed, interrupted after outer iteration 3 and resumed from
     the snapshot, retried through one injected device failure (ANM),
     each equal to the uninterrupted solve; ``save_results`` /
     ``load_results``; the staged shift-invert on 7cal's eANM Hessian
     interrupted and resumed; ``save_model`` / ``load_model`` of 7cal's
     GNM and chain A's eANM ANM, observables bit for bit, rebuilding
     refused without a force field; a normal-mode trajectory through
     ``write_pdb`` and ``load_ensemble``; the write, read, solve and
     snapshot seconds and bytes.

Then one JSON line with the kernels' numbers (each kernel's time beside
its bound — the larger of the bytes it must move over 3.35 TB/s and its
operations over 67 TFLOP/s in float32, 34 TFLOP/s in float64, counted on
this run's inputs — its plain version's time and, where one PyTorch call
computes the same function, that call's time), and last
``{"ok": true, "device": {...}}``.  Any failed check ends the run with
a traceback and a non-zero exit; without a CUDA device it stops before
building anything.
"""

import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time

N_CONFORMERS = 1024
N_RES = 300
CHUNK = 128
N_SINGLE = 1776
CUTOFF = 13.0
SEED = 3
#: CA atoms per cubic angstrom: 300 residues in a 34 A cube, the density
#: of the headline conformers; the larger random structures are drawn at
#: it (``bench.py:131``, in the same float64 expression).
CA_DENSITY = 300 / 34.0 ** 3
TIMING_REPS = 20
#: Replays of a CUDA graph of TIMING_REPS calls (``graph_ms``).
GRAPH_REPLAYS = 10

#: Kernel name -> (source, the TPU kernel(s) it replaces, tolerance of
#: max|kernel - plain| / max|plain| at its paths' shapes).
KERNELS = {
    "hessian_planes": (
        "springcraft_tpu_torch/csrc/hessian_planes.cu",
        "springcraft_tpu/ops/pallas_kernels.py:688", 1e-5),
    "regularize_stitch": (
        "springcraft_tpu_torch/csrc/regularize_stitch.cu",
        "springcraft_tpu/ops/pallas_kernels.py:1093", 1e-5),
    "panel_inverse": (
        "springcraft_tpu_torch/csrc/panel_inverse.cu",
        "springcraft_tpu/ops/pallas_linalg.py:142", 1e-4),
    "kirchhoff": (
        "springcraft_tpu_torch/csrc/kirchhoff.cu",
        "springcraft_tpu/ops/pallas_kernels.py:766, "
        "springcraft_tpu/ops/pallas_kernels.py:413", 1e-5),
    "hessian_xyz": (
        "springcraft_tpu_torch/csrc/hessian_planes.cu",
        "springcraft_tpu/ops/pallas_kernels.py:191", 1e-5),
    "banded_bisect": (
        "springcraft_tpu_torch/csrc/banded_bisect.cu",
        "springcraft_tpu/ops/spectrum.py:1132", 1e-5),
    # eigenvectors are free up to sign: held by residuals and overlaps
    # (EIGVEC_*), the tolerance here bounds the sign-aligned difference
    # on well-separated eigenvalues
    "banded_eigvec": (
        "springcraft_tpu_torch/csrc/banded_eigvec.cu",
        "springcraft_tpu/ops/spectrum.py:770", 1e-4),
}
KERNELS.update({
    "hessian_apply_dense": (
        "springcraft_tpu_torch/csrc/matfree_hessian.cu",
        "springcraft_tpu/ops/matfree.py:385", 1e-5),
    "hessian_apply_sparse": (
        "springcraft_tpu_torch/csrc/matfree_hessian.cu",
        "springcraft_tpu/ops/matfree.py:807", 1e-5),
    "kirchhoff_apply_sparse": (
        "springcraft_tpu_torch/csrc/matfree_kirchhoff.cu",
        "springcraft_tpu/ops/matfree.py:964", 1e-5),
})
#: Not a TPU kernel: the set-up of K13 and K14, the pair CSR they gather
#: over, built once per solver call.  Its tolerance bounds the constants
#: (relative); its rows and slots must equal the plain version's.
KERNELS["pair_csr"] = (
    "springcraft_tpu_torch/csrc/matfree_pairs.cu",
    "springcraft_tpu/ops/matfree.py:807, springcraft_tpu/ops/matfree.py:964",
    1e-6)
KERNELS.update({
    "assembly_stitch": (
        "springcraft_tpu_torch/csrc/assembly_stitch.cu",
        "springcraft_tpu/ops/pallas_kernels.py:1192", 1e-5),
    "panel_cholesky": (
        "springcraft_tpu_torch/csrc/panel_cholesky.cu",
        "springcraft_tpu/ops/pallas_linalg.py:58", 1e-4),
    "panel_inverse_full": (
        "springcraft_tpu_torch/csrc/panel_inverse.cu",
        "springcraft_tpu/ops/pallas_linalg.py:92", 1e-4),
})
#: Path -> the kernels it must launch.
PATH_KERNELS = {
    "anm_traces": ("hessian_planes", "regularize_stitch", "panel_inverse"),
    "anm_covariance": ("hessian_planes", "regularize_stitch",
                       "panel_inverse"),
    "gnm_ensemble": ("kirchhoff", "panel_inverse"),
    "anm_single": ("hessian_xyz",),
    "gnm_single": ("kirchhoff",),
    "anm_spectral_ensemble": ("hessian_xyz", "panel_inverse",
                              "banded_bisect"),
    "anm_banded_ensemble": ("hessian_xyz", "banded_bisect",
                            "banded_eigvec"),
    "gnm_spectral_ensemble": ("kirchhoff", "panel_inverse",
                              "banded_bisect"),
    "gnm_banded_ensemble": ("kirchhoff", "banded_bisect", "banded_eigvec"),
    "anm_spectral_single": ("hessian_xyz", "banded_bisect"),
    "gnm_spectral_single": ("kirchhoff", "banded_bisect"),
    # the block-sparse paths build the pair CSR, then gather over it
    "anm_matfree_modes": ("pair_csr", "hessian_apply_sparse"),
    "anm_matfree_solve": ("pair_csr", "hessian_apply_sparse"),
    "gnm_matfree_modes": ("pair_csr", "kirchhoff_apply_sparse"),
    "anm_matfree_modes_dense": ("hessian_apply_dense",),
    # tabulated families: the same kernels, through their table branch
    "anm_tabulated_traces": ("hessian_planes", "regularize_stitch",
                             "panel_inverse"),
    "anm_tabulated_covariance": ("hessian_planes", "regularize_stitch",
                                 "panel_inverse"),
    "gnm_tabulated": ("kirchhoff", "panel_inverse"),
    "anm_7cal_eanm": ("hessian_xyz",),
    "gnm_7cal_eanm": ("kirchhoff",),
    "anm_direct_traces": ("assembly_stitch", "panel_inverse"),
    "anm_direct_covariance": ("assembly_stitch", "panel_inverse"),
    "panel_functions": ("panel_cholesky", "panel_inverse_full",
                        "panel_inverse"),
    # tabulated matrix-free: the table branch of the pair-CSR build, K12
    "anm_matfree_modes_tabulated": ("pair_csr", "hessian_apply_sparse"),
    "anm_matfree_solve_tabulated": ("pair_csr", "hessian_apply_sparse"),
    "gnm_matfree_modes_tabulated": ("pair_csr", "kirchhoff_apply_sparse"),
    "anm_matfree_modes_dense_tabulated": ("hessian_apply_dense",),
    # patch overlays: the kernels on the base family, then the correction;
    # the blocked ANM engine takes dense Hessians (K5), not planes
    "anm_overlay_traces": ("hessian_xyz", "panel_inverse"),
    "anm_overlay_covariance": ("hessian_xyz", "panel_inverse"),
    "gnm_overlay": ("kirchhoff", "panel_inverse"),
    "anm_7cal_overlay": ("hessian_xyz",),
    "gnm_7cal_overlay": ("kirchhoff",),
    "gnm_spectral_7cal_overlay": ("kirchhoff", "banded_bisect"),
    "anm_matfree_overlay": ("pair_csr", "hessian_apply_sparse"),
    "anm_matfree_overlay_tabulated": ("pair_csr", "hessian_apply_sparse"),
    "gnm_matfree_overlay_tabulated": ("pair_csr", "kirchhoff_apply_sparse"),
    # single structures of 8,192 and 30,000 atoms
    "assembly_large": ("hessian_xyz", "kirchhoff", "hessian_planes"),
    # the blocked inverse at its largest leaf (block=128)
    "panel_functions_128": ("panel_inverse", "panel_inverse_full"),
    # a structure's lowest modes by shift-invert: K3 through the inverse
    # factor of "invfactor" (7cal), the chol engine at 8,192 atoms
    "anm_7cal_modes": ("hessian_xyz", "panel_inverse"),
    "gnm_7cal_modes": ("kirchhoff", "panel_inverse"),
    "anm_modes_8192": ("hessian_xyz",),
    # the second matrix-free slice at 30,000 atoms: the CG-based estimators
    # (one CG call each, the pair CSR once), the model-API routes on 7cal
    "anm_effector_sensor_sites": ("pair_csr", "hessian_apply_sparse"),
    "anm_prs_diag_stochastic": ("pair_csr", "hessian_apply_sparse"),
    "anm_effector_sensor_stochastic": ("pair_csr", "hessian_apply_sparse"),
    "anm_msf_stochastic": ("pair_csr", "hessian_apply_sparse"),
    "gnm_msf_stochastic": ("pair_csr", "kirchhoff_apply_sparse"),
    "model_anm_profiles": ("pair_csr", "hessian_apply_sparse"),
    "model_gnm_profiles": ("pair_csr", "kirchhoff_apply_sparse"),
    # matrix-free-xl: 100,000-atom ANM modes, 1,000,000-atom GNM modes
    "anm_matfree_xl": ("pair_csr", "hessian_apply_sparse"),
    "gnm_matfree_xl": ("pair_csr", "kirchhoff_apply_sparse"),
    # the model API: K3 through "invfactor", K13 / K14 over the pair CSR
    "model_anm_modes": ("panel_inverse",),
    "model_anm_modes_matfree": ("pair_csr", "hessian_apply_sparse"),
    "model_gnm_modes": ("panel_inverse",),
    "model_gnm_modes_matfree": ("pair_csr", "kirchhoff_apply_sparse"),
    # the mega-assembly north star through pallas_kernels.hessian_pallas
    "mega_north_star": ("hessian_xyz",),
    "mega_allmode_msf": ("hessian_xyz",),
    # the large structure read from BinaryCIF: the xl solves plain, again,
    # checkpointed, interrupted, resumed and retried
    **{f"anm_large_{run}": ("pair_csr", "hessian_apply_sparse")
       for run in ("plain", "repeat", "checkpointed", "interrupted",
                   "resumed", "retried")},
    **{f"gnm_large_{run}": ("pair_csr", "kirchhoff_apply_sparse")
       for run in ("plain", "repeat", "interrupted", "resumed")},
}
#: The multi-device phase (``multi_device_paths``) runs each path on two
#: meshes: every card (one on a one-card machine) and four entries over
#: cuda:0 with the row axis 2.  Its paths' kernels: the headline under
#: sharding (K1-K3), the all-mode MSF by the blocked Cholesky (plain
#: torch, as the JAX package is plain XLA there), the Chebyshev solve
#: over K12 row ranges, and the dryrun's 14 blocks
#: (``__graft_entry__.py:95-288``).
MESHES = ("cards", "cuda0x4")
DRYRUN_KERNELS = {
    "1": ("hessian_xyz",), "2": ("hessian_xyz",), "2b": ("hessian_xyz",),
    "3": (), "4": (), "5": ("hessian_apply_dense",),
    "6": ("hessian_apply_dense",), "6b": ("hessian_apply_dense",),
    "6c": ("hessian_apply_dense",),
    "7": ("hessian_xyz", "banded_bisect", "banded_eigvec"),
    "8": ("hessian_planes", "regularize_stitch", "panel_inverse"),
    "8b": ("hessian_planes", "regularize_stitch", "panel_inverse"),
    "8c": ("hessian_xyz",), "9": ()}
PATH_KERNELS.update({
    f"{path}@{mesh}": kernels for mesh in MESHES
    for path, kernels in (
        ("sharded_headline", ("hessian_planes", "regularize_stitch",
                              "panel_inverse")),
        ("sharded_allmode_msf", ()),
        ("sharded_matfree_modes", ("hessian_apply_dense",)),
        *((f"dryrun_{block}", kernels)
          for block, kernels in DRYRUN_KERNELS.items()))})
#: The wrappers that also count their table branch.
TABLE_KERNELS = ("hessian_planes", "hessian_xyz", "kirchhoff",
                 "hessian_apply_dense", "pair_csr")
#: Paths whose kernels must all go through their table branch.
TABLE_PATHS = ("anm_tabulated_traces", "anm_tabulated_covariance",
               "gnm_tabulated", "anm_7cal_eanm", "gnm_7cal_eanm",
               "anm_matfree_modes_tabulated", "anm_matfree_solve_tabulated",
               "gnm_matfree_modes_tabulated",
               "anm_matfree_modes_dense_tabulated", "anm_7cal_overlay",
               "gnm_7cal_overlay", "gnm_spectral_7cal_overlay",
               "anm_matfree_overlay_tabulated",
               "gnm_matfree_overlay_tabulated", "anm_7cal_modes",
               "gnm_7cal_modes", "model_anm_modes_matfree",
               "model_anm_profiles", "mega_north_star", "mega_allmode_msf",
               *(f"dryrun_8c@{mesh}" for mesh in MESHES))
#: Paths that mix both branches (each family is launched once).
MIXED_PATHS = ("assembly_large",)
#: The float32 MSF of 7cal under eANM against the float64 engine, relative
#: RMSE (bench.py:1243-1250 fails above 1e-3 and expects about 1e-5).  The
#: single-structure entry points factor and solve in float64 behind the
#: float32 assembly, which leaves 1.0e-6 on the H100 (the all-float32
#: ``torch.linalg.cholesky_ex`` left 1.7e-4, the blocked engine 7.4e-5:
#: ``tools/single_structure_precision.py``); the bound is the 2e-5 the
#: float32 path is asked to keep.
MSF_RMSE_TOL = 2e-5
#: Outputs of the 7cal paths, max|x - ref| / max|ref|: measured 1.8e-6
#: (MSF), 3.9e-6 (covariance), 8.3e-6 (PRS) and 1.04e-5 (sensor profile,
#: the largest), all of it the float32 assembly; five times the largest.
REAL_STRUCTURE_TOL = 5e-5
#: Residue names in the order the JAX package's benchmark draws them
#: (bench.py:176-179).
AA20 = ("ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
        "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL")
#: The matrix-free section of the JAX package's benchmark
#: (bench.py:656-705): atoms at protein density, seed 4, invariant 13 A;
#: 14 modes (10 wanted + 4 buffer), degree 96, 10 outer iterations.
N_MATFREE = 30_000
#: The cutoff-free operator is O(n^2) per apply: its path runs at 10,000
#: atoms (30,000 dimensions; the dense float32 Hessian would be 3.6 GB).
N_MATFREE_DENSE = 10_000
#: The float64 anchor: small enough for a dense float64 eigh.
N_ANCHOR = 3_000
#: One large structure for the assembly kernels (past the 4,096 atoms up
#: to which they once staged a whole conformer in shared memory).
N_LARGE = 8_192
MATFREE_SEED = 4
MATFREE_CUTOFF = 13.0
MATFREE_MODES, MATFREE_WANTED, MATFREE_TOL = 14, 10, 2e-4
#: The tabulated (sdENM) mode paths.  At 30,000 random atoms sdENM's
#: Gershgorin bound is 5480 (bonded constant 1085) over a lowest eigenvalue
#: of 0.07, against 206 over 0.9 for the invariant field: float32 leaves a
#: relative residual |H u - lambda u| / lambda of about eps * 5480 / 0.07 =
#: 4.7e-3, where the measured residuals stall (3.3e-3 to 3.5e-3 after 20, 30
#: iterations or at degree 192; 4.7e-2 after 10).  So these paths run up to
#: 20 outer iterations to that floor; their eigenvalues are held to 1e-4 of
#: float64 at the 3,000-atom anchor like the others.
TABULATED_OUTER = 20
TABULATED_TOL = 5e-3
GNM_MATFREE_MODES, GNM_MATFREE_TOL = 10, 5e-4
#: Columns of X in the kernels' parity checks: the Chebyshev block of both
#: mode paths, k + max(k, 8, 48 - k) = 48.
MATFREE_BLOCK = 48
#: Float64 relative residuals |M u - lambda u| / lambda and |U U^T - I| of
#: the returned float32 modes; the CG solutions' float64 true residual
#: |H x - P b| / |P b| (tol 1e-6 on the float32 recurrence).
MATFREE_RESIDUAL_TOL = 1e-3
MATFREE_ORTHO_TOL = 1e-3
CG_TRUE_RESIDUAL_TOL = 1e-3
#: The anchor: eigenvalues relative to float64 eigvalsh, covariance columns
#: within this of max|ref|.
ANCHOR_RTOL = 1e-4
#: The second half of the JAX package's matrix-free benchmark
#: (bench.py:726-868) at N_MATFREE: 42 sites (126 CG columns), 48 probes,
#: the stochastic prs_diag on seed 17, the profiles on 11, the MSF on 13;
#: the MSF truth at 8 of the sites.  A stochastic estimate lies within
#: STDERR_BOUND of its standard errors of the exact value it estimates, or
#: on its exact rank-k floor (tests/test_matfree.py:1144-1145).
PROFILE_SITES, PROFILE_PROBES = 42, 48
PROFILE_SEEDS = {"prs_diag": 17, "profiles": 11, "msf": 13}
STDERR_BOUND = 6
#: The model-API routes on 7cal against the dense float64 model: the
#: float32 CG stops at a relative residual of 1e-6, and its outputs are
#: held as the card tests hold the CG rows (1e-3 of max|x|); a
#: stochastic MSF within STDERR_BOUND standard errors plus this of max.
MODEL_PROFILE_TOL = 1e-3
#: matrix-free-xl (bench.py:871-925): one RandomState(7) draws the
#: 100,000-atom ANM and then the 1,000,000-atom GNM at CA density,
#: invariant 13 A; 10 (+4) ANM modes after 8 outer iterations, 6 (+4) GNM
#: modes after 6, degree 96, tol 5e-4, retries=0 (the JAX bench's
#: retries=1 guards its remote TPU; large_structure_paths retries).
XL_SEED = 7
N_XL_ANM, N_XL_GNM = 100_000, 1_000_000
XL_ANM_MODES, XL_ANM_WANTED, XL_ANM_OUTER = 14, 10, 8
XL_GNM_MODES, XL_GNM_WANTED, XL_GNM_OUTER = 10, 6, 6
XL_TOL = 5e-4
#: The refined float64 residual |M v - theta v| / theta of each wanted xl
#: mode may not exceed the larger of XL_RESIDUAL_GROWTH times the residual
#: the float32 solve reported for it and REFINED_RESIDUAL_FLOORS float32
#: rounding floors eps_f32 * lambda_max / theta (lambda_max the solver's
#: Gershgorin bound), nor XL_RESIDUAL_CAP.  One float64 Rayleigh-Ritz pass
#: over the float32 basis takes the rounding out of the eigenvalue but
#: leaves the basis's own error in the residual, first order: at best the
#: floor (as for the model API's refined modes), at worst the unconverged
#: part the float32 solve reported; 2 allows for the mixing of buffer
#: modes, and the cap for nothing else.
XL_RESIDUAL_GROWTH = 2.0
XL_RESIDUAL_CAP = 1e-2
#: The mega-assembly north star (``bench.py::bench_mega_tpu``,
#: BASELINE.json config 5): ``make_ca_atoms(10_000, seed=2)`` under
#: sdENM, a 30,000-dimensional float32 Hessian, N_MODES (+MODE_BUFFER)
#: lowest modes, their float64 refinement; the proof on
#: ``make_ca_atoms(1000, seed=3)`` against float64 ``eigvalsh``; the
#: all-mode MSF at 20,736 dimensions against the committed float64 golden.
N_MEGA, MEGA_SEED = 10_000, 2
N_PROOF, PROOF_SEED = 1000, 3
#: The north star's time clause over build, modes (with their residuals)
#: and refinement, s, second call (printed as ok / over, not asserted).
MEGA_CLAUSE_S = 10.0
#: Mode-sum MSF (relative RMSE) and the first MEGA_DCC_SITES rows of the
#: DCC (max abs) of the raw float32 modes against the refined ones
#: (``bench.py:523-565``), and the all-mode MSF against the golden
#: (relative RMSE).
MEGA_MSF_TOL = 1e-3
MEGA_DCC_TOL = 1e-2
MEGA_DCC_SITES = 64
MEGA_ALLMODE_TOL = 1e-3
#: ``pinv_diagonal``'s identity columns per solve (``bench.py:640``).
MEGA_BLOCK = 1296
GOLDEN_MSF = os.path.join("tests", "data", "golden_mega_msf_20736.npz")
#: The blocked Cholesky's panel at 20,736 dimensions: the JAX default 1024
#: does not divide it, 768 does (27 panels).
SHARDED_BLOCK = 768
#: The sharded all-mode MSF against ``pinv_diagonal``'s on the same input
#: (relative RMSE), the sharded headline against the unsharded call
#: (max|x - ref| / max|ref|; bit for bit expected: each shard runs the
#: unsharded call's chunks).
SHARDED_ALLMODE_TOL = 1e-4
SHARDED_HEADLINE_TOL = 1e-6
#: K12 over the row range of the second of four row shards at n = 10,000:
#: a start that is no multiple of the kernel's 32-row blocks.
K12_ROW_RANGE = (2500, 2500)
#: One H100 SXM (from NVIDIA's data sheet):
#: HBM bytes/s, float32 FLOP/s outside the tensor cores; float64 FLOP/s
#: outside the tensor cores from the same data sheet.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12
#: Where the matrix-free phases put their tensors.
DEVICE = "cuda"
#: Spectral settings of the JAX package's benchmark (bench.py:328-331).
N_MODES = 20
#: Modes solved past the N_MODES held by the mode paths, as the JAX
#: package's ``ANM.lowest_modes(refine=True)`` pads its solve: the last
#: modes of a subspace converge slowest.
MODE_BUFFER = 4
#: Refined float64 eigenvalues against float64 ``eigh``, relative: the
#: north-star rtol of BASELINE.md.
REFINED_RTOL = 1e-6
#: The model API's refined modes: residuals |H u - theta u| / theta within
#: this many times eps_f32 max|lambda| / theta, the rounding floor of the
#: float32 basis they are refined from (one Rayleigh-Ritz pass keeps it in
#: the residual, first order, and takes it out of the eigenvalue, second
#: order).
REFINED_RESIDUAL_FLOORS = 10
N_ITER_BISECT = 32
#: Halvings at which K10 is held against its plain version on the single
#: structure's band (1, 9, 5328): the path's 40, the shared tree of its
#: first 12, nine rounds of three halvings, a partial round of one and the
#: early stop.  (Until the model-API phase needed the room, also 8, all
#: from the tree, a depth no path runs: 8.8 s of plain bisection.)
SINGLE_PARITY_HALVINGS = (40,)
#: Subspace iterations of the GNM mode shapes.  The benchmark has no GNM
#: spectral setting, and the default 16 leaves the 20th Kirchhoff mode at
#: N=300 with a residual of 1.9e-3 ||K|| even in float64 (its lowest
#: spectrum is flatter than the Hessian's); 32 reach 3e-5.
GNM_ITER_MODES = 32
#: Path outputs against the float64 reference: max|x - ref| / max|ref|,
#: the bound the JAX package holds its float32 Pallas path to.
SLICE_TOL = 1e-4
#: The synthetic single structure's covariance and PRS outputs.  Measured
#: on the H100: at most 3.9e-7 from ``anm_fluctuations`` / ``gnm_fluctuations``
#: (float64 factor behind the float32 assembly) and 9.9e-6 from the spectral
#: entry points (float32 Cholesky), so they keep SLICE_TOL like every other
#: output (1e-3 while the fluctuation entry points factored in float32).
SINGLE_COV_TOL = SLICE_TOL
#: Eigenvectors and mode shapes: ||H u - lambda u|| / ||H||_2 and
#: max |U U^T - I|, the JAX package's own float32 bounds
#: (tests/test_ops.py:561-574).
RESIDUAL_TOL = 5e-4
ORTHO_TOL = 1e-3
#: K11 against its plain version: median band-space residual over ||B||
#: (tests/test_ops.py:577-604), the kernel's largest residual (every
#: column of both routes measured below 1e-4 ||B|| on the H100), and
#: |u_kernel . u_plain| on every eigenvalue whose gaps to both neighbours
#: exceed EIGVEC_GAP of the spectrum's span: inside a cluster any two
#: roundings may return different vectors.
EIGVEC_RESIDUAL_TOL = 1e-3
EIGVEC_MAX_RESIDUAL = 1e-4
EIGVEC_OVERLAP_TOL = 1e-3
EIGVEC_GAP = 1e-3


def check(cond, message):
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {message}")


def make_conformers(n_conf, n_res, seed):
    """Conformer ensemble of the repository's headline benchmark: one
    random blob at the density of 300 residues in a 34 A cube, jittered
    by 0.05 A."""
    import numpy as np

    rng = np.random.RandomState(seed)
    spread = 34.0 * (n_res / 300) ** (1 / 3)
    base = (rng.rand(n_res, 3) * spread).astype(np.float32)
    return base[None] + 0.05 * rng.randn(n_conf, n_res, 3).astype(
        np.float32)


def make_ca_atoms(n, seed=0, chains=1, coord=None):
    """Synthetic all-CA structure with a random sequence at protein
    density, as the JAX package's benchmark makes the input of its
    tabulated force fields (``bench.py:183-198``): the coordinates are
    drawn first (`coord` replaces them), then the residue types.
    `chains` equal runs of the array are chains A, B, ...: neighbours in
    the array are bonded within a chain and not across two."""
    import numpy as np

    from springcraft_tpu_torch.structure import AtomArray

    rng = np.random.RandomState(seed)
    atoms = AtomArray(n)
    atoms.coord = (rng.rand(n, 3) * (n / CA_DENSITY) ** (1 / 3)).astype(
        np.float32)
    if coord is not None:
        atoms.coord = coord
    atoms.atom_name = np.full(n, "CA")
    atoms.element = np.full(n, "C")
    atoms.chain_id = np.array(list("ABCDEFGH"))[
        np.arange(n) * chains // n]
    atoms.res_id = np.arange(1, n + 1)
    atoms.res_name = np.array(AA20)[rng.randint(0, 20, n)]
    return atoms


def load_7cal_ca():
    """The CA trace of the repository's 7cal test structure."""
    from springcraft_tpu_torch.structure import load_structure

    atoms = load_structure(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests", "data",
        "7cal.pdb"), model=1)
    return atoms[(atoms.atom_name == "CA") & (atoms.element == "C")]


def cuda_ms(fn, reps=TIMING_REPS):
    """Mean device time of `fn` in milliseconds over `reps` calls, after
    one warm-up call, from CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, calls=TIMING_REPS, replays=GRAPH_REPLAYS):
    """Device time of one call of `fn` in milliseconds: a CUDA graph of
    `calls` back-to-back calls, captured after a warm-up call on the
    capture's side stream and replayed `replays` times between CUDA
    events.  The host's time to enqueue a call (a wrapper's checks, the
    ``ctypes`` call) drops out, which eager calls timed with events keep
    once it exceeds the kernel's time."""
    import torch

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (calls * replays)
    del graph
    return ms


def timed_once(fn):
    """``(fn(), device ms)`` of one call, from CUDA events: for the plain
    versions whose Python loops take seconds."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def max_errors(got, ref):
    diff = float((got.double() - ref.double()).abs().max())
    return diff, diff / float(ref.double().abs().max())


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def build_kernels():
    import re

    from springcraft_tpu_torch import _build

    t0 = time.perf_counter()
    _build.load()
    seconds = time.perf_counter() - t0
    # ptxas -v: per kernel, its name, then its spills, then its registers;
    # a template's arguments (a window width; 1 for a table branch, a tiled
    # or a dense-grid instance) follow its name
    report, name, spills = [], "?", ""
    for line in (_build.build_log() or "").splitlines():
        found = re.search(
            r"entry function .*?([a-z_]+_kernel)((?:I|L[ib]\d+E)*)", line)
        if found:
            args = re.findall(r"L[ib](\d+)E", found.group(2))
            name = found.group(1) + (f"<{', '.join(args)}>" if args else "")
        elif "spill stores" in line:
            spills = line.strip()
        elif "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            report.append(f"{name} {regs.group(1) if regs else '?'} "
                          f"registers, {spills}")
    print(f"build: {_build.library_path().name} in {seconds:.1f} s; "
          + " | ".join(report), flush=True)


def bound(nbytes, flops, rate=F32_FLOPS):
    """``(ms, "bytes" or "operations")``: the least time of a function
    that moves `nbytes` (each input read once, each output written once)
    and does `flops` at `rate`."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / rate * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                          "operations")


def entry(shape, err, ms, plain_ms, work, library_ms=None):
    """One parity record: shape, errors, times, the bound of `work`
    ``(bytes, flops[, rate])``."""
    bound_ms, bound_by = bound(*work)
    return {"shape": list(shape), "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def record(results, name, kernel_fn, plain_fn, work, library_fn=None,
           reps=TIMING_REPS, plain_reps=TIMING_REPS, label="", turns=False,
           graph=False):
    """Hold `kernel_fn` against `plain_fn` on the same CUDA tensors, time
    both (and `library_fn`, one PyTorch call of the same function) with
    CUDA events, and append the record to ``results[name]``; returns the
    plain output.  With `turns` the kernel and the library call are timed
    in turns (kernel, library, library, kernel) and their means kept.
    With `graph` the kernel's ``ms`` is its time by graph replay
    (``graph_ms``: a call too short for its host's enqueue time) and its
    CUDA-event time per eager call is ``event_ms``."""
    import torch

    got, ref = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    err, rel = max_errors(got, ref)
    check(rel <= KERNELS[name][2],
          f"{name}: max rel err {rel:.3e} > {KERNELS[name][2]:g}")
    plain_ms = cuda_ms(plain_fn, plain_reps)
    turn = ""
    if turns:
        k1, l1, l2, k2 = (cuda_ms(fn, reps) for fn in (
            kernel_fn, library_fn, library_fn, kernel_fn))
        ms, library_ms = (k1 + k2) / 2, (l1 + l2) / 2
        turn = (f" (in turns: kernel {k1:.4f}, library {l1:.4f}, library "
                f"{l2:.4f}, kernel {k2:.4f} ms)")
    else:
        ms = cuda_ms(kernel_fn, reps)
        library_ms = None if library_fn is None else cuda_ms(library_fn,
                                                             reps)
    if graph:
        event_ms, ms = ms, graph_ms(kernel_fn)
        turn += f" (graph replay; {event_ms:.4f} ms per eager call)"
    rec = entry(got.shape, err, ms, plain_ms, work, library_ms)
    if graph:
        rec["event_ms"] = event_ms
    print(f"parity {name} {tuple(got.shape)}{label}: max abs err {err:.3e}, "
          f"max rel err {rel:.3e} (tol {KERNELS[name][2]:g}); kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
          f"{rec['bound_ms'] / ms:.1%} of it), library "
          + ("none" if library_ms is None else f"{library_ms:.4f} ms")
          + turn, flush=True)
    results.setdefault(name, []).append(rec)
    return ref


def stitch_parity(results, coords, params, label):
    """K7, its row-sum pass and its store pass in one call, against its
    plain version (the plain planes through the plain stitch) on a chunk,
    with the scale and basis its path computes; the bound is the one
    write of ``reg`` plus the small inputs.  The row-sum pass alone
    against its plain version is printed beside it."""
    from springcraft_tpu_torch.ops import assembly_kernels, rigid, spd_linalg

    batch, n = coords.shape[:2]
    m = 3 * n
    mp = spd_linalg.padded_size(m)
    _, _, scale_h, ts = rigid._stitch_inputs_from_diag(
        rigid._hessian_diag_xyz_batched(coords, params),
        rigid.rigid_modes_anm(coords), None)
    got = assembly_kernels.assembly_row_sums(coords, params)
    err, rel = max_errors(got, assembly_kernels.assembly_row_sums_plain(
        coords, params))
    check(rel <= KERNELS["assembly_stitch"][2],
          f"assembly_stitch row-sum pass{label}: max rel err {rel:.3e}")
    ms = cuda_ms(lambda: assembly_kernels.assembly_row_sums(coords, params))
    print(f"parity assembly_stitch row-sum pass {tuple(got.shape)}{label}: "
          f"max abs err {err:.3e}, max rel err {rel:.3e} (tol "
          f"{KERNELS['assembly_stitch'][2]:g}); {ms:.4f} ms", flush=True)
    record(results, "assembly_stitch",
           lambda: assembly_kernels.assembly_stitch(
               coords, params, scale_h, ts, mp,
               assembly_kernels.assembly_row_sums(coords, params)),
           lambda: assembly_kernels.assembly_stitch_plain(coords, params,
                                                          scale_h, ts, mp),
           (4 * (3 * batch * n + 7 * batch * m + batch * mp * mp),
            45 * batch * m * m), label=label)


def table_parity(results, coords, sd_enm, ca_7cal, e_anm):
    """The table branch of the three assembly kernels against its plain
    version (a gather): sdENM on a ``(128, 300)`` chunk, eANM on 7cal's CA
    trace ``(1, 1776)``.  The branch writes what the analytic one writes,
    so the bounds are the same bytes; it also reads the tables (at most
    125 KB) and 4 bytes of codes per atom."""
    from springcraft_tpu_torch.ops import assembly, assembly_kernels, rigid
    from springcraft_tpu_torch.ops import spd_linalg

    def nbytes(b, n, per_pair, p):
        tables = 4 * (p.n_bins * 1200 + len(p.edges_sq or ()) + n)
        return 4 * (3 * b * n + per_pair * b * n * n) + tables

    for c, p, label in ((coords, sd_enm, " sdENM"),
                        (ca_7cal, e_anm, " eANM on 7cal")):
        b, n = c.shape[:2]
        if b > 1:
            record(results, "hessian_planes",
                   lambda: assembly_kernels.hessian_planes_ensemble(c, p),
                   lambda: assembly.hessian_planes_plain(c, p),
                   (nbytes(b, n, 9, p), 30 * b * n * n), label=label,
                   graph=True)
        record(results, "hessian_xyz",
               lambda: assembly_kernels.hessian_xyz_ensemble(c, p),
               lambda: assembly.hessian_xyz_plain(c, p),
               (nbytes(b, n, 9, p), 30 * b * n * n), label=label,
               graph=True)
        record(results, "kirchhoff",
               lambda: assembly_kernels.kirchhoff_ensemble(c, p),
               lambda: assembly.kirchhoff_plain(c, p),
               (nbytes(b, n, 1, p), 10 * b * n * n), label=label,
               graph=True)
    # K2 on the sdENM chunk's planes: the same shape and bytes as the
    # invariant chunk's
    b, n = coords.shape[:2]
    m, mp = 3 * n, spd_linalg.padded_size(3 * n)
    planes = assembly_kernels.hessian_planes_ensemble(coords, sd_enm)
    _, _, scale_h, ts = rigid.stitch_inputs(planes,
                                            rigid.rigid_modes_anm(coords))
    record(results, "regularize_stitch",
           lambda: assembly_kernels.regularize_stitch(planes, scale_h, ts,
                                                      mp),
           lambda: assembly_kernels.regularize_stitch_plain(planes, scale_h,
                                                            ts, mp),
           (4 * (9 * b * n * n + 7 * b * m + b * mp * mp), 14 * b * m * m),
           label=" sdENM")


def panel_parity(results, kernels, plain, library_of, shapes, flops,
                 eager=None):
    """Panel kernels on each of `shapes` ``(batch, pb, pb)``.  `kernels`
    maps a name to ``(fn(p), held)``: the first is the kernel recorded,
    and each `held` one must give a non-finite output in a non-SPD panel
    alone (on every batched shape) and equal `plain(p)` bit for bit (the
    recorded output's SHA-256 printed).  At each shape the kernels and
    the library call ``library_of(p)()`` are timed by graph replay
    (``graph_ms``) in turns, first to last and back; the record's ``ms``
    and ``library_ms`` are their means, ``event_ms`` the kernel's
    CUDA-event time per eager call, ``plain_ms`` the plain version's.
    `flops(batch, pb)` counts the operations of the bound; `eager` maps
    more record keys to ``fn(p)`` timed per eager call."""
    import hashlib

    import torch

    first = next(iter(kernels))
    held = [name for name, (_, hold) in kernels.items() if hold]
    for p in shapes:
        batch, pb = p.shape[:2]
        if batch > 1:
            bad = p.clone()
            bad[1, 5, 5] = -1.0
            for name in held:
                out = kernels[name][0](bad)
                check(not bool(torch.isfinite(out[1]).all())
                      and bool(torch.isfinite(out[0]).all()),
                      f"{name} {tuple(bad.shape)} on a non-SPD panel: not "
                      f"a non-finite output in that panel alone")
            print(f"parity {', '.join(held)} {tuple(bad.shape)}: a non-SPD "
                  f"panel gives a non-finite output", flush=True)
            del bad, out
        fns = {name: (lambda p=p, fn=fn: fn(p))
               for name, (fn, _) in kernels.items()}
        fns["library"] = library_of(p)
        ref = plain(p)
        plain_ms = cuda_ms(lambda p=p: plain(p))
        got = fns[first]()
        torch.cuda.synchronize()
        check(all(torch.equal(fns[name](), ref) for name in held),
              f"{' or '.join(held)} {tuple(p.shape)} differs from the plain "
              f"version in some bit")
        sha = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
        turns = {name: [] for name in fns}
        for name in list(fns) + list(reversed(list(fns))):
            turns[name].append(graph_ms(fns[name]))
        rec = entry(got.shape, max_errors(got, ref)[0],
                    sum(turns[first]) / 2, plain_ms,
                    (4 * 2 * batch * pb * pb, flops(batch, pb)),
                    sum(turns["library"]) / 2)
        rec["event_ms"] = cuda_ms(fns[first])
        for key, fn in (eager or {}).items():
            rec[key] = cuda_ms(lambda p=p, fn=fn: fn(p))
        rec["graph_turns"] = turns
        rec["sha256"] = sha
        results.setdefault(first, []).append(rec)
        print(f"parity {first} {tuple(got.shape)}: {', '.join(held)} bit "
              f"for bit, sha256 {sha[:16]}; kernel {rec['ms']:.4f} ms by "
              f"graph replay ({rec['ms'] * 1e3 / pb:.3f} us a step; "
              f"{rec['event_ms']:.4f} ms per eager call, CUDA events), plain "
              f"{plain_ms:.4f} ms, bound {rec['bound_ms']:.6f} ms "
              f"({rec['bound_by']}), library {rec['library_ms']:.4f} ms by "
              f"graph replay"
              + "".join(f", {key} {rec[key]:.4f} ms" for key in eager or {})
              + "; in turns by graph replay: "
              + "; ".join(f"{name} " + ", ".join(f"{t:.4f}" for t in times)
                          for name, times in turns.items()), flush=True)
        del got, ref


def panel_kernels_parity(results, panels, largest):
    """K3, K9 and K8 on the first leaf `panels` of a chunk's factor input
    ``(128, 64, 64)`` and on its first panel (the single structure's
    leaf), then on the largest leaf `largest` ``(128, 128, 128)`` and its
    first panel (:func:`panel_parity`).  K3 is held with K9 and timed with
    K9 and ``torch.linalg.solve_triangular`` of the panels' Cholesky
    factor (factor excluded); K8 is timed with K3 and
    ``torch.linalg.cholesky_ex`` (``torch.linalg.cholesky`` reads its
    error code on the host and cannot be captured: its eager time is
    ``cholesky_event_ms``).  K9's own record keeps CUDA events in turns
    with the library call."""
    import torch

    from springcraft_tpu_torch.ops import spd_linalg

    def k3(p):
        return spd_linalg.panel_inverse_batched(p, shrink_block=8)

    def solve_triangular(p):
        factor = torch.linalg.cholesky(p)
        eye = torch.eye(p.shape[-1], device=p.device).expand_as(factor)
        return lambda: torch.linalg.solve_triangular(factor, eye,
                                                     upper=False)

    shapes = (panels, panels[:1].contiguous(), largest,
              largest[:1].contiguous())
    panel_parity(results, {"panel_inverse": (k3, True),
                           "panel_inverse_full": (
                               spd_linalg.panel_inverse_full, True)},
                 spd_linalg.panel_inverse_plain, solve_triangular, shapes,
                 lambda batch, pb: batch * 2 * pb ** 3 / 3)
    for p in (panels, largest):
        batch, pb = p.shape[:2]
        record(results, "panel_inverse_full",
               lambda p=p: spd_linalg.panel_inverse_full(p),
               lambda p=p: spd_linalg.panel_inverse_plain(p),
               (4 * 2 * batch * pb * pb, batch * 2 * pb ** 3 / 3),
               solve_triangular(p), turns=True)
    panel_parity(results, {"panel_cholesky": (spd_linalg.panel_cholesky,
                                              True),
                           "panel_inverse": (k3, False)},
                 spd_linalg.panel_cholesky_plain,
                 lambda p: lambda: torch.linalg.cholesky_ex(p), shapes,
                 lambda batch, pb: batch * pb ** 3 / 3,
                 eager={"cholesky_event_ms": torch.linalg.cholesky})


def kernel_parity(coords, single, params):
    """Each kernel against its plain version at its paths' shapes
    (`coords` a ``(128, 300)`` chunk, `single` a ``(1, 1776)``
    structure); returns ``{name: [record, ...]}``, the first record being
    the one the JSON line reports.  The bounds count 4-byte floats; the
    assembly's operations (about 30 flops a pair for the Hessian planes,
    10 for Kirchhoff) never bind."""
    import torch

    import springcraft_tpu_torch as sct
    from springcraft_tpu_torch.ops import assembly, assembly_kernels, rigid
    from springcraft_tpu_torch.ops import spd_linalg

    results = {}
    batch, n = coords.shape[:2]

    planes = record(
        results, "hessian_planes",
        lambda: assembly_kernels.hessian_planes_ensemble(coords, params),
        lambda: assembly.hessian_planes_plain(coords, params),
        (4 * (3 * batch * n + 9 * batch * n * n), 30 * batch * n * n),
        graph=True)

    bases = rigid.rigid_modes_anm(coords)
    _, _, scale_h, ts = rigid.stitch_inputs(planes, bases)
    m = 3 * n
    mp = spd_linalg.padded_size(m)
    reg = record(
        results, "regularize_stitch",
        lambda: assembly_kernels.regularize_stitch(planes, scale_h, ts, mp),
        lambda: assembly_kernels.regularize_stitch_plain(planes, scale_h,
                                                         ts, mp),
        (4 * (9 * batch * n * n + 7 * batch * m + batch * mp * mp),
         14 * batch * m * m))
    del planes
    stitch_parity(results, coords, params, " invariant 13 A")
    stitch_parity(results, coords, sct.hinsen_params(), " hinsen")
    # n % 4 != 0: the store pass's per-column instance
    stitch_parity(results, coords[:, :n - 1].contiguous(), params,
                  " invariant 13 A, n % 4 != 0")

    # the first leaf of the recursion: an equilibrated SPD 64-panel, then
    # the largest leaf, 128 (``block=128``)
    panels = reg[:, :spd_linalg.LEAF, :spd_linalg.LEAF].contiguous()
    largest = reg[:, :spd_linalg.MAX_LEAF, :spd_linalg.MAX_LEAF].contiguous()
    del reg
    panel_kernels_parity(results, panels, largest)
    del panels, largest

    # the GNM ensemble's chunk, then the single structure (by graph
    # replay: either call is shorter than its host's enqueue)
    for c in (coords, single):
        b, nc = c.shape[:2]
        record(results, "kirchhoff",
               lambda c=c: assembly_kernels.kirchhoff_ensemble(c, params),
               lambda c=c: assembly.kirchhoff_plain(c, params),
               (4 * (3 * b * nc + b * nc * nc), 10 * b * nc * nc),
               graph=True)
    # the single structure (its path), then an ensemble chunk
    for c in (single, coords):
        b, nc = c.shape[:2]
        record(results, "hessian_xyz",
               lambda c=c: assembly_kernels.hessian_xyz_ensemble(c, params),
               lambda c=c: assembly.hessian_xyz_plain(c, params),
               (4 * (3 * b * nc + 9 * b * nc * nc), 30 * b * nc * nc),
               graph=True)
    # n % 4 != 0: the Hessian kernels' rows start off 16-byte boundaries
    # (a chunk of 299 atoms, one structure of 1777)
    odd_chunk = coords[:, :n - 1].contiguous()
    odd_single = torch.as_tensor(make_conformers(1, N_SINGLE + 1, SEED),
                                 device="cuda")
    for name, kernel, plain, shapes in (
            ("hessian_planes", assembly_kernels.hessian_planes_ensemble,
             assembly.hessian_planes_plain, (odd_chunk,)),
            ("hessian_xyz", assembly_kernels.hessian_xyz_ensemble,
             assembly.hessian_xyz_plain, (odd_chunk, odd_single))):
        for c in shapes:
            b, nc = c.shape[:2]
            record(results, name, lambda c=c, kernel=kernel: kernel(c, params),
                   lambda c=c, plain=plain: plain(c, params),
                   (4 * (3 * b * nc + 9 * b * nc * nc), 30 * b * nc * nc),
                   label=" n % 4 != 0", graph=True)
    del odd_chunk, odd_single
    banded_parity(coords, single, params, results)
    return results


def dense_band(diags):
    """The dense symmetric band matrices ``(B, n, n)`` of band diagonals
    ``(B, w, n)``."""
    import torch

    batch, w, n = diags.shape
    band = torch.zeros((batch, n, n), dtype=diags.dtype, device=diags.device)
    for d in range(w):
        idx = torch.arange(n - d, device=diags.device)
        band[:, idx, idx + d] = diags[:, d, :n - d]
        band[:, idx + d, idx] = diags[:, d, :n - d]
    return band


def halvings_needed(feed, lo, hi, n_iter):
    """Halvings after which each eigenvalue's result no longer changes,
    ``(B, n)``: the work this run's data needs (the kernel's exact early
    stop ends an eigenvalue's loop about there), from one launch of the
    kernel under test at each depth (its plain version would take minutes
    a depth), so the bound it gives is a design count taken from the
    kernel's own results; :func:`bisect_work_every_halving` prints beside
    it."""
    import torch

    from springcraft_tpu_torch.ops import spectrum

    final = spectrum.banded_bisect(feed, lo, hi, n_iter).view(torch.int32)
    needed = torch.zeros_like(final)
    for k in range(n_iter):
        moved = spectrum.banded_bisect(feed, lo, hi, k).view(
            torch.int32) != final
        needed = torch.where(moved, k + 1, needed)
    return needed


def bisect_work(feed, lo, hi, n_iter):
    """``(bytes, flops, rate)`` of K10 on this feed: float64 Sturm counts,
    one at each distinct mid of the first floor(log2 n) halvings (shared by
    a matrix's eigenvalues) and one per eigenvalue for each later halving
    its data needs; per count and band row the window's W (W - 1)
    eliminations, W - 1 multipliers and the pivot."""
    batch, w, n = feed.shape[0], feed.shape[1], feed.shape[2] - feed.shape[1]
    tree = min(n_iter, n.bit_length() - 1)
    later = (halvings_needed(feed, lo, hi, n_iter) - tree).clamp(min=0)
    steps = (int(later.sum()) + batch * (2 ** tree - 1)) * n
    return (4 * (w * (n + w) * batch + 2 * batch + batch * n),
            steps * (w * w + 1), F64_FLOPS)


def bisect_work_every_halving(feed, n_iter):
    """``(bytes, flops, rate)`` of every eigenvalue taking all `n_iter`
    halvings, each a full count: the bound K10 was held to before its
    shared tree and early stop, independent of any kernel's output."""
    batch, w, n = feed.shape[0], feed.shape[1], feed.shape[2] - feed.shape[1]
    return (4 * (w * (n + w) * batch + 2 * batch + batch * n),
            batch * n * n_iter * n * (w * w + 1), F64_FLOPS)


def bisect_bounds(feed, lo, hi, n_iter):
    """``(work, text)``: K10's work on this run's data (:func:`bisect_work`)
    and a line naming both bounds."""
    work = bisect_work(feed, lo, hi, n_iter)
    data_ms, data_by = bound(*work)
    every_ms, every_by = bound(*bisect_work_every_halving(feed, n_iter))
    return work, (f"bound {data_ms:.4f} ms ({data_by}; the halvings this "
                  f"run's data needs, counted from the kernel's results at "
                  f"each depth), {every_ms:.4f} ms ({every_by}) with every "
                  f"eigenvalue through all {n_iter} halvings")


def bisect_parity(diags, n_iter, results, library_band=None):
    """K10 against its plain version on band diagonals `diags` ``(B, w,
    n)``, the plain version (a Python loop over the band) timed over one
    call, ``torch.linalg.eigvalsh`` of `library_band` (the dense band) as
    the library call; returns the kernel's eigenvalues and ``(lo, hi)``."""
    import torch

    from springcraft_tpu_torch.ops import spectrum

    batch, w, n = diags.shape
    feed, lo, hi = spectrum.bisect_inputs(diags)

    def bisect():
        return spectrum.banded_bisect(feed, lo, hi, n_iter)

    vals = bisect()
    ref, plain_ms = timed_once(
        lambda: spectrum.banded_bisect_plain(feed, lo, hi, n_iter))
    check(bool(torch.isfinite(vals).all()), "banded_bisect: non-finite")
    err, rel = max_errors(vals, ref)
    tol = KERNELS["banded_bisect"][2]
    check(rel <= tol, f"banded_bisect {(batch, w, n)}: max rel err "
          f"{rel:.3e} > {tol:g}")
    ms = cuda_ms(bisect, reps=5)
    library_ms = None
    if library_band is not None:
        library_ms = cuda_ms(lambda: torch.linalg.eigvalsh(library_band),
                             reps=3)
    work, bounds = bisect_bounds(feed, lo, hi, n_iter)
    rec = entry((batch, w, n), err, ms, plain_ms, work, library_ms)
    print(f"parity banded_bisect {(batch, w, n)} (feed "
          f"{4 * w * (n + w) / 1024:.1f} KB), {n_iter} halvings: max abs err "
          f"{err:.3e}, max rel err {rel:.3e} (tol {tol:g}); kernel {ms:.4f} "
          f"ms (5 calls), plain {plain_ms:.4f} ms (1 call), {bounds}, "
          "library "
          + ("none" if library_ms is None else
             f"eigvalsh of the dense band {library_ms:.4f} ms (3 calls)"),
          flush=True)
    results.setdefault("banded_bisect", []).append(rec)
    return vals, lo, hi


def bisect_at_40(diags):
    """K10 timed at the default 40 halvings on band diagonals `diags`, with
    its bounds on this run's data."""
    from springcraft_tpu_torch.ops import spectrum

    feed, lo, hi = spectrum.bisect_inputs(diags)
    ms = cuda_ms(lambda: spectrum.banded_bisect(feed, lo, hi, 40), 5)
    print(f"banded_bisect {tuple(diags.shape)} at the path's 40 halvings: "
          f"kernel {ms:.4f} ms (5 calls), "
          f"{bisect_bounds(feed, lo, hi, 40)[1]}", flush=True)


def banded_parity(coords, single, params, results):
    """K10 and K11 against their plain versions on the band of the chunk's
    Hessians ``(128, 9, 900)``, K10 also on the single structure's
    ``(1, 9, 5328)``, whose 188 KB feed takes the kernel's opt-in
    shared-memory branch; the plain versions, Python loops over the band,
    are timed over one call each."""
    import torch

    from springcraft_tpu_torch.ops import assembly_kernels, spectrum

    diags = spectrum.band_reduce(
        assembly_kernels.hessian_xyz_ensemble(coords, params), 8)
    batch, w, n = diags.shape
    band = dense_band(diags)
    vals, lo, hi = bisect_parity(diags, N_ITER_BISECT, results, band)
    # the banded paths run the default 40 halvings
    bisect_at_40(diags)
    # the single structure's path runs the default 40 halvings; its plain
    # version is a Python loop over 5328 band rows for every halving
    single_diags = spectrum.band_reduce(
        assembly_kernels.hessian_xyz_ensemble(single, params), 8)
    for n_iter in SINGLE_PARITY_HALVINGS:
        bisect_parity(single_diags, n_iter, results,
                      dense_band(single_diags) if n_iter == 40 else None)
    del single_diags

    feed, shifts, floor, _ = spectrum.eigvec_inputs(diags, vals)

    def eigvec(fn):
        # the path's chunks of 256 shifts
        return torch.cat([fn(feed, shifts[:, c:c + 256].contiguous(), c,
                             floor, 2, 1.0) for c in range(0, n, 256)], -1)

    x = eigvec(spectrum.banded_eigvec)
    x_plain, plain_ms = timed_once(
        lambda: eigvec(spectrum.banded_eigvec_plain))
    check(bool(torch.isfinite(x).all()), "banded_eigvec: non-finite")
    norm = vals.abs().amax(dim=1)[:, None]
    medians, largest = {}, {}
    for label, u in (("kernel", x), ("plain", x_plain)):
        res = torch.linalg.vector_norm(band @ u - u * vals[:, None, :],
                                       dim=1) / norm
        medians[label], largest[label] = float(res.median()), float(res.max())
        check(medians[label] <= EIGVEC_RESIDUAL_TOL,
              f"banded_eigvec {label}: median residual "
              f"{medians[label]:.3e} > {EIGVEC_RESIDUAL_TOL:g} ||B||")
    check(largest["kernel"] <= EIGVEC_MAX_RESIDUAL,
          f"banded_eigvec: largest residual {largest['kernel']:.3e} > "
          f"{EIGVEC_MAX_RESIDUAL:g} ||B|| (plain {largest['plain']:.3e})")
    gaps = torch.diff(vals, dim=1)
    big = float("inf") * torch.ones_like(vals[:, :1])
    gap = torch.minimum(torch.cat([big, gaps], 1), torch.cat([gaps, big], 1))
    apart = gap > EIGVEC_GAP * (hi - lo)[:, None]
    overlap = (x * x_plain).sum(dim=1).abs()[apart]
    sign = torch.sign((x * x_plain).sum(dim=1, keepdim=True))
    diff = (x - sign * x_plain).abs().amax(dim=1)[apart]
    worst, err = float(1 - overlap.min()), float(diff.max())
    tol = KERNELS["banded_eigvec"][2]
    check(worst <= EIGVEC_OVERLAP_TOL and err <= tol,
          f"banded_eigvec: 1 - |overlap| {worst:.3e}, sign-aligned max "
          f"abs err {err:.3e} on separated eigenvalues")
    ms = cuda_ms(lambda: eigvec(spectrum.banded_eigvec), reps=5)
    first = shifts[:, :256].contiguous()
    launch_ms = cuda_ms(lambda: spectrum.banded_eigvec(feed, first, 0, floor,
                                                       2, 1.0), reps=5)
    library_ms = cuda_ms(lambda: torch.linalg.eigh(band), reps=3)
    # what the kernel's design moves a shift: its window checkpoints
    # written once and read by both backward sweeps, the float64 iterate
    # written by the first forward sweep, read and written by the next
    # three sweeps and read by the output pass, the float32 output
    design_bytes = batch * n * (
        3 * 8 * spectrum.eigvec_checkpoint_len(n, w)
        + 8 * 8 * n + 4 * n)
    # float64: per shift the band's LDL^T (n rows of W^2 + 1) and two
    # solves (forward and back, 4 (W - 1) + 3 a row)
    rec = entry((batch, n, n), err, ms, plain_ms,
                (4 * (w * (n + w) * batch + 2 * batch * n + batch * n * n),
                 batch * n * n * (w * w + 1 + 2 * (4 * (w - 1) + 3)),
                 F64_FLOPS), library_ms)
    print(f"parity banded_eigvec {tuple(x.shape)}, w 9, 2 solves, chunks of "
          f"256 shifts: median residual kernel {medians['kernel']:.3e}, "
          f"plain {medians['plain']:.3e} ||B|| (tol "
          f"{EIGVEC_RESIDUAL_TOL:g}), largest kernel "
          f"{largest['kernel']:.3e}, plain {largest['plain']:.3e} ||B|| "
          f"(tol {EIGVEC_MAX_RESIDUAL:g}); on {int(apart.sum())} of "
          f"{apart.numel()} separated eigenvalues 1 - |u_k . u_p| <= "
          f"{worst:.3e} (tol {EIGVEC_OVERLAP_TOL:g}), sign-aligned max abs "
          f"err {err:.3e} (tol {tol:g}); kernel {ms:.4f} ms per call (5 "
          f"calls, {-(-n // 256)} launches each), {launch_ms:.4f} ms per "
          f"launch of 256 shifts, plain {plain_ms:.4f} ms (1 call), bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}; the design moves "
          f"{design_bytes / 1e9:.2f} GB a call, "
          f"{design_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms), library eigh "
          f"of the dense band {library_ms:.4f} ms (3 calls)", flush=True)
    results["banded_eigvec"] = [rec]


def drive(path, fn):
    """Run `fn` once from zero launch counts and check that it launched
    every kernel of `path`; returns ``(out, seconds, launches)``.  Prints
    the launches and the run's peak device memory."""
    import torch

    import springcraft_tpu_torch as sct

    wrappers = sct.kernel_wrappers()
    for wrapper in wrappers.values():
        wrapper.launches = 0
    for name in TABLE_KERNELS:
        wrappers[name].table_launches = 0
    wrappers["assembly_stitch"].row_sum_launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    table = {name: wrappers[name].table_launches for name in TABLE_KERNELS}
    row_sums = wrappers["assembly_stitch"].row_sum_launches
    peak = torch.cuda.max_memory_allocated() / 2**20
    print(f"{path} launches: {json.dumps(launches)}; of these through the "
          f"table branch: {json.dumps(table)}; K7 row-sum passes "
          f"{row_sums}; peak device memory {peak:.1f} MiB", flush=True)
    for name in PATH_KERNELS[path]:
        check(launches[name] > 0, f"{path} never launched kernel {name}")
        if name == "assembly_stitch":
            check(row_sums == launches[name], f"{path}: {row_sums} row-sum "
                  f"passes of K7 for {launches[name]} store passes")
        if name in TABLE_KERNELS and path in MIXED_PATHS:
            check(0 < table[name] < launches[name],
                  f"{path}: kernel {name} took its table branch "
                  f"{table[name]} times of {launches[name]}, not both")
        elif name in TABLE_KERNELS:
            want = launches[name] if path in TABLE_PATHS else 0
            check(table[name] == want,
                  f"{path}: kernel {name} took its table branch "
                  f"{table[name]} times of {launches[name]}, not {want}")
    return out, seconds, launches


def check_outputs(path, out, shapes):
    import torch

    check(set(out) == set(shapes), f"{path} outputs {sorted(out)}")
    for key, shape in shapes.items():
        check(tuple(out[key].shape) == shape, f"{path} {key} shape")
        check(out[key].device.type == "cuda", f"{path} {key} device")
        check(bool(torch.isfinite(out[key]).all()),
              f"{path} {key} not finite")


def compare(label, out, ref, tols):
    """Every output against the float64 reference, each within its
    tolerance (``tols``, else SLICE_TOL)."""
    errs = {}
    for key in ref:
        _, errs[key] = max_errors(out[key], ref[key])
        tol = tols.get(key, SLICE_TOL)
        check(errs[key] <= tol, f"{label} {key}: max rel err "
              f"{errs[key]:.3e} > {tol:g} vs float64 cho_solve")
    print(f"{label} vs float64 cho_solve: "
          + ", ".join(f"{key} max rel err {err:.3e} (tol "
                      f"{tols.get(key, SLICE_TOL):g})"
                      for key, err in errs.items()), flush=True)


def rel_rmse(got, ref):
    """``sqrt(mean((got - ref)^2) / mean(ref^2))``, as the JAX package's
    benchmark scores an MSF profile."""
    return float((((got - ref) ** 2).mean() / (ref ** 2).mean()).sqrt())


def msf_rel_rmse(label, msf32, msf64):
    """The repository's float32 regression line: relative RMSE of the
    float32 MSF against the float64 one, failing above MSF_RMSE_TOL."""
    rmse = rel_rmse(msf32.double(), msf64.double())
    print(f"{label}: float32 MSF vs float64 engine: rel RMSE {rmse:.2e} "
          f"(tol {MSF_RMSE_TOL:g})", flush=True)
    check(rmse <= MSF_RMSE_TOL, f"{label}: MSF rel RMSE {rmse:.3e}")


def timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def ensemble_path(path, run, conformers, shapes, card, repeats):
    """Drive an ensemble path over all conformers in chunks (blocked
    engine, float32), hold its first chunk against the float64
    ``cho_solve`` engine and print its rate; returns the launches."""
    import torch

    def blocked():
        return run(conformers, inverse="blocked", dtype=torch.float32,
                   chunk=CHUNK)

    out, seconds, launches = drive(path, blocked)
    check_outputs(path, out, shapes)
    ref = run(conformers[:CHUNK].astype("float64"), inverse="cho_solve",
              dtype=torch.float64, chunk=None)
    compare(f"{path} (first chunk)",
            {key: value[:CHUNK] for key, value in out.items()}, ref, {})
    del out, ref
    rates = [len(conformers) / s
             for s in [seconds] + [timed(blocked) for _ in range(repeats)]]
    print(f"{path} rate: {len(conformers)} conformers x N="
          f"{conformers.shape[1]} in chunks of {CHUNK}: "
          + ", ".join(f"{r:.1f}" for r in rates)
          + f" solves/s (first run counted, then {repeats} repeats) on "
          f"[{card}]", flush=True)
    return launches


def single_path(path, run, coord, shapes, tols, card, msf_rmse=False):
    """Drive a single-structure path in float32, hold it against its
    float64 engine (with `msf_rmse` also by the relative RMSE of the MSF)
    and print the time per structure; returns the launches."""
    import torch

    def f32():
        return run(coord, dtype=torch.float32)

    out, seconds, launches = drive(path, f32)
    check_outputs(path, out, shapes)
    ref = run(coord.astype("float64"), dtype=torch.float64)
    compare(path, out, ref, tols)
    if msf_rmse:
        msf_rel_rmse(path, out["msf"], ref["msf"])
    del out, ref
    again = timed(f32)
    print(f"{path}: N={coord.shape[0]} float32, {seconds * 1e3:.1f} ms "
          f"per structure (first call), {again * 1e3:.1f} ms (second) on "
          f"[{card}]", flush=True)
    return launches


def float64_references(model, coords, params):
    """Float64 references of `coords` ``(B, n, 3)`` on the card: the dense
    ``torch.linalg.eigh`` route merged with the ``cho_solve`` covariance
    observables (which replace its MSF, B-factors and DCC), and the
    matrices themselves."""
    import torch

    import springcraft_tpu_torch as sct
    from springcraft_tpu_torch.parallel import pipeline

    x = torch.as_tensor(coords, dtype=torch.float64, device="cuda")
    if model == "anm":
        eig = sct.ensemble_anm(x, params, with_dcc=True, dtype=x.dtype)
        cov = sct.ensemble_anm_fluctuations(x, params, inverse="cho_solve",
                                            dtype=x.dtype)
        matrices = pipeline._build_hessians_batched(x, params, None)
    else:
        eig = sct.ensemble_gnm(x, params, with_dcc=True, dtype=x.dtype)
        cov = sct.ensemble_gnm_fluctuations(x, params, inverse="cho_solve",
                                            dtype=x.dtype)
        matrices = pipeline._build_kirchhoffs_batched(x, params, None)
    return {**eig, **cov}, matrices


def eigen_errors(vals, vecs, matrices, norm):
    """Largest ``||M u - lambda u|| / ||M||_2`` over the rows `vecs` ``(B,
    k, m)`` and largest ``|U U^T - I|``, in float64."""
    import torch

    u = vecs.double().transpose(-1, -2)
    res = torch.linalg.vector_norm(
        matrices @ u - u * vals.double()[..., None, :], dim=-2) / norm
    eye = torch.eye(u.shape[-1], dtype=u.dtype, device=u.device)
    return float(res.max()), float((vecs.double() @ u - eye).abs().max())


def check_spectral(label, out, ref, matrices, n_trivial, tols):
    """Every output of a spectral path against the float64 references:
    values within their tolerance of max|ref| (frequencies past the
    `n_trivial` null modes, whose frequencies are square roots of
    rounding noise; ``mode_values`` against the lowest non-trivial
    eigenvalues), eigenvectors and mode shapes by their residuals and
    orthonormality."""
    scale = ref["eig_values"].abs().amax(dim=-1)
    errs = {}
    for key, value in out.items():
        if key.endswith("_vectors"):
            continue
        if key == "mode_values":
            lowest = ref["eig_values"][..., n_trivial:n_trivial
                                       + value.shape[-1]]
            errs[key] = max_errors(value, lowest)[0] / float(scale.max())
        elif key == "frequencies":
            errs[key] = max_errors(value[..., n_trivial:],
                                   ref[key][..., n_trivial:])[1]
        else:
            errs[key] = max_errors(value, ref[key])[1]
        tol = tols.get(key, SLICE_TOL)
        check(errs[key] <= tol, f"{label} {key}: max rel err "
              f"{errs[key]:.3e} > {tol:g} vs float64")
    line = ", ".join(f"{key} {err:.3e}" for key, err in errs.items())
    for vals, vecs in (("eig_values", "eig_vectors"),
                       ("mode_values", "mode_vectors")):
        if vecs in out:
            res, orth = eigen_errors(out[vals], out[vecs], matrices,
                                     scale[:, None])
            check(res <= RESIDUAL_TOL and orth <= ORTHO_TOL,
                  f"{label} {vecs}: residual {res:.3e} (tol "
                  f"{RESIDUAL_TOL:g} ||M||), orthonormality {orth:.3e} (tol "
                  f"{ORTHO_TOL:g})")
            line += (f"; {vecs} residual {res:.3e} ||M|| (tol "
                     f"{RESIDUAL_TOL:g}), orthonormality {orth:.3e} (tol "
                     f"{ORTHO_TOL:g})")
    print(f"{label} vs float64 (max rel err, tol {SLICE_TOL:g} unless "
          f"stated): {line}", flush=True)


def spectral_ensemble_path(path, run, conformers, shapes, refs, n_trivial,
                           card, repeats):
    """Drive a spectral ensemble path over `conformers` in chunks, hold
    its first chunk against the float64 references `refs` and print its
    rate; returns the launches."""
    out, seconds, launches = drive(path, lambda: run(conformers))
    check_outputs(path, out, shapes)
    check_spectral(f"{path} (first chunk)",
                   {key: value[:CHUNK] for key, value in out.items()},
                   *refs, n_trivial, {})
    del out
    rates = [len(conformers) / s for s in
             [seconds] + [timed(lambda: run(conformers))
                          for _ in range(repeats)]]
    print(f"{path} rate: {len(conformers)} conformers x N="
          f"{conformers.shape[1]} in chunks of {CHUNK}: "
          + ", ".join(f"{r:.1f}" for r in rates)
          + f" solves/s (first run counted, then {repeats} repeats) on "
          f"[{card}]", flush=True)
    return launches


def spectral_single_path(path, run, coord, shapes, model, params,
                         n_trivial, tols, card):
    """Drive a single-structure spectral path in float32, hold it against
    the float64 references and print the time per structure."""
    out, seconds, launches = drive(path, lambda: run(coord))
    check_outputs(path, out, shapes)
    check_spectral(path, {key: value[None] for key, value in out.items()},
                   *float64_references(model, coord[None], params),
                   n_trivial, tols)
    del out
    again = timed(lambda: run(coord))
    print(f"{path}: N={coord.shape[0]} float32, {seconds * 1e3:.1f} ms "
          f"per structure (first call), {again * 1e3:.1f} ms (second) on "
          f"[{card}]", flush=True)
    return launches


def spectral_paths(conformers, single, params, card):
    """Drive the six spectral paths; returns ``{path: launches}``."""
    import springcraft_tpu_torch as sct

    n_conf, n = conformers.shape[:2]
    m = 3 * n
    covariance = {"msf": (n_conf, n), "bfactor": (n_conf, n),
                  "dcc": (n_conf, n, n)}
    modes = {"mode_values": (n_conf, N_MODES)}
    spectral = dict(n_modes=N_MODES, n_iter_bisect=N_ITER_BISECT,
                    chunk=CHUNK, device="cuda")
    banded = dict(with_dcc=True, chunk=CHUNK, device="cuda")
    launches = {}
    for model, dim, n_trivial, options in (
            ("anm", m, 6, {}), ("gnm", n, 1,
                                {"n_iter_modes": GNM_ITER_MODES})):
        refs = float64_references(model, conformers[:CHUNK], params)
        eigen = {"eig_values": (n_conf, dim), "frequencies": (n_conf, dim)}
        launches[f"{model}_spectral_ensemble"] = spectral_ensemble_path(
            f"{model}_spectral_ensemble",
            lambda c, fn=getattr(sct, f"ensemble_{model}_spectral"),
            options=options: fn(c, params, **spectral, **options),
            conformers, {**covariance, **eigen, **modes,
                         "covariance": (n_conf, dim, dim),
                         "mode_vectors": (n_conf, N_MODES, dim)},
            refs, n_trivial, card, repeats=1)
        launches[f"{model}_banded_ensemble"] = spectral_ensemble_path(
            f"{model}_banded_ensemble",
            lambda c, fn=getattr(sct, f"ensemble_{model}_banded"):
                fn(c, params, **banded),
            conformers, {**covariance, **eigen,
                         "eig_vectors": (n_conf, dim, dim)},
            refs, n_trivial, card, repeats=0)
        del refs

    n1 = single.shape[0]
    one = {"msf": (n1,), "bfactor": (n1,), "dcc": (n1, n1)}
    launches["anm_spectral_single"] = spectral_single_path(
        "anm_spectral_single",
        lambda c: sct.anm_spectral(c, params, n_modes=N_MODES,
                                   device="cuda"),
        single, {**one, "covariance": (3 * n1, 3 * n1),
                 "eig_values": (3 * n1,), "frequencies": (3 * n1,),
                 "mode_values": (N_MODES,), "mode_vectors": (N_MODES, 3 * n1)},
        "anm", params, 6, {"covariance": SINGLE_COV_TOL}, card)
    launches["gnm_spectral_single"] = spectral_single_path(
        "gnm_spectral_single",
        lambda c: sct.gnm_spectral(c, params, device="cuda"),
        single, {**one, "covariance": (n1, n1), "eig_values": (n1,),
                 "frequencies": (n1,)},
        "gnm", params, 1, {"covariance": SINGLE_COV_TOL}, card)
    return launches


def fluctuation_ensemble_paths(names, conformers, params, card, repeats,
                               **options):
    """Drive the three ensemble fluctuation paths (plane traces,
    covariance with PRS, GNM; `names` in that order, ``None`` skips one)
    with `params`; returns ``{path: launches}``."""
    import springcraft_tpu_torch as sct

    n_conf, n = conformers.shape[:2]
    traces = {"msf": (n_conf, n), "bfactor": (n_conf, n),
              "dcc": (n_conf, n, n)}

    def anm(coords, **kwargs):
        kwargs.setdefault("with_covariance", False)
        return sct.ensemble_anm_fluctuations(coords, params, device="cuda",
                                             **options, **kwargs)

    def gnm(coords, **kwargs):
        return sct.ensemble_gnm_fluctuations(coords, params, device="cuda",
                                             **kwargs)

    def anm_covariance(coords, **kwargs):
        return anm(coords, with_covariance=True, with_prs=True, **kwargs)

    shapes = (traces,
              {**traces, "covariance": (n_conf, 3 * n, 3 * n),
               "prs": (n_conf, n, n), "effector": (n_conf, n),
               "sensor": (n_conf, n)},
              {**traces, "covariance": (n_conf, n, n)})
    return {name: ensemble_path(name, run, conformers, shape, card, reps)
            for name, run, shape, reps in zip(
                names, (anm, anm_covariance, gnm), shapes, repeats)
            if name is not None}


def fluctuation_single_paths(names, coord, params, card, msf_rmse=False):
    """Drive ``anm_fluctuations`` (with PRS) and ``gnm_fluctuations`` on
    one structure `coord` ``(n, 3)`` with `params`; returns ``{path:
    launches}``.  With `msf_rmse` (7cal under eANM) the MSF is held by
    its relative RMSE, the repository's own regression line, and every
    output to REAL_STRUCTURE_TOL of its largest value."""
    import springcraft_tpu_torch as sct

    m = coord.shape[0]
    single_traces = {"msf": (m,), "bfactor": (m,), "dcc": (m, m)}
    if msf_rmse:
        cov_tols = dict.fromkeys((*single_traces, "covariance", "prs",
                                  "effector", "sensor"), REAL_STRUCTURE_TOL)
    else:
        cov_tols = dict.fromkeys(("covariance", "prs", "effector", "sensor"),
                                 SINGLE_COV_TOL)
    launches = {names[0]: single_path(
        names[0],
        lambda c, **kw: sct.anm_fluctuations(c, params, with_prs=True,
                                             device="cuda", **kw),
        coord, {**single_traces, "covariance": (3 * m, 3 * m),
                "prs": (m, m), "effector": (m,), "sensor": (m,)},
        cov_tols, card, msf_rmse)}
    launches[names[1]] = single_path(
        names[1],
        lambda c, **kw: sct.gnm_fluctuations(c, params, device="cuda",
                                             **kw),
        coord, {**single_traces, "covariance": (m, m)}, cov_tols, card,
        msf_rmse)
    return launches


def direct_paths(conformers, params, card):
    """``prep="direct"`` of the ANM ensemble (K7): both outputs against
    float64 ``cho_solve`` (as every ensemble path), no launch of the
    planes kernels, the first chunk against the planes path of the same
    call to float32 summation order, and the two preps' rates in turns;
    returns ``{path: launches}``."""
    import springcraft_tpu_torch as sct

    launches = fluctuation_ensemble_paths(
        ("anm_direct_traces", "anm_direct_covariance", None), conformers,
        params, card, (0, 0, 0), prep="direct")
    for path, count in launches.items():
        check(count["hessian_planes"] == 0 and count["regularize_stitch"] == 0,
              f"{path} launched the planes kernels")

    def run(prep, coords=conformers, **kwargs):
        return sct.ensemble_anm_fluctuations(
            coords, params, inverse="blocked", chunk=CHUNK, prep=prep,
            device="cuda", **kwargs)

    for label, kwargs in (("anm_direct_traces", {"with_covariance": False}),
                          ("anm_direct_covariance", {"with_prs": True})):
        direct = run("direct", conformers[:CHUNK], **kwargs)
        planes = run("planes", conformers[:CHUNK], **kwargs)
        errs = {key: max_errors(direct[key], planes[key])[1]
                for key in planes}
        for key, err in errs.items():
            check(err <= SLICE_TOL, f"{label} {key}: {err:.3e} from the "
                  f"planes path")
        del direct, planes
        rates = {"direct": [], "planes": []}
        for prep in ("planes", "direct", "direct", "planes"):
            rates[prep].append(len(conformers) / timed(
                lambda prep=prep: run(prep, **kwargs)))
        print(f"{label} vs prep=planes (first chunk): "
              + ", ".join(f"{key} max rel err {err:.3e}"
                          for key, err in errs.items())
              + f" (tol {SLICE_TOL:g}); rates in turns planes, direct, "
              f"direct, planes: {rates['planes'][0]:.1f}, "
              f"{rates['direct'][0]:.1f}, {rates['direct'][1]:.1f}, "
              f"{rates['planes'][1]:.1f} solves/s on [{card}]", flush=True)
    prep_stages(conformers, params, card)
    return launches


def prep_stages(conformers, params, card):
    """The two preps of one chunk beside each other, CUDA events over
    TIMING_REPS calls in turns (planes, direct, direct, planes): direct,
    the row-sum pass, the stitch inputs and K7's store pass; planes, K1,
    the stitch inputs and K2.  Both outputs agree to float32 summation
    order."""
    import torch

    from springcraft_tpu_torch.ops import assembly_kernels, rigid

    chunk = torch.as_tensor(conformers[:CHUNK], device="cuda")
    n = chunk.shape[1]
    bases = rigid.rigid_modes_anm(chunk)
    stages = {
        "direct": lambda: rigid._regularize_equilibrated_direct(
            chunk, params, bases),
        "planes": lambda: rigid._regularize_equilibrated_planes(
            assembly_kernels.hessian_planes_ensemble(chunk, params), n,
            bases),
    }
    _, rel = max_errors(stages["direct"]()[0], stages["planes"]()[0])
    check(rel <= KERNELS["assembly_stitch"][2],
          f"prep stages: direct and planes differ by {rel:.3e}")
    times = {"direct": [], "planes": []}
    for name in ("planes", "direct", "direct", "planes"):
        times[name].append(cuda_ms(stages[name]))
    print(f"prep stages of a chunk {tuple(chunk.shape)} in turns planes, "
          f"direct, direct, planes: direct (row sums, stitch inputs, K7) "
          + ", ".join(f"{t:.4f}" for t in times["direct"])
          + " ms, planes (K1, stitch inputs, K2) "
          + ", ".join(f"{t:.4f}" for t in times["planes"])
          + f" ms; outputs {rel:.3e} apart, on [{card}]", flush=True)


def panel_function_path(conformers, params):
    """The public panel functions on the equilibrated factor input of a
    chunk ``(128, 1024, 1024)``: ``panel_cholesky_batched`` (K8) and
    ``panel_inverse_batched(shrink_block=None)`` (K9) on its leading
    64-panels, ``spd_inverse_blocked`` (K3 at the leaves) on the whole;
    returns ``{path: launches}``."""
    import torch

    import springcraft_tpu_torch as sct
    from springcraft_tpu_torch.ops import rigid, spd_linalg

    coords = torch.as_tensor(conformers[:CHUNK], device="cuda")
    reg, _, _ = rigid._regularize_equilibrated_direct(
        coords, params, rigid.rigid_modes_anm(coords))
    panels = reg[:, :spd_linalg.LEAF, :spd_linalg.LEAF].contiguous()

    def run():
        return (sct.panel_cholesky_batched(panels),
                sct.panel_inverse_batched(panels, shrink_block=None),
                sct.spd_inverse_blocked(reg))

    ((l, w), w_full, inv), _, launches = drive("panel_functions", run)
    for name, x in (("l", l), ("w", w), ("w_full", w_full), ("inv", inv)):
        check(bool(torch.isfinite(x).all()), f"panel_functions: {name}")
    p64, eye = panels.double(), torch.eye(spd_linalg.LEAF, device="cuda")
    errs = {
        "L L^T - A": float((l.double() @ l.double().mT - p64).abs().max()),
        "W L - I": float((w.double() @ l.double() - eye).abs().max()),
        "W_full A W_full^T - I": float(
            (w_full.double() @ p64 @ w_full.double().mT - eye).abs().max()),
        "inv vs float64 torch.linalg.inv (of max)": max_errors(
            inv, torch.linalg.inv(reg.double()))[1],
    }
    print(f"panel_functions on {tuple(panels.shape)} panels and "
          f"{tuple(reg.shape)} reg: "
          + ", ".join(f"{key} {err:.3e}" for key, err in errs.items())
          + f" (tol {SLICE_TOL:g})", flush=True)
    for key, err in errs.items():
        check(err <= SLICE_TOL, f"panel_functions: {key} {err:.3e}")
    del l, w, w_full, inv, panels
    return {"panel_functions": launches, **leaf_128_path(reg)}


def _gram_of_parts(parts):
    """``G^T G`` of the inverse factor from its top-split blocks."""
    import torch
    import torch.nn.functional as F

    g11, g21, g22 = parts
    if g21 is None:
        return g11.mT @ g11
    h = g11.shape[-1]
    g = torch.cat([F.pad(g11, (0, g22.shape[-1])),
                   torch.cat([g21, g22], dim=-1)], dim=-2)
    return g.mT @ g


def leaf_128_path(reg):
    """The blocked inverse at its largest leaf on a chunk's factor input
    `reg` ``(128, 1024, 1024)``: ``spd_inverse_factor_parts(block=128)``
    and ``spd_inverse_blocked(block=128)`` (K3 at (128, 128, 128), eight
    leaves a call) and ``panel_inverse_batched`` (K9 by default) on the
    first 128-block, from zero launch counts; both inverses against
    float64 ``cho_solve``.  Then the leaf as a measurement: the factor
    at ``block=64`` and ``block=128`` timed in turns (64, 128, 128, 64,
    CUDA events over TIMING_REPS calls each), both held against the same
    float64 inverse.  Returns ``{path: launches}``."""
    import torch

    import springcraft_tpu_torch as sct
    from springcraft_tpu_torch.ops import spd_linalg

    big = spd_linalg.MAX_LEAF
    block = reg[:, :big, :big].contiguous()
    leaves = reg.shape[-1] // big

    def run():
        return (spd_linalg.spd_inverse_factor_parts(reg, block=big),
                sct.spd_inverse_blocked(reg, block=big),
                sct.panel_inverse_batched(block))

    (parts, inv, w_full), _, launches = drive("panel_functions_128", run)
    check(launches["panel_inverse"] == 2 * leaves,
          f"panel_functions_128: {launches['panel_inverse']} leaf launches, "
          f"not {2 * leaves} (leaves of {big} rows)")
    reg64 = reg.double()
    eye = torch.eye(reg.shape[-1], device=reg.device, dtype=torch.float64)
    ref = torch.cholesky_solve(eye.expand_as(reg64),
                               torch.linalg.cholesky(reg64))
    del reg64, eye
    b64 = block.double()
    eye = torch.eye(big, device=reg.device, dtype=torch.float64)
    errs = {
        "parts": max_errors(_gram_of_parts(parts), ref)[1],
        "blocked": max_errors(inv, ref)[1],
        "W_full A W_full^T - I": float(
            (w_full.double() @ b64 @ w_full.double().mT - eye).abs().max()),
    }
    del parts, inv, w_full, b64
    for key, err in errs.items():
        check(err <= SLICE_TOL, f"panel_functions_128: {key} {err:.3e}")
    print(f"panel_functions_128 on {tuple(reg.shape)}: K3 launches "
          f"{launches['panel_inverse']} ({leaves} leaves of {big} a call), "
          + ", ".join(f"{key} {err:.3e}" for key, err in errs.items())
          + f" (tol {SLICE_TOL:g}; inverses as max rel err against float64 "
          f"cho_solve)", flush=True)

    def factor(b):
        return lambda: spd_linalg.spd_inverse_factor_parts(reg, block=b)

    turns = {spd_linalg.LEAF: [], big: []}
    for b in (spd_linalg.LEAF, big, big, spd_linalg.LEAF):
        turns[b].append(cuda_ms(factor(b)))
    errs = {b: max_errors(_gram_of_parts(factor(b)()), ref)[1]
            for b in turns}
    del ref
    for b, err in errs.items():
        check(err <= SLICE_TOL, f"inverse factor at block={b}: {err:.3e}")
    print(f"leaf turns: spd_inverse_factor_parts {tuple(reg.shape)}, CUDA "
          f"events over {TIMING_REPS} calls, in turns 64, 128, 128, 64: "
          + "; ".join(f"block={b} " + ", ".join(f"{t:.3f}" for t in ms)
                      + f" ms (mean {sum(ms) / len(ms):.3f}; G^T G vs "
                      f"float64 cho_solve max rel err {errs[b]:.3e})"
                      for b, ms in turns.items()), flush=True)
    torch.cuda.empty_cache()
    return {"panel_functions_128": launches}


def _eig_checks(label, vals, vecs, matrix64, ref_vals, norm):
    """Float32 modes (rows) against `ref_vals`, their float64 eigenvalues
    of the same matrix, whose largest |lambda| is `norm` (``||M||_2``):
    eigenvalues within SLICE_TOL of it, ``||M u - lambda u|| <=
    RESIDUAL_TOL ||M||_2``, ``|U U^T - I| <= ORTHO_TOL``."""
    import torch

    k = vals.shape[0]
    val_err = float((vals.double() - ref_vals[:k]).abs().max()) / norm
    u = vecs.double()
    res = float(torch.linalg.vector_norm(
        matrix64 @ u.T - u.T * vals.double()[None, :], dim=0).max()) / norm
    orth = float((u @ u.T - torch.eye(k, device=u.device,
                                      dtype=u.dtype)).abs().max())
    print(f"{label}: float32 eigenvalues vs float64 eigh max err "
          f"{val_err:.3e} of max|lambda| (tol {SLICE_TOL:g}); residual "
          f"{res:.3e} ||M||_2 (tol {RESIDUAL_TOL:g}); |UU^T - I| {orth:.3e} "
          f"(tol {ORTHO_TOL:g})", flush=True)
    check(val_err <= SLICE_TOL, f"{label}: eigenvalues {val_err:.3e}")
    check(res <= RESIDUAL_TOL, f"{label}: residual {res:.3e}")
    check(orth <= ORTHO_TOL, f"{label}: orthonormality {orth:.3e}")


def _refined_checks(label, theta, res, ref_vals, wanted):
    """Refined float64 eigenvalues of the `wanted` lowest modes against
    the float64 spectrum `ref_vals`, within REFINED_RTOL relative."""
    rel = float(((theta[:wanted] - ref_vals[:wanted]).abs()
                 / ref_vals[:wanted].abs()).max())
    print(f"{label}: refined float64 eigenvalues vs float64 eigh max rel "
          f"err {rel:.3e} (tol {REFINED_RTOL:g}), refined residuals max "
          f"{float(res[:wanted].max()):.3e}", flush=True)
    check(rel <= REFINED_RTOL, f"{label}: refined eigenvalues {rel:.3e}")


def mode_paths(ca_7cal, e_anm, card):
    """A structure's lowest modes by shift-invert, then float64
    refinement: 7cal's CA trace under eANM (K5 through its table branch,
    ``lowest_modes_anm(engine="auto")`` = ``"invfactor"``, K3 at the
    recursion's 64-wide leaves, ``refine_modes_f64``), its GNM twin (K6,
    ``lowest_modes_shift_invert`` with ``null_mode_gnm``,
    ``refine_modes_f64_gnm``) and 8,192 random atoms under the invariant
    field (``"chol"``, ``refine_modes_f64(method="sparse")``).  Each
    solves N_MODES + MODE_BUFFER modes and holds the N_MODES lowest;
    returns ``{path: launches}``."""
    import torch

    import springcraft_tpu_torch as sct
    from springcraft_tpu_torch.ops import assembly, assembly_kernels, rigid

    k = N_MODES + MODE_BUFFER
    c = torch.as_tensor(ca_7cal, device="cuda")
    n = c.shape[0]
    launches = {}

    def anm():
        h = assembly_kernels.hessian_xyz_ensemble(c[None], e_anm)[0]
        vals, vecs = sct.lowest_modes_anm(h, c, k, engine="auto")
        return h, vals, vecs, sct.refine_modes_f64(c, e_anm, vecs)

    def gnm():
        kirchhoff = assembly_kernels.kirchhoff_ensemble(c[None], e_anm)[0]
        vals, vecs = sct.lowest_modes_shift_invert(
            kirchhoff, rigid.null_mode_gnm(n, device=c.device), k=k,
            engine="auto")
        return (kirchhoff, vals, vecs,
                sct.refine_modes_f64_gnm(c, e_anm, vecs))

    c64 = c.double()
    for path, run, trivial, exact in (
            ("anm_7cal_modes", anm, 6, lambda: assembly.hessian_matrix(
                c64, e_anm, layout="xyz")),
            ("gnm_7cal_modes", gnm, 1, lambda: assembly.kirchhoff_matrix(
                c64, e_anm))):
        (matrix, vals, vecs, (theta, _, res)), seconds, launches[path] = \
            drive(path, run)
        again = timed(run)
        m64 = matrix.double()
        del matrix
        ref = torch.linalg.eigvalsh(m64)
        _eig_checks(path, vals[:N_MODES], vecs[:N_MODES], m64,
                    ref[trivial:], float(ref.abs().max()))
        del m64
        ref = torch.linalg.eigvalsh(exact())[trivial:]
        _refined_checks(path, theta, res, ref, N_MODES)
        print(f"{path}: N={n} float32, {k} modes ({N_MODES} held), "
              f"{seconds * 1e3:.1f} ms per structure (first call), "
              f"{again * 1e3:.1f} ms (second) on [{card}]", flush=True)
        torch.cuda.empty_cache()

    invariant = sct.invariant_params(MATFREE_CUTOFF)
    c8 = torch.as_tensor(matfree_coord(N_LARGE), device="cuda")

    def large():
        h = assembly_kernels.hessian_xyz_ensemble(c8[None], invariant)[0]
        vals, vecs = sct.lowest_modes_anm(h, c8, k)
        del h
        return vals, vecs, sct.refine_modes_f64(c8, invariant, vecs,
                                                method="sparse")

    path = "anm_modes_8192"
    (vals, vecs, (theta, _, res)), seconds, launches[path] = drive(path,
                                                                  large)
    torch.cuda.empty_cache()
    again = timed(large)
    worst = float(res[:N_MODES].max())
    shift = float(((theta[:N_MODES] - vals[:N_MODES].double()).abs()
                   / theta[:N_MODES].abs()).max())
    print(f"{path}: N={N_LARGE} float32 (chol engine), refined float64 "
          f"residuals max {worst:.3e} (tol {MATFREE_RESIDUAL_TOL:g}), "
          f"float32 eigenvalues within {shift:.3e} of the refined ones; "
          f"{seconds * 1e3:.1f} ms per structure (first call), "
          f"{again * 1e3:.1f} ms (second) on [{card}]", flush=True)
    check(worst <= MATFREE_RESIDUAL_TOL,
          f"{path}: refined residual {worst:.3e}")
    torch.cuda.empty_cache()
    return launches


def _golden(name, skip_header=0):
    """A golden file of the repository's tests (``tests/data``)."""
    import numpy as np

    return np.genfromtxt(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests", "data", name),
        delimiter=",", skip_header=skip_header)


def _twice(label, fn, card):
    """``fn()`` twice, each call to a synchronize by the host clock; prints
    both times (the model caches its eigensystem and covariance, so a
    second call of an observable reads them) and returns the first
    output."""
    import torch

    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"model_api {label}: {times[0]:.1f} ms (first call), "
          f"{times[1]:.1f} ms (second) on [{card}]", flush=True)
    return out


def _bio3d_field(sct, ca):
    """bio3d's sdENM set-up for a multi-chain structure: the chain breaks
    bonded (``tests/test_anm.py:76-95``)."""
    import numpy as np

    from springcraft_tpu_torch.structure import check_res_id_continuity

    after = check_res_id_continuity(ca)
    pairs = np.stack([after - 1, after], axis=1)
    return sct.PatchedForceField(
        sct.TabulatedForceField.sd_enm(ca), contact_pair_off=pairs,
        contact_pair_on=pairs,
        force_constants=np.full(len(pairs), 43.52 * 0.0083144621 * 300 * 10))


def model_api_paths(ca, card):
    """The reference-compatible model API on the card, float64, on 7cal's
    CA trace (1776 residues): ``ANM`` under eANM with residue masses and
    ``GNM`` under the invariant field at 7 A — every observable, each
    call's first and second time, the Moore-Penrose identities of the
    covariance on random probe blocks (``tests/test_anm.py:46-57``), the
    MSF against the covariance, ``lowest_modes(10, refine=True)`` (K3
    through the ``"invfactor"`` engine) against the dense eigenvalues at
    REFINED_RTOL and ``lowest_modes(10, matrix_free=True)`` (K13 / K14
    over the pair CSR) within MATFREE_RESIDUAL_TOL of them, the residuals
    they return within REFINED_RESIDUAL_FLOORS of the float32 floor and
    MATFREE_RESIDUAL_TOL, both from zero launch counts; ``compute_hessian`` and ``compute_kirchhoff`` against
    the models' matrices; then the golden files the JAX tests read at
    their tolerances (``tests/test_anm.py:73-122``): eANM's eigenvalues
    and MSF against BioPhysConnectoR and bio3d's mass-weighted eigenvalues
    under its three force fields.  Returns ``{path: launches}``."""
    import numpy as np
    import torch

    import springcraft_tpu_torch as sct
    from springcraft_tpu_torch.ops.ffparams import pairwise_sq_distance

    n = ca.array_length()
    launches = {}
    # the cutoff decision of the float32 solve's matrix: the card's float32
    # squared distances are the host's bit for bit; a plain torch.sum over
    # the components, in the card's own order, would decide some pairs of
    # eANM's 13 A cutoff otherwise
    c32 = torch.as_tensor(ca.coord, dtype=torch.float32)
    host = pairwise_sq_distance(c32)[1]
    disp, card_sq = pairwise_sq_distance(c32.cuda())
    flips = int(((disp * disp).sum(dim=-1).cpu() <= 169.0)
                .ne(host <= 169.0).sum()) // 2
    print(f"model_api cutoff: float32 squared distances on the card equal "
          f"the host's: {torch.equal(card_sq.cpu(), host)}; torch.sum over "
          f"the components on the card decides {flips} pair(s) of the 13 A "
          f"cutoff otherwise", flush=True)
    check(torch.equal(card_sq.cpu(), host),
          "model_api: float32 squared distances differ from the host's")
    del c32, host, disp, card_sq
    rng = np.random.RandomState(0)
    probes = rng.randn(3 * n, 16)
    force = rng.randn(n, 3)
    ff = sct.TabulatedForceField.e_anm(ca)
    models = (("ANM", sct.ANM(ca, ff, masses=True), 6, ff),
              ("GNM", sct.GNM(ca, sct.InvariantForceField(7.0)), 1,
               sct.InvariantForceField(7.0)))
    for name, model, trivial, field in models:
        dim = 3 * n if name == "ANM" else n
        vals, vecs = _twice(f"{name}.eigen", model.eigen, card)
        freq = _twice(f"{name}.frequencies", model.frequencies, card)
        msf = _twice(f"{name}.mean_square_fluctuation",
                     model.mean_square_fluctuation, card)
        bfac = _twice(f"{name}.bfactor", model.bfactor, card)
        dcc = _twice(f"{name}.dcc", model.dcc, card)
        cov = _twice(f"{name}.covariance", lambda m=model: m.covariance,
                     card)
        outs = {"eigen values": (vals, (dim,)), "modes": (vecs, (dim, dim)),
                "frequencies": (freq, (dim,)), "msf": (msf, (n,)),
                "bfactor": (bfac, (n,)), "dcc": (dcc, (n, n)),
                "covariance": (cov, (dim, dim))}
        if name == "ANM":
            prs, eff, sens = _twice(f"{name}.prs_effector_sensor",
                                    model.prs_effector_sensor, card)
            lr = _twice(f"{name}.linear_response",
                        lambda m=model: m.linear_response(force), card)
            mode = _twice(f"{name}.normal_mode",
                          lambda m=model: m.normal_mode(6, 1.0, 8), card)
            outs.update({"prs": (prs, (n, n)), "effector": (eff, (n,)),
                         "sensor": (sens, (n,)), "linear_response":
                         (lr, (n, 3)), "normal_mode": (mode, (8, n, 3))})
        for key, (value, shape) in outs.items():
            check(isinstance(value, np.ndarray) and value.shape == shape
                  and bool(np.isfinite(value).all()),
                  f"model_api {name} {key}: not a finite {shape} array")
        matrix = model.hessian if name == "ANM" else model.kirchhoff
        x = probes[:dim]
        hx = matrix @ x
        cx = cov @ x
        check(np.allclose(matrix @ (cov @ hx), hx)
              and np.allclose(cov @ (matrix @ cx), cx),
              f"model_api {name}: covariance fails the Moore-Penrose "
              f"identities on probe blocks")
        traces = np.diagonal(cov).reshape(n, -1).sum(axis=1)
        check(np.allclose(msf, traces), f"model_api {name}: MSF is not the "
              f"covariance's traces")
        if name == "ANM":
            check(np.allclose(lr.reshape(-1), cov @ force.reshape(-1)),
                  "model_api ANM: linear response is not C f")
            unweighted, _ = sct.compute_hessian(ca.coord, field)
            w = 1.0 / np.sqrt(np.repeat(model.masses, 3))
            check(np.allclose(unweighted * w[:, None] * w[None, :], matrix,
                              rtol=1e-12, atol=0),
                  "model_api: compute_hessian is not the model's Hessian")
        else:
            kirchhoff, pairs = sct.compute_kirchhoff(ca.coord, field)
            check(np.array_equal(kirchhoff, matrix)
                  and len(pairs) == int((matrix < 0).sum()),
                  "model_api: compute_kirchhoff is not the model's matrix")
        del matrix, cov, vecs, dcc
        wanted = vals[trivial:trivial + 10]
        for path, kwargs in ((f"model_{name.lower()}_modes",
                              {"refine": True}),
                             (f"model_{name.lower()}_modes_matfree",
                              {"matrix_free": True})):
            def run(m=model, kwargs=kwargs):
                return m.lowest_modes(10, **kwargs)

            (low, _, res), seconds, launches[path] = drive(path, run)
            again = timed(run)
            rel = float(np.max(np.abs(low - wanted) / np.abs(wanted)))
            if "refine" in kwargs:
                tol = REFINED_RTOL
                floor = (np.finfo(np.float32).eps * np.abs(vals).max()
                         / np.abs(low))
                worst = float(np.max(res / floor))
                res_tol, unit = REFINED_RESIDUAL_FLOORS, " floors"
            else:
                tol = res_tol = MATFREE_RESIDUAL_TOL
                worst, unit = float(np.max(res)), ""
            print(f"{path}: {name}.lowest_modes(10, {kwargs}) eigenvalues "
                  f"vs the dense float64 eigen max rel err {rel:.3e} (tol "
                  f"{tol:g}), residuals max {float(np.max(res)):.3e}, "
                  f"{worst:.3g}{unit} (tol {res_tol:g}{unit}); "
                  f"{seconds * 1e3:.1f} ms (first call), {again * 1e3:.1f} "
                  f"ms (second) on [{card}]", flush=True)
            check(rel <= tol, f"{path}: eigenvalues {rel:.3e}")
            check(worst <= res_tol, f"{path}: residual {worst:.3g}{unit}")

    # golden files (tests/test_anm.py:73-122, their tolerances)
    plain = sct.ANM(ca, ff)
    vals = plain.eigen()[0]
    ref = _golden("biophysconnector_anm_eanm_evals_7cal.csv.gz", 1)
    check(np.allclose(vals[6:], ref[6:]),
          "model_api: eANM eigenvalues vs BioPhysConnectoR")
    fluc = plain.mean_square_fluctuation()
    ref_fluc = _golden("biophysconnector_anm_eanm_bfacs_7cal.csv.gz", 1)
    err = float(np.max(np.abs(fluc - ref_fluc) / np.abs(ref_fluc)))
    print(f"model_api golden: eANM eigenvalues vs BioPhysConnectoR within "
          f"np.allclose, max rel err "
          f"{float(np.max(np.abs(vals[6:] - ref[6:]) / ref[6:])):.3e}; MSF "
          f"max rel err {err:.3e}", flush=True)
    check(np.allclose(fluc, ref_fluc), "model_api: eANM MSF vs "
          "BioPhysConnectoR")
    del plain
    masses = _golden("bio3d_mass_7cal.csv.gz")
    for ff_name, field in (("calpha", sct.HinsenForceField()),
                           ("sdenm", _bio3d_field(sct, ca)),
                           ("pfanm", sct.ParameterFreeForceField())):
        vals = sct.ANM(ca, field, masses=masses).eigen()[0]
        ref = _golden(f"bio3d_anm_{ff_name}_ff_evals_mw_7cal.csv.gz")
        err = float(np.max(np.abs(vals[6:] - ref[6:])))
        print(f"model_api golden: bio3d {ff_name} mass-weighted eigenvalues "
              f"max abs err {err:.3e} (rtol 5e-3, atol 2e-3)", flush=True)
        check(np.allclose(vals[6:], ref[6:], rtol=5e-3, atol=2e-3),
              f"model_api: bio3d {ff_name} eigenvalues")
    return launches


def paths(conformers, single, params, card):
    """Drive every dense path of the analytic field once; returns
    ``{path: launches}``."""
    import springcraft_tpu_torch as sct

    # cuBLAS/cuSOLVER set-up before the first timed run
    sct.ensemble_anm_fluctuations(conformers[:CHUNK], params,
                                  inverse="blocked", with_covariance=False,
                                  device="cuda")
    launches = fluctuation_ensemble_paths(
        ("anm_traces", "anm_covariance", "gnm_ensemble"), conformers, params,
        card, (3, 2, 2))
    launches.update(fluctuation_single_paths(("anm_single", "gnm_single"),
                                             single, params, card))
    launches.update(spectral_paths(conformers, single, params, card))
    return launches


def tabulated_paths(conformers, sd_enm, ca_7cal, e_anm, card):
    """Drive the tabulated paths: sdENM over the conformers, eANM on
    7cal's CA trace; returns ``{path: launches}``."""
    launches = fluctuation_ensemble_paths(
        ("anm_tabulated_traces", "anm_tabulated_covariance",
         "gnm_tabulated"), conformers, sd_enm, card, (2, 1, 1))
    launches.update(fluctuation_single_paths(
        ("anm_7cal_eanm", "gnm_7cal_eanm"), ca_7cal, e_anm, card,
        msf_rmse=True))
    return launches


def matfree_coord(n, seed=MATFREE_SEED):
    """Random atoms at protein density, as the JAX package's matrix-free
    benchmark draws them (``bench.py:665-668``)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return (rng.rand(n, 3) * (n / CA_DENSITY) ** (1 / 3)).astype(np.float32)


def sorted_layout(coord, cutoff):
    """Morton-sorted coordinates on the card, the permutation and the
    tile-pair CSR (tile 256), as the solvers set them up."""
    import numpy as np
    import torch

    from springcraft_tpu_torch.ops import matfree

    perm = matfree.spatial_sort_permutation(coord)
    nbr, counts = matfree.tile_neighbor_lists(coord[perm], cutoff, 256)
    csr = matfree.tile_csr(nbr, counts, perm.astype(np.int32),
                           coord.shape[0], 256, DEVICE)
    return torch.as_tensor(coord[perm], device=DEVICE), perm, csr


def sparse_hessian(c, pairs):
    """The Hessian (xyz layout) of the pair CSR `pairs` as a CSR tensor,
    for the library yardstick ``torch.sparse.mm`` (assembly excluded)."""
    import torch

    from springcraft_tpu_torch.ops import matfree

    n = c.shape[0]
    i, j, k = matfree._pair_rows(pairs), pairs.slots.long(), pairs.k
    d = c[i] - c[j]
    g = -k / (d * d).sum(dim=1)
    ar = torch.arange(n, device=c.device)
    rows, cols, vals = [], [], []
    for a in range(3):
        for b in range(3):
            v = g * d[:, a] * d[:, b]
            diag = torch.zeros(n, device=c.device).index_add_(0, i, v)
            rows += [a * n + i, a * n + ar]
            cols += [b * n + j, b * n + ar]
            vals += [v, -diag]
    return torch.sparse_coo_tensor(
        torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals),
        (3 * n, 3 * n)).coalesce().to_sparse_csr()


def sparse_kirchhoff(c, pairs):
    """The Kirchhoff matrix of `pairs` as a CSR tensor (as
    :func:`sparse_hessian`)."""
    import torch

    from springcraft_tpu_torch.ops import matfree

    n = c.shape[0]
    i, j, k = matfree._pair_rows(pairs), pairs.slots.long(), pairs.k
    deg = torch.zeros(n, device=c.device).index_add_(0, i, k)
    ar = torch.arange(n, device=c.device)
    return torch.sparse_coo_tensor(
        torch.stack([torch.cat([i, ar]), torch.cat([j, ar])]),
        torch.cat([-k, deg]), (n, n)).coalesce().to_sparse_csr()


def sd_enm_compact(n, chains=3, seed=0):
    """sdENM for `n` atoms as compact parameters: the 26-bin type tables
    and edges of the force field, residue types drawn as
    :func:`make_ca_atoms` draws them, `chains` equal runs of the array as
    chains (array neighbours bonded within a chain)."""
    import numpy as np

    import springcraft_tpu_torch as sct

    small = sct.TabulatedForceField.sd_enm(
        make_ca_atoms(40)).to_compact_params()
    chain = (np.arange(n) * chains // n).astype(np.int32)
    return small.replace(
        type_idx=np.random.RandomState(seed).randint(0, 20, n).astype(
            np.int32),
        chain_code=chain,
        bonded_next=np.concatenate([chain[:-1] == chain[1:], [False]]))


def context_counts(params, perm, i, j):
    """How many of the ordered pairs of slots ``(i, j)`` (atoms
    ``perm[i]``, ``perm[j]``) take the bonded, the intra-chain and the
    inter-chain table of `params` (in original atom order)."""
    import numpy as np

    a, b = perm[i.cpu().numpy()], perm[j.cpu().numpy()]
    lower = np.minimum(a, b)
    bonded = (np.abs(a - b) == 1) & params.bonded_next[lower]
    same = params.chain_code[a] == params.chain_code[b]
    return {"bonded": int(bonded.sum()), "intra": int((same & ~bonded).sum()),
            "inter": int((~same & ~bonded).sum())}


def sparse_parity(results, params, label):
    """At n = 30,000 on the sorted layout under `params` (in original
    atom order): the pair-CSR build against its plain version (the same
    rows and slots, constants within 1e-6), then K13 and K14 over the
    built list against their plain versions over the same list and
    against the tile walk's, X of the mode paths' 48 columns, timed in
    turns with ``torch.sparse.mm`` of the CSR Hessian / Kirchhoff matrix
    (assembly and build excluded; :func:`gather_parity`).  The build's
    bound counts this run's pairs: it reads the layout, writes 8 bytes a
    pair and tests every visited pair (9 flops)."""
    import numpy as np
    import torch

    from springcraft_tpu_torch.ops import matfree

    n, k = N_MATFREE, MATFREE_BLOCK
    cutoff = float(np.sqrt(params.cutoff_sq))
    c, perm, csr = sorted_layout(matfree_coord(n), cutoff)
    tabulated = params.kind == "table_compact"
    sorted_params = params.permuted(perm) if tabulated else params
    gen = torch.Generator(DEVICE).manual_seed(MATFREE_SEED)
    x3 = torch.randn(3 * n, k, device=DEVICE, generator=gen)
    x1 = torch.randn(n, k, device=DEVICE, generator=gen)

    def build():
        return matfree.pair_csr(c, sorted_params, csr, 256)

    def build_plain():
        return matfree.pair_csr_plain(c, sorted_params, csr, 256)

    pairs, plain = build(), build_plain()
    torch.cuda.synchronize()
    check(torch.equal(pairs.row_ptr, plain.row_ptr)
          and torch.equal(pairs.slots, plain.slots),
          f"pair_csr{label}: the kernel's pairs differ from the plain "
          f"version's")
    k_err = float((pairs.k - plain.k).abs().max())
    k_rel = float(((pairs.k - plain.k).abs()
                   / plain.k.abs().clamp(min=1e-30)).max())
    check(k_rel <= KERNELS["pair_csr"][2],
          f"pair_csr{label}: constants {k_rel:.3e} off the plain version")
    hessian, kirchhoff = sparse_hessian(c, pairs), sparse_kirchhoff(c, pairs)
    i, j = matfree._pair_rows(pairs), pairs.slots.long()
    count = int(pairs.slots.numel())
    tiles = int(csr.cols.numel())
    visited = tiles * 256 ** 2
    counts = context_counts(params, perm, i, j) if tabulated else None
    del i, j
    print(f"matrix-free layout{label}: n={n}, {csr.row_ptr.numel() - 1} row "
          f"tiles, {tiles} tile pairs ({visited:.3e} atom pairs visited), "
          f"{count} ordered pairs within {cutoff} A "
          f"({count / visited:.4%}), pair CSR {8 * count / 1e6:.1f} MB"
          + (f", by table: {json.dumps(counts)}" if tabulated else ""),
          flush=True)
    if tabulated:
        check(min(counts.values()) > 0, f"a table context never occurs: "
              f"{counts}")
    table_bytes = 4 * (params.n_bins * 1200 + len(params.edges_sq) + n) \
        if tabulated else 0
    ms, plain_ms = cuda_ms(build, 5), cuda_ms(build_plain, 1)
    rec = entry((count,), k_err, ms, plain_ms,
                (4 * (3 * n + n + csr.row_ptr.numel() + tiles) + table_bytes
                 + 4 * (n + 1) + 8 * count, 9 * visited))
    print(f"parity pair_csr ({count},){label}: the same rows and slots as "
          f"the plain version, constants max abs err {k_err:.3e}, max rel "
          f"err {k_rel:.3e} (tol {KERNELS['pair_csr'][2]:g}); kernel "
          f"{ms:.4f} ms (count, cumulative sum, fill), plain "
          f"{plain_ms:.4f} ms, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']}), library none", flush=True)
    results.setdefault("pair_csr", []).append(rec)

    walks = {"hessian_apply_sparse": matfree.hessian_apply_sparse_plain,
             "kirchhoff_apply_sparse": matfree.kirchhoff_apply_sparse_plain}
    gather_parity(results, c, pairs, {"hessian_apply_sparse": (x3, hessian),
                                      "kirchhoff_apply_sparse":
                                      (x1, kirchhoff)}, label,
                  lambda name, x: walks[name](c, x, sorted_params, csr, 256))


def gather_parity(results, c, pairs, applies, label, walk=None):
    """K13 and K14 (the names in `applies`, each with its X and its CSR
    matrix for ``torch.sparse.mm``) over `pairs` on `c`: against their
    plain versions over the same list, ``torch.sparse.mm`` and, given
    `walk` (``walk(name, x)``), the tile walk's plain version; timed in
    turns with ``torch.sparse.mm``.  The bounds count this run's pairs:
    the applies read X, the list and the coordinates and write Y once,
    about 12 k + 30 flops a pair for the Hessian (rank-one form and the
    diagonal block), 2 k + 2 for Kirchhoff."""
    import torch

    from springcraft_tpu_torch.ops import matfree

    n, count = c.shape[0], int(pairs.slots.numel())
    list_bytes = 8 * count + 4 * (n + 1)
    plains = {"hessian_apply_sparse": matfree.hessian_apply_pair_csr_plain,
              "kirchhoff_apply_sparse":
              matfree.kirchhoff_apply_pair_csr_plain}
    for name, (x, library) in applies.items():
        k = x.shape[1]
        work = ((list_bytes + 4 * 3 * n + 2 * 4 * 3 * n * k,
                 count * (12 * k + 30)) if name == "hessian_apply_sparse"
                else (list_bytes + 2 * 4 * n * k, count * (2 * k + 2)))
        wrapper = getattr(matfree, name)

        def kernel(wrapper=wrapper, x=x):
            return matfree._apply_pairs(wrapper, c, x, pairs)

        got = kernel()
        refs = [("torch.sparse.mm", lambda x=x, library=library:
                 torch.sparse.mm(library, x))]
        if walk is not None:
            refs.insert(0, ("the tile walk's plain version",
                            lambda x=x, name=name: walk(name, x)))
        for what, ref_fn in refs:
            _, rel = max_errors(got, ref_fn())
            print(f"{name}{label} against {what}: max rel err {rel:.3e} "
                  f"(tol 1e-5)", flush=True)
            check(rel <= 1e-5, f"{name}{label}: {rel:.3e} off {what}")
        check(torch.equal(got, kernel()), f"{name}{label}: two applies "
              f"differ")
        del got
        record(results, name, kernel,
               lambda x=x, plain=plains[name]: plain(c, x, pairs), work,
               lambda x=x, library=library: torch.sparse.mm(library, x),
               plain_reps=3 if walk is not None else 1, label=label,
               turns=True)


def dense_parity(results, params, label):
    """K12 against its plain version at n = 10,000 under `params`, X of
    48 columns; library: ``torch.matmul`` of the dense Hessian, assembly
    excluded.  The bound counts the pairs this family's cutoff passes."""
    import torch

    from springcraft_tpu_torch.ops import matfree

    nd, k = N_MATFREE_DENSE, MATFREE_BLOCK
    cd = torch.as_tensor(matfree_coord(nd), device=DEVICE)
    xd = torch.randn(3 * nd, k, device=DEVICE,
                     generator=torch.Generator(DEVICE).manual_seed(
                         MATFREE_SEED + 1))
    dense = dense_hessian(cd, params)
    pairs = int(torch.count_nonzero(dense[:nd, :nd])) - nd \
        if params.has_cutoff else nd * (nd - 1)
    nbytes = 4 * (3 * nd + 2 * 3 * nd * k)
    if params.kind == "table_compact":
        nbytes += 4 * (params.n_bins * 1200 + len(params.edges_sq or ())
                       + nd)
    record(results, "hessian_apply_dense",
           lambda: matfree.hessian_apply_dense(cd, xd, params),
           lambda: matfree.hessian_apply_dense_plain(cd, xd, params),
           (nbytes, pairs * (12 * k + 30)),
           lambda: torch.matmul(dense, xd), reps=5, plain_reps=3,
           label=label + f" ({pairs} ordered pairs pass)")
    if params.has_cutoff:
        return
    # a row shard of the sharded operator: the same rows of the full call
    # bit for bit; the full call's SHA-256 (its inputs are seeded, so
    # runs of two trees compare)
    full = matfree.hessian_apply_dense(cd, xd, params)
    start, rows = K12_ROW_RANGE
    part = matfree._launch_dense(cd, xd, params, 256, start, rows)
    same = bool(torch.equal(part, full.reshape(3, nd, k)[
        :, start:start + rows].reshape(3 * rows, k)))
    print(f"K12 full call{label} SHA-256 "
          f"{hashlib.sha256(full.cpu().numpy().tobytes()).hexdigest()}; "
          f"rows [{start}, {start + rows}) bit for bit the full call's: "
          f"{same}", flush=True)
    check(same, "K12 row range differs from the full call's rows")
    dense_rows = dense.reshape(3, nd, 3 * nd)[:, start:start + rows]\
        .reshape(3 * rows, 3 * nd)
    del full, dense
    record(results, "hessian_apply_dense",
           lambda: matfree._launch_dense(cd, xd, params, 256, start, rows),
           lambda: matfree.hessian_apply_dense_plain(
               cd, xd, params, row_start=start, n_rows=rows),
           (4 * (3 * nd + 3 * nd * k + 3 * rows * k),
            rows * (nd - 1) * (12 * k + 30)),
           lambda: torch.matmul(dense_rows, xd), reps=5, plain_reps=3,
           label=label + f" rows [{start}, {start + rows})")


def matfree_parity(results):
    """The matrix-free kernels against their plain versions: K13 and K14
    at n = 30,000 under the invariant field (13 A) and under sdENM (their
    table branch; three chains), K12 at n = 10,000 under the cutoff-free
    ``pfenm`` family and under sdENM."""
    import springcraft_tpu_torch as sct

    sparse_parity(results, sct.invariant_params(MATFREE_CUTOFF), "")
    sparse_parity(results, sd_enm_compact(N_MATFREE), " sdENM")
    dense_parity(results, sct.pfenm_params(None), " pfenm")
    dense_parity(results, sd_enm_compact(N_MATFREE_DENSE), " sdENM")


def dense_hessian(c, params):
    """The dense xyz-layout Hessian of `c` ``(n, 3)``, row tile by row
    tile through the plain tile walk (independent of the assembly
    kernels)."""
    import torch

    from springcraft_tpu_torch.ops import matfree

    n = c.shape[0]
    out = torch.zeros((3 * n, 3 * n), device=c.device)
    csr = matfree._dense_csr(n, 256, c.device)
    for rows, slots, d, sq, _, kmat in matfree._tile_pairs(c, csr, 256,
                                                          params):
        r = torch.arange(rows.start, min(rows.stop, n), device=c.device)
        keep = slots < n
        g = -kmat[:r.numel()][:, keep] / torch.where(
            sq == 0, torch.ones_like(sq), sq)[:r.numel()][:, keep]
        dd = d[:r.numel()][:, keep]
        for a in range(3):
            for b in range(3):
                plane = g * dd[..., a] * dd[..., b]
                out[a * n + r, b * n:(b + 1) * n] = plane
                out[a * n + r, b * n + r] -= plane.sum(dim=1)
    return out


def mode_checks(label, vals, vecs, res, apply64, wanted, tol):
    """The returned residuals of the `wanted` modes below `tol`; float64
    relative residuals ``|M u - lambda u| / lambda`` through `apply64`
    (within MATFREE_RESIDUAL_TOL, or `tol` where that is looser) and
    ``|U U^T - I|``."""
    import torch

    check(bool(torch.isfinite(vals).all() and torch.isfinite(vecs).all()),
          f"{label}: non-finite modes")
    u = vecs.double().T
    lam = vals.double()
    r64 = torch.linalg.vector_norm(apply64(u) - u * lam[None], dim=0) \
        / lam.abs()
    orth = float((u.T @ u - torch.eye(u.shape[1], dtype=u.dtype,
                                      device=u.device)).abs().max())
    reported = float(res[:wanted].max())
    tol64 = max(MATFREE_RESIDUAL_TOL, tol)
    print(f"{label}: eigenvalues {vals.tolist()}; reported residuals of the "
          f"{wanted} wanted modes <= {reported:.3e} (tol {tol:g}); float64 "
          f"residuals <= {float(r64[:wanted].max()):.3e} (all {len(vals)}: "
          f"{float(r64.max()):.3e}; tol {tol64:g}), "
          f"|U U^T - I| {orth:.3e} (tol {MATFREE_ORTHO_TOL:g})", flush=True)
    check(reported < tol, f"{label}: reported residual {reported:.3e}")
    check(float(r64[:wanted].max()) <= tol64,
          f"{label}: float64 residual {float(r64[:wanted].max()):.3e}")
    check(orth <= MATFREE_ORTHO_TOL, f"{label}: orthonormality {orth:.3e}")


def true_residual(c64, params, x, b):
    """``|H x - P b| / |P b|`` per column in float64, ``P`` projecting out
    the rigid-body modes."""
    import torch

    from springcraft_tpu_torch.ops import matfree, rigid

    t = rigid.rigid_modes_anm(c64)
    b = b.double()
    pb = b - t @ (t.T @ b)
    hx = matfree.hessian_apply(c64, x.double(), params, dtype=torch.float64)
    return torch.linalg.vector_norm(hx - pb, dim=0) \
        / torch.linalg.vector_norm(pb, dim=0)


def matfree_paths(card, tabulated=False):
    """Drive the four matrix-free paths, under the invariant field (and
    the cutoff-free ``pfenm`` for the dense grid) or, `tabulated`, under
    sdENM (the dense grid by ``sparse=False``); returns ``{path:
    launches}``."""
    import numpy as np
    import torch

    import springcraft_tpu_torch as sct
    from springcraft_tpu_torch.ops import matfree

    n = N_MATFREE
    if tabulated:
        params, suffix, family = sd_enm_compact(n), "_tabulated", "sdENM"
        n_outer, tol = TABULATED_OUTER, TABULATED_TOL
    else:
        params, suffix, family = sct.invariant_params(MATFREE_CUTOFF), "", \
            f"invariant {MATFREE_CUTOFF} A"
        n_outer, tol = 10, MATFREE_TOL
    coord = matfree_coord(n)
    c64 = torch.as_tensor(coord, dtype=torch.float64, device=DEVICE)
    launches = {}

    def modes():
        return sct.lowest_modes_matfree(coord, params, MATFREE_MODES,
                                        degree=96, n_outer=n_outer,
                                        tol=tol)

    path = "anm_matfree_modes" + suffix
    (vals, vecs, res), seconds, launches[path] = drive(path, modes)
    again = timed(modes)
    print(f"{path}: {family}, n={n} ({3 * n} dimensions), "
          f"{MATFREE_MODES} modes, float32: {seconds:.3f} s (first call), "
          f"{again:.3f} s (second) on [{card}]", flush=True)
    mode_checks(path, vals, vecs, res,
                lambda u: matfree.hessian_apply(c64, u, params,
                                                dtype=torch.float64),
                MATFREE_WANTED, tol)

    sites = np.linspace(0, n - 1, 42).astype(np.int64)[::5][:8]
    forces = np.random.RandomState(MATFREE_SEED).randn(n, 3, 4)\
        .astype(np.float32)

    def solve():
        return (sct.dcc_rows_matfree(coord, params, sites, norm=False),
                sct.linear_response_matfree(coord, params, forces))

    path = "anm_matfree_solve" + suffix
    ((rows, it_dcc, res_dcc), (disp, it_lr, res_lr)), seconds, \
        launches[path] = drive(path, solve)
    check(bool(torch.isfinite(rows).all() and torch.isfinite(disp).all()),
          f"{path}: non-finite")
    # the DCC rows' 24 CG columns again, for their float64 true residual
    rhs = np.zeros((3 * n, 3 * len(sites)), np.float32)
    for s, site in enumerate(sites):
        for a in range(3):
            rhs[a * n + site, 3 * s + a] = 1.0
    x, _, _ = sct.covariance_solve_matfree(coord, params, rhs)
    traces = sum(x.reshape(3, n, len(sites), 3)[a, :, :, a]
                 for a in range(3)).T
    check(max_errors(traces, rows)[1] <= 1e-6,
          "dcc rows differ from their CG columns' traces")
    lr_b = torch.as_tensor(forces, device=DEVICE).permute(1, 0, 2)\
        .reshape(3 * n, -1)
    lr_x = disp.permute(1, 0, 2).reshape(3 * n, -1)
    true_dcc = true_residual(c64, params, x, torch.as_tensor(rhs,
                                                             device=DEVICE))
    true_lr = true_residual(c64, params, lr_x, lr_b)
    print(f"{path}: {family}, n={n}, float32, {seconds:.3f} s on [{card}]; "
          f"dcc_rows_matfree 8 sites (24 columns): {it_dcc} CG iterations, "
          f"reported residuals <= {float(res_dcc.max()):.3e}, float64 true "
          f"residuals <= {float(true_dcc.max()):.3e}; "
          f"linear_response_matfree 4 forces: {it_lr} iterations, reported "
          f"<= {float(res_lr.max()):.3e}, true <= {float(true_lr.max()):.3e} "
          f"(tol {CG_TRUE_RESIDUAL_TOL:g})", flush=True)
    check(float(max(true_dcc.max(), true_lr.max())) <= CG_TRUE_RESIDUAL_TOL,
          f"{path}: float64 true residual")
    del x, rows, disp

    def gnm_modes():
        return sct.lowest_modes_matfree_gnm(coord, params, GNM_MATFREE_MODES,
                                            degree=96, n_outer=n_outer,
                                            tol=GNM_MATFREE_TOL)

    path = "gnm_matfree_modes" + suffix
    (vals, vecs, res), seconds, launches[path] = drive(path, gnm_modes)
    print(f"{path}: {family}, n={n}, {GNM_MATFREE_MODES} modes, float32: "
          f"{seconds:.3f} s on [{card}]", flush=True)
    mode_checks(path, vals, vecs, res,
                lambda u: matfree.kirchhoff_apply(c64, u, params,
                                                  dtype=torch.float64),
                GNM_MATFREE_MODES, GNM_MATFREE_TOL)

    nd = N_MATFREE_DENSE
    coord_d = matfree_coord(nd)
    cd64 = torch.as_tensor(coord_d, dtype=torch.float64, device=DEVICE)
    if tabulated:
        dense, options, family = sd_enm_compact(nd), {"sparse": False}, \
            "sdENM on the dense grid (sparse=False)"
    else:
        dense, options, family = sct.pfenm_params(None), {}, \
            "pfenm without cutoff"
    path = "anm_matfree_modes_dense" + suffix
    (vals, vecs, res), seconds, launches[path] = drive(
        path,
        lambda: sct.lowest_modes_matfree(coord_d, dense, MATFREE_MODES,
                                         degree=96, n_outer=n_outer,
                                         tol=tol, **options))
    print(f"{path}: {family}, n={nd} ({3 * nd} dimensions), float32: "
          f"{seconds:.3f} s on [{card}]", flush=True)
    mode_checks(path, vals, vecs, res,
                lambda u: matfree.hessian_apply(cd64, u, dense,
                                                dtype=torch.float64),
                MATFREE_WANTED, tol)
    return launches


def anchor_modes(label, fn, coord, params, matrix, k, trivial, tol):
    """`k` float32 matrix-free eigenvalues of `fn` against float64
    ``torch.linalg.eigvalsh`` of the dense float64 `matrix`."""
    import torch

    vals, _, _ = fn(coord, params, k, degree=96, n_outer=10, tol=tol)
    ref = torch.linalg.eigvalsh(matrix)[trivial:trivial + k]
    rel = float(((vals.double() - ref).abs() / ref).max())
    print(f"anchor {label} n={coord.shape[0]}: {k} float32 matrix-free "
          f"eigenvalues vs float64 eigvalsh, max rel err {rel:.3e} (tol "
          f"{ANCHOR_RTOL:g})", flush=True)
    check(rel <= ANCHOR_RTOL, f"anchor {label}: eigenvalues {rel:.3e}")


def anchor_solve(label, coord, params, h64, c64):
    """24 ``covariance_solve_matfree`` columns against float64
    ``covariance_cholesky`` of the dense float64 Hessian `h64`."""
    import numpy as np
    import torch

    import springcraft_tpu_torch as sct
    from springcraft_tpu_torch.ops import rigid

    n = coord.shape[0]
    sites = np.linspace(0, n - 1, 8).astype(np.int64)
    rhs = np.zeros((3 * n, 3 * len(sites)))
    for s, site in enumerate(sites):
        for a in range(3):
            rhs[a * n + site, 3 * s + a] = 1.0
    x, it, _ = sct.covariance_solve_matfree(coord, params,
                                            rhs.astype(np.float32))
    cov = rigid.covariance_cholesky(h64[None],
                                    rigid.rigid_modes_anm(c64))[0]
    ref = cov @ torch.as_tensor(rhs, device=DEVICE)
    _, rel = max_errors(x, ref)
    print(f"anchor {label} covariance_solve_matfree n={n}: 24 columns ({it} "
          f"CG iterations) vs float64 covariance_cholesky, max rel err "
          f"{rel:.3e} (tol {ANCHOR_RTOL:g})", flush=True)
    check(rel <= ANCHOR_RTOL, f"anchor {label} covariance columns {rel:.3e}")


def matfree_anchor(results):
    """At n = 3,000: the K13 path's 14 eigenvalues and the K14 path's 10
    against float64 ``torch.linalg.eigvalsh`` of the plain float64 Hessian
    and Kirchhoff matrix, ``covariance_solve_matfree`` columns against
    float64 ``covariance_cholesky``; and K13 at this size against
    ``torch.matmul`` of the K5-assembled float32 Hessian (assembly
    excluded)."""
    import torch

    import springcraft_tpu_torch as sct
    from springcraft_tpu_torch.ops import assembly_kernels, matfree
    from springcraft_tpu_torch.parallel import pipeline

    params = sct.invariant_params(MATFREE_CUTOFF)
    n = N_ANCHOR
    coord = matfree_coord(n)
    c64 = torch.as_tensor(coord[None], dtype=torch.float64, device=DEVICE)
    h64 = pipeline._build_hessians_batched(c64, params, None)[0]
    k64 = pipeline._build_kirchhoffs_batched(c64, params, None)[0]
    anchor_modes("anm", sct.lowest_modes_matfree, coord, params, h64,
                 MATFREE_MODES, 6, MATFREE_TOL)
    anchor_modes("gnm", sct.lowest_modes_matfree_gnm, coord, params, k64,
                 GNM_MATFREE_MODES, 1, GNM_MATFREE_TOL)
    anchor_solve("anm", coord, params, h64, c64)
    del h64, k64

    # K13 at the anchor's size against the dense product
    c, _, csr = sorted_layout(coord, MATFREE_CUTOFF)
    h32 = assembly_kernels.hessian_xyz_ensemble(c[None], params)[0]
    xk = torch.randn(3 * n, MATFREE_BLOCK, device=DEVICE,
                     generator=torch.Generator(DEVICE).manual_seed(3))
    pairs = matfree.pair_csr(c, params, csr, 256)
    count = int(pairs.slots.numel())
    record(results, "hessian_apply_sparse",
           lambda: matfree._apply_pairs(matfree.hessian_apply_sparse, c, xk,
                                        pairs),
           lambda: matfree.hessian_apply_pair_csr_plain(c, xk, pairs),
           (8 * count + 4 * (4 * n + 1 + 2 * 3 * n * MATFREE_BLOCK),
            count * (12 * MATFREE_BLOCK + 30)),
           lambda: torch.matmul(h32, xk), plain_reps=3,
           label=" (library: torch.matmul of the K5 Hessian, assembly "
                 "and build excluded)")


def make_patch(coord, cutoff, seed=0):
    """The arguments of a ``PatchedForceField`` on the structure `coord`
    ``(n, 3)``: two atoms shut down and re-attached, each to its six
    nearest neighbours, by switched-on pairs; four pairs inside `cutoff`
    switched off; four pairs beyond it switched on; every switched-on
    pair with a constant of its own."""
    import numpy as np

    rng = np.random.RandomState(seed)
    n = len(coord)
    picks = rng.permutation(n)[:10]
    shut, others = picks[:2], picks[2:]

    def distances(atom):
        return np.linalg.norm(coord - coord[atom], axis=1)

    on, off = [], []
    for atom in shut:
        # each unordered pair once: the two atoms may be neighbours
        on += [(atom, q) for q in np.argsort(distances(atom))[1:7]
               if (q, atom) not in on]
    for atom in others[:4]:
        d = distances(atom)
        d[shut] = 0.0
        inside = np.flatnonzero((d > 0) & (d <= 0.8 * cutoff))
        off.append((atom, inside[np.argmax(d[inside])]))
    for atom in others[4:]:
        d = distances(atom)
        d[shut] = 0.0
        on.append((atom, np.flatnonzero((d > 1.05 * cutoff)
                                        & (d < 1.5 * cutoff))[0]))
    return dict(contact_shutdown=np.asarray(shut),
                contact_pair_off=np.asarray(off),
                contact_pair_on=np.asarray(on),
                force_constants=rng.uniform(0.5, 2.0, len(on)))


def with_patch(params, patch, n):
    """Parameters `params` of `n` atoms under the overlay of `patch`, as a
    ``PatchedForceField`` around their force field lowers it."""
    import springcraft_tpu_torch as sct

    overlay = sct.PatchedForceField(sct.InvariantForceField(1.0), **patch)\
        .to_params(natoms=n).overlays[0]
    return params.replace(overlays=(overlay,))


def overlay_paths(conformers, ca_7cal, e_anm, card):
    """Patch overlays on the dense paths: a ``PatchedForceField`` around
    the invariant field through the three ensemble paths, and eANM's
    compact parameters under a patch on 7cal through ``anm_fluctuations``,
    ``gnm_fluctuations`` and ``gnm_spectral``; each float32 kernel route
    (base family, then the sparse correction) against the float64 engine
    on the dense plain assembly with the same overlay.  Returns ``{path:
    launches}``."""
    import springcraft_tpu_torch as sct

    patched = sct.PatchedForceField(sct.InvariantForceField(CUTOFF),
                                    **make_patch(conformers[0], CUTOFF))
    launches = fluctuation_ensemble_paths(
        ("anm_overlay_traces", "anm_overlay_covariance", "gnm_overlay"),
        conformers, patched, card, (1, 1, 1))
    for path in ("anm_overlay_traces", "anm_overlay_covariance"):
        check(launches[path]["hessian_planes"] == 0,
              f"{path} assembled planes under an overlay")
    coord = ca_7cal.coord
    params = with_patch(e_anm, make_patch(coord, 13.0), len(coord))
    launches.update(fluctuation_single_paths(
        ("anm_7cal_overlay", "gnm_7cal_overlay"), coord, params, card,
        msf_rmse=True))
    n1 = coord.shape[0]
    launches["gnm_spectral_7cal_overlay"] = spectral_single_path(
        "gnm_spectral_7cal_overlay",
        lambda c: sct.gnm_spectral(c, params, device="cuda"), coord,
        {"msf": (n1,), "bfactor": (n1,), "dcc": (n1, n1),
         "covariance": (n1, n1), "eig_values": (n1,), "frequencies": (n1,)},
        "gnm", params, 1, {"covariance": SINGLE_COV_TOL}, card)
    return launches


def matfree_overlay_paths(card):
    """Patch overlays on the matrix-free paths at n = 3,000, in Morton
    order on the card, against float64 dense assembly with the same
    overlay: the invariant field's modes; sdENM's modes, GNM modes and
    covariance columns.  Returns ``{path: launches}``."""
    import torch

    import springcraft_tpu_torch as sct
    from springcraft_tpu_torch.ops import ffparams
    from springcraft_tpu_torch.parallel import pipeline

    n = N_ANCHOR
    coord = matfree_coord(n)
    c64 = torch.as_tensor(coord[None], dtype=torch.float64, device=DEVICE)
    launches = {}
    for suffix, base in (("", sct.invariant_params(MATFREE_CUTOFF)),
                         ("_tabulated", sd_enm_compact(n))):
        params = with_patch(base, make_patch(coord, base.cutoff_sq ** 0.5),
                            n)
        _, _, delta, _, _ = ffparams.overlay_pair_delta(c64[0], params)
        print(f"overlay{suffix} n={n}: {delta.numel()} candidate pairs, "
              f"{int((delta != 0).sum())} changed, largest |k_patched - "
              f"k_base| {float(delta.abs().max()):.4f}", flush=True)
        check(int((delta != 0).sum()) >= 16, "the overlay changes nothing")
        h64 = pipeline._build_hessians_batched(c64, params, None)[0]
        path = "anm_matfree_overlay" + suffix

        def anm():
            anchor_modes(path, sct.lowest_modes_matfree, coord, params, h64,
                         MATFREE_MODES, 6, MATFREE_TOL)
            if suffix:
                anchor_solve(path, coord, params, h64, c64)

        _, seconds, launches[path] = drive(path, anm)
        print(f"{path}: {seconds:.3f} s on [{card}]", flush=True)
        del h64
        if suffix:
            k64 = pipeline._build_kirchhoffs_batched(c64, params, None)[0]
            path = "gnm_matfree_overlay" + suffix
            _, seconds, launches[path] = drive(path, lambda: anchor_modes(
                path, sct.lowest_modes_matfree_gnm, coord, params, k64,
                GNM_MATFREE_MODES, 1, GNM_MATFREE_TOL))
            print(f"{path}: {seconds:.3f} s on [{card}]", flush=True)
            del k64
    return launches


def large_assembly(results, card):
    """The assembly kernels at large n (column atoms read from device
    memory at any size): K1, K5 and K6 on one structure of 8,192 atoms
    against their plain versions under the invariant field and sdENM;
    then the path:
    the three wrappers at 8,192 atoms under both families and one
    ``hessian_xyz`` at n = 30,000 (a 32.4 GB Hessian), timed, and held
    without a plain Hessian by ``H @ X`` against K13 on the same
    coordinates.  Returns ``{path: launches}``."""
    import torch

    import springcraft_tpu_torch as sct
    from springcraft_tpu_torch.ops import assembly, assembly_kernels, matfree

    torch.cuda.empty_cache()
    n = N_LARGE
    c = torch.as_tensor(matfree_coord(n)[None], device=DEVICE)
    families = ((sct.invariant_params(MATFREE_CUTOFF), " invariant 13 A"),
                (sd_enm_compact(n), " sdENM"))
    for p, label in families:
        extra = 4 * (p.n_bins * 1200 + len(p.edges_sq or ()) + n) \
            if p.kind == "table_compact" else 0
        for name, kernel, plain, per_pair, flops in (
                ("hessian_planes", assembly_kernels.hessian_planes_ensemble,
                 assembly.hessian_planes_plain, 9, 30),
                ("hessian_xyz", assembly_kernels.hessian_xyz_ensemble,
                 assembly.hessian_xyz_plain, 9, 30),
                ("kirchhoff", assembly_kernels.kirchhoff_ensemble,
                 assembly.kirchhoff_plain, 1, 10)):
            record(results, name, lambda: kernel(c, p), lambda: plain(c, p),
                   (4 * (3 * n + per_pair * n * n) + extra, flops * n * n),
                   reps=5, plain_reps=2, label=label)
            torch.cuda.empty_cache()

    n30 = N_MATFREE
    invariant = families[0][0]
    c30, _, csr = sorted_layout(matfree_coord(n30), MATFREE_CUTOFF)
    x = torch.randn(3 * n30, MATFREE_BLOCK, device=DEVICE,
                    generator=torch.Generator(DEVICE).manual_seed(5))

    def path():
        for p, _ in families:
            assembly_kernels.hessian_planes_ensemble(c, p)
            assembly_kernels.hessian_xyz_ensemble(c, p)
            assembly_kernels.kirchhoff_ensemble(c, p)
        hessian = assembly_kernels.hessian_xyz_ensemble(c30[None],
                                                        invariant)[0]
        return hessian @ x

    torch.cuda.synchronize()
    y, seconds, launches = drive("assembly_large", path)
    ref = matfree._apply_pairs(matfree.hessian_apply_sparse, c30, x,
                               matfree.pair_csr(c30, invariant, csr, 256))
    err, rel = max_errors(y, ref)
    del y, ref
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: assembly_kernels.hessian_xyz_ensemble(
        c30[None], invariant) is None, reps=3)
    nbytes = 4 * (3 * n30 + 9 * n30 * n30)
    rec = entry((1, 3 * n30, 3 * n30), err, ms, None,
                (nbytes, 30 * n30 * n30))
    results["hessian_xyz"].append(rec)
    print(f"assembly_large: hessian_xyz (1, {n30}) invariant 13 A, "
          f"{nbytes / 1e9:.1f} GB: kernel {ms:.4f} ms (3 calls), bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), no plain version "
          f"at this size; (H @ X) against K13 on the same coordinates, X of "
          f"{MATFREE_BLOCK} columns: max abs err {err:.3e}, max rel err "
          f"{rel:.3e} (tol 1e-5); path {seconds:.3f} s on [{card}]",
          flush=True)
    check(rel <= 1e-5, f"assembly_large: H @ X differs from K13 by {rel:.3e}")
    torch.cuda.empty_cache()
    return {"assembly_large": launches}


def _z_scores(label, est, sem, truth, floor=None):
    """Max |est - truth| / sem over the entries where the estimate is off
    its exact rank-k floor (`floor`: the estimator's clamp, where the
    truth may lie up to a standard error above the estimate); fails above
    STDERR_BOUND.  Returns the max."""
    import torch

    dev = (est - truth).abs()
    z = dev / sem.clamp(min=1e-300)
    if floor is not None:
        z = torch.where(est <= floor * (1 + 1e-12), torch.zeros_like(z), z)
    worst = float(z.max())
    check(worst <= STDERR_BOUND, f"{label}: an estimate lies {worst:.2f} "
          f"standard errors from its exact value (bound {STDERR_BOUND})")
    return worst


def _spearman(x, y):
    import numpy as np

    rx = np.argsort(np.argsort(x)).astype(np.float64)
    ry = np.argsort(np.argsort(y)).astype(np.float64)
    rx -= rx.mean()
    ry -= ry.mean()
    return float((rx @ ry) / np.sqrt((rx @ rx) * (ry @ ry)))


def matfree_profile_paths(card):
    """The second matrix-free slice at N_MATFREE atoms (seed 4, invariant
    13 A), the second half of the JAX package's matrix-free benchmark
    (``bench.py:726-868``): 14 modes, then the exact effector/sensor
    values at 42 sites (126 CG columns, their float64 true residual), the
    mode-sum and stochastic ``prs_diag`` against the exact ``P_ss`` of the
    site columns, the full-atom mode-sum profiles, the stochastic profiles
    (48 probes, 14 exact control-variate columns: 110 CG columns) against
    the CG expectations at the sites, the stochastic MSF against the
    ``dcc_rows_matfree`` truth at 8 sites; the GNM stochastic MSF against
    ``dcc_rows_matfree_gnm``; then the model-API routes on 7cal against
    the dense float64 model.  Returns ``{path: launches}``."""
    import numpy as np
    import torch

    import springcraft_tpu_torch as sct

    n = N_MATFREE
    params = sct.invariant_params(MATFREE_CUTOFF)
    coord = matfree_coord(n)
    c64 = torch.as_tensor(coord, dtype=torch.float64, device=DEVICE)
    launches = {}
    t0 = time.perf_counter()
    vals, vecs, res = sct.lowest_modes_matfree(
        coord, params, MATFREE_MODES, degree=96, n_outer=10, tol=MATFREE_TOL)
    modes = (vals, vecs)
    torch.cuda.synchronize()
    worst = float(res[:MATFREE_WANTED].max())
    print(f"matfree_profiles: {MATFREE_MODES} modes of n={n}, residuals of "
          f"the {MATFREE_WANTED} wanted <= {worst:.3e}, "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    sites = np.linspace(0, n - 1, PROFILE_SITES).astype(np.int64)
    site_t = torch.as_tensor(sites, device=DEVICE)
    prs_diag = sct.prs_diag_from_modes(vals, vecs, layout="xyz")
    nm1 = n - 1

    path = "anm_effector_sensor_sites"
    (eff, sens, it, res, self_p), seconds, launches[path] = drive(
        path, lambda: sct.effector_sensor_matfree(
            coord, params, sites, prs_diag=prs_diag, return_diag=True))
    rhs = torch.zeros((3 * n, 3 * len(sites)), device=DEVICE)
    for a in range(3):
        rhs[a * n + site_t, 3 * torch.arange(len(sites), device=DEVICE)
            + a] = 1.0
    x, _, _ = sct.covariance_solve_matfree(coord, params, rhs)
    true = true_residual(c64, params, x, rhs)
    p_ss = (x.double().reshape(3, n, len(sites), 3) ** 2).sum(dim=(0, 3))[
        site_t, torch.arange(len(sites), device=DEVICE)]
    print(f"{path}: n={n}, {len(sites)} sites ({3 * len(sites)} CG "
          f"columns): {seconds:.3f} s, {it} CG iterations, reported "
          f"residuals <= {float(res.max()):.3e}, float64 true residuals "
          f"<= {float(true.max()):.3e} (tol {CG_TRUE_RESIDUAL_TOL:g}) on "
          f"[{card}]", flush=True)
    check(float(true.max()) <= CG_TRUE_RESIDUAL_TOL,
          f"{path}: float64 true residual {float(true.max()):.3e}")
    check(max_errors(p_ss, self_p)[1] <= 1e-6,
          f"{path}: P_ss differs from its CG columns'")
    del x, rhs
    modesum_dev = float(((prs_diag[site_t] - self_p).abs() / self_p).max())
    check(bool((prs_diag[site_t] <= self_p * (1 + MODEL_PROFILE_TOL)).all()),
          f"{path}: the rank-{MATFREE_MODES} prs_diag exceeds the exact "
          f"P_ss (it is a lower bound)")

    path = "anm_prs_diag_stochastic"
    (pd_st, pd_sem, pd_it, pd_res), seconds, launches[path] = drive(
        path, lambda: sct.prs_diag_stochastic(
            coord, params, modes, probes=PROFILE_PROBES,
            seed=PROFILE_SEEDS["prs_diag"]))
    pd_dev = float(((pd_st[site_t] - self_p).abs() / self_p).max())
    floor = sct.prs_diag_from_modes(vals, vecs)[site_t]
    pd_z = _z_scores(path, pd_st[site_t], pd_sem[site_t], self_p, floor)
    print(f"{path}: {PROFILE_PROBES} probes, {seconds:.3f} s, {pd_it} CG "
          f"iterations, residuals <= {float(pd_res.max()):.3e}; against "
          f"the exact P_ss at the {len(sites)} sites: max rel deviation "
          f"{pd_dev:.3f} (the rank-{MATFREE_MODES} mode-sum's "
          f"{modesum_dev:.3f}), max |dev|/stderr {pd_z:.2f} (bound "
          f"{STDERR_BOUND})", flush=True)

    t0 = time.perf_counter()
    eff_full, sens_full = sct.effector_sensor_from_modes(
        vals[:MATFREE_WANTED], vecs[:MATFREE_WANTED], layout="xyz")
    torch.cuda.synchronize()
    full_ms = (time.perf_counter() - t0) * 1e3
    check(bool(torch.isfinite(eff_full).all() and torch.isfinite(
        sens_full).all()), "effector_sensor_from_modes: non-finite")
    eff_np, sens_np = eff.cpu().numpy(), sens.cpu().numpy()
    print(f"effector_sensor_from_modes: n={n}, k={MATFREE_WANTED}: "
          f"{full_ms:.1f} ms; against the exact CG values at the sites: "
          f"effector Spearman "
          f"{_spearman(eff_full[site_t].cpu().numpy(), eff_np):.3f}, "
          f"sensor Spearman "
          f"{_spearman(sens_full[site_t].cpu().numpy(), sens_np):.3f}",
          flush=True)

    path = "anm_effector_sensor_stochastic"
    (eff_st, sens_st, eff_sem, sens_sem, st_it, st_res), seconds, \
        launches[path] = drive(path, lambda: sct.effector_sensor_stochastic(
            coord, params, prs_diag, probes=PROFILE_PROBES,
            seed=PROFILE_SEEDS["profiles"], modes=modes))
    check(st_res.shape == (2 * PROFILE_PROBES + MATFREE_MODES,),
          f"{path}: {tuple(st_res.shape)} CG columns")
    # the exact expectations from the CG values: the routes subtract other
    # self terms and normalizers (bench.py:805-820)
    pd_s = prs_diag[site_t]
    eff_expect = (eff * nm1 * self_p + self_p - pd_s) / (nm1 * pd_s)
    sens_expect = sens + (self_p / pd_s - 1.0) / nm1
    eff_z = _z_scores(path + " effector", eff_st[site_t], eff_sem[site_t],
                      eff_expect)
    sens_z = _z_scores(path + " sensor", sens_st[site_t], sens_sem[site_t],
                       sens_expect)
    ranks = [_spearman(got[site_t].cpu().numpy(), want.cpu().numpy())
             for got, want in ((eff_st, eff_expect), (sens_st, sens_expect))]
    print(f"{path}: {PROFILE_PROBES} probes, rank-{MATFREE_MODES} control "
          f"variate, {st_res.numel()} CG columns: {seconds:.3f} s, {st_it} "
          f"iterations, residuals <= {float(st_res.max()):.3e}; against the "
          f"CG expectations at the sites: effector Spearman {ranks[0]:.3f} "
          f"(max |dev|/stderr {eff_z:.2f}), sensor Spearman {ranks[1]:.3f} "
          f"(max |dev|/stderr {sens_z:.2f}; bound {STDERR_BOUND})",
          flush=True)

    msf_sites = sites[::5][:8]
    msf_t = torch.as_tensor(msf_sites, device=DEVICE)
    gnm_modes = sct.lowest_modes_matfree_gnm(
        coord, params, GNM_MATFREE_MODES, degree=96, n_outer=10,
        tol=GNM_MATFREE_TOL)[:2]
    for family, est, rows_fn, fam_modes in (
            ("anm", sct.msf_stochastic, sct.dcc_rows_matfree, modes),
            ("gnm", sct.msf_stochastic_gnm, sct.dcc_rows_matfree_gnm,
             gnm_modes)):
        path = f"{family}_msf_stochastic"
        t0 = time.perf_counter()
        rows, _, dcc_res = rows_fn(coord, params, msf_sites, norm=False)
        truth = rows.double()[torch.arange(len(msf_sites), device=DEVICE),
                              msf_t]
        truth_s = time.perf_counter() - t0
        (msf, sem, ms_it, ms_res), seconds, launches[path] = drive(
            path, lambda est=est, fam_modes=fam_modes: est(
                coord, params, fam_modes, probes=PROFILE_PROBES,
                seed=PROFILE_SEEDS["msf"]))
        v64, u64 = fam_modes[0].double(), fam_modes[1].double()
        msf_k = ((u64.reshape(len(v64), -1, n) ** 2).sum(dim=1)
                 / v64[:, None]).sum(dim=0)[msf_t]
        ms_z = _z_scores(path, msf[msf_t], sem[msf_t], truth, msf_k)
        print(f"{path}: {PROFILE_PROBES} probes, rank-{len(v64)} deflation: "
              f"{seconds:.3f} s, {ms_it} CG iterations, residuals <= "
              f"{float(ms_res.max()):.3e}; against the exact covariance "
              f"traces at 8 sites ({truth_s:.3f} s, CG residuals <= "
              f"{float(dcc_res.max()):.3e}): mode-sum max rel deviation "
              f"{float(((msf_k - truth).abs() / truth).max()):.3f}, "
              f"stochastic "
              f"{float(((msf[msf_t] - truth).abs() / truth).max()):.4f} "
              f"(max |dev|/stderr {ms_z:.2f}; bound {STDERR_BOUND}) on "
              f"[{card}]", flush=True)
    launches.update(model_profile_paths(load_7cal_ca(), card))
    return launches


def model_profile_paths(ca, card):
    """The model-API routes of the second matrix-free slice on 7cal
    (``ANM`` eANM with residue masses, ``GNM`` invariant 7 A): the
    stochastic MSF and B-factors with ``modes=10`` against the dense
    float64 MSF, the DCC rows (``norm=False`` against the dense DCC; the
    in-place stochastic normalizer), and the three
    ``prs_effector_sensor(matrix_free=True)`` routes (``sites=`` with
    ``norm=False`` against the dense profiles).  Returns ``{path:
    launches}``."""
    import numpy as np

    import springcraft_tpu_torch as sct

    sites = [0, 500, 1000, 1775]
    launches = {}
    for name, model in (
            ("anm", sct.ANM(ca, sct.TabulatedForceField.e_anm(ca),
                            masses=True)),
            ("gnm", sct.GNM(ca, sct.InvariantForceField(7.0)))):
        dense_msf = model.mean_square_fluctuation()
        dense_dcc = model.dcc(norm=False)[sites]
        path = f"model_{name}_profiles"

        def run(m=model):
            out = {"msf": m.mean_square_fluctuation(
                       matrix_free=True, modes=10, probes=PROFILE_PROBES),
                   "bfactor": m.bfactor(matrix_free=True, modes=10,
                                        probes=PROFILE_PROBES),
                   "dcc": m.dcc(matrix_free=True, sites=sites, modes=10,
                                probes=PROFILE_PROBES),
                   "dcc_raw": m.dcc(matrix_free=True, sites=sites,
                                    norm=False)}
            if name == "anm":
                out["prs_sites"] = m.prs_effector_sensor(
                    matrix_free=True, sites=sites, norm=False)
                out["prs_sites_norm"] = m.prs_effector_sensor(
                    matrix_free=True, sites=sites, modes=10)
                out["prs_modes"] = m.prs_effector_sensor(
                    matrix_free=True, modes=10)
                out["prs_probes"] = m.prs_effector_sensor(
                    matrix_free=True, probes=PROFILE_PROBES, modes=10)
            return out

        out, seconds, launches[path] = drive(path, run)
        for key, value in out.items():
            arrays = [v for v in (value if isinstance(value, tuple)
                                  else (value,)) if v is not None]
            check(all(isinstance(v, np.ndarray) and np.isfinite(v).all()
                      for v in arrays), f"{path} {key}: not finite NumPy")
        msf, sem = out["msf"]
        scale = np.abs(dense_msf).max()
        msf_z = float(np.max(np.maximum(
            np.abs(msf - dense_msf) - MODEL_PROFILE_TOL * scale, 0.0)
            / np.maximum(sem, 1e-300)))
        check(msf_z <= STDERR_BOUND, f"{path}: stochastic MSF {msf_z:.2f} "
              f"standard errors off the dense MSF")
        check(np.allclose(out["bfactor"][0], 8 * np.pi ** 2 / 3 * msf),
              f"{path}: B-factors are not the MSF's")
        dcc_err = _model_rel(out["dcc_raw"], dense_dcc)
        check(dcc_err <= MODEL_PROFILE_TOL, f"{path}: DCC rows {dcc_err:.3e}")
        line = (f"{path}: {type(model).__name__} on 7cal, first call "
                f"{seconds:.3f} s on [{card}]; stochastic MSF (modes=10, "
                f"{PROFILE_PROBES} probes) max rel err "
                f"{float(np.max(np.abs(msf - dense_msf) / dense_msf)):.3e}, "
                f"max |dev|/stderr beyond {MODEL_PROFILE_TOL:g} of max "
                f"{msf_z:.2f}; DCC rows (norm=False) {dcc_err:.3e}")
        if name == "anm":
            _, eff, sens = model.prs_effector_sensor(norm=False)
            errs = [_model_rel(out["prs_sites"][1], eff[sites]),
                    _model_rel(out["prs_sites"][2], sens[sites])]
            check(max(errs) <= MODEL_PROFILE_TOL,
                  f"{path}: site profiles {max(errs):.3e}")
            line += (f"; site profiles (norm=False) {max(errs):.3e} (tol "
                     f"{MODEL_PROFILE_TOL:g} each)")
        print(line, flush=True)
    return launches


def _model_rel(got, ref):
    import numpy as np

    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


@contextlib.contextmanager
def stage_clock(module, names, seconds, captured):
    """Wrap the functions `names` of `module` for the block: each call
    adds its wall seconds, to a device synchronize, to ``seconds[name]``
    and leaves ``(args, result)`` in ``captured[name]``."""
    import torch

    originals = {name: getattr(module, name) for name in names}

    def clocked(name, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
            captured[name] = (args, out)
            return out
        return call

    for name, fn in originals.items():
        setattr(module, name, clocked(name, fn))
    try:
        yield
    finally:
        for name, fn in originals.items():
            setattr(module, name, fn)


def matfree_xl_paths(results, card):
    """matrix-free-xl (``bench.py:871-925``): one RandomState(XL_SEED)
    draws 100,000 atoms at CA density for the ANM and then 1,000,000 for
    the GNM (invariant 13 A); ``lowest_modes_matfree[_gnm]`` from zero
    launch counts with the set-up's stages clocked (Morton sort, tile
    lists, tile CSR, the Gershgorin bound off the pair CSR; the pair-CSR
    build timed again alone), then ``refine_modes_f64[_gnm]`` (its cKDTree
    pair search clocked) and the refined residuals held to the XL
    thresholds; K13 at 100,000 atoms and K14 at 1,000,000 against their
    plain versions and ``torch.sparse.mm`` on the solver's own pair CSR.
    Prints each stage's seconds and the peak device memory.  Returns
    ``{path: launches}``."""
    import numpy as np
    import torch

    import springcraft_tpu_torch as sct
    from springcraft_tpu_torch.ops import matfree
    from springcraft_tpu_torch.ops import modes as modes_ops
    from springcraft_tpu_torch.ops import pairs as pairs_ops

    rng = np.random.RandomState(XL_SEED)
    params = sct.invariant_params(MATFREE_CUTOFF)
    eps32 = float(np.finfo(np.float32).eps)
    launches = {}
    for family, n, k, wanted, n_outer in (
            ("anm", N_XL_ANM, XL_ANM_MODES, XL_ANM_WANTED, XL_ANM_OUTER),
            ("gnm", N_XL_GNM, XL_GNM_MODES, XL_GNM_WANTED, XL_GNM_OUTER)):
        torch.cuda.empty_cache()
        anm = family == "anm"
        spread = (n / CA_DENSITY) ** (1 / 3)
        t0 = time.perf_counter()
        coord = (rng.rand(n, 3) * spread).astype(np.float32)
        stages = {"draw": time.perf_counter() - t0}
        captured = {}
        solver = (sct.lowest_modes_matfree if anm
                  else sct.lowest_modes_matfree_gnm)
        path = f"{family}_matfree_xl"
        with stage_clock(matfree, ("spatial_sort_permutation",
                                   "tile_neighbor_lists", "tile_csr",
                                   "_pair_degree_bound"), stages, captured):
            (vals, vecs, res), stages["solve"], launches[path] = drive(
                path, lambda solver=solver, coord=coord, k=k,
                n_outer=n_outer: solver(coord, params, k, degree=96,
                                        n_outer=n_outer, tol=XL_TOL,
                                        retries=0))
        solve_peak = torch.cuda.max_memory_allocated() / 2**30
        (coord_s, params_s, pairs, _, _), lam_max = \
            captured["_pair_degree_bound"]
        csr = captured["tile_csr"][1]
        stages["pair_csr"] = cuda_ms(
            lambda: matfree.pair_csr(coord_s, params_s, csr, 256), 3) / 1e3
        check(bool(torch.isfinite(vals).all() and torch.isfinite(vecs).all()),
              f"{path}: non-finite modes")
        torch.cuda.reset_peak_memory_stats()
        with stage_clock(pairs_ops, ("neighbor_pairs",), stages, captured):
            t0 = time.perf_counter()
            ref_vals, _, ref_res = (
                modes_ops.refine_modes_f64(coord, params, vecs, layout="xyz")
                if anm else modes_ops.refine_modes_f64_gnm(coord, params,
                                                           vecs))
            torch.cuda.synchronize()
            stages["refine"] = time.perf_counter() - t0
        refine_peak = torch.cuda.max_memory_allocated() / 2**30
        raw = vals[:wanted].double()
        rtol = float(((raw - ref_vals[:wanted]).abs()
                      / ref_vals[:wanted]).max())
        floors = eps32 * float(lam_max) / ref_vals[:wanted]
        limit = torch.clamp(torch.maximum(
            XL_RESIDUAL_GROWTH * res[:wanted].double(),
            REFINED_RESIDUAL_FLOORS * floors), max=XL_RESIDUAL_CAP)
        worst = float((ref_res[:wanted] / limit).max())
        count = int(pairs.slots.numel())
        print(f"{path}: n={n} ({(3 if anm else 1) * n} dimensions), "
              f"{wanted}(+{k - wanted}) modes, degree 96, {n_outer} outer "
              f"iterations, tol {XL_TOL:g}: float32 residuals of the wanted "
              f"<= {float(res[:wanted].max()):.3e} (all {k}: "
              f"{float(res.max()):.3e}); refined float64 residuals "
              f"{[f'{r:.3e}' for r in ref_res[:wanted].tolist()]}, at most "
              f"{worst:.3f} of their limits (the larger of "
              f"{XL_RESIDUAL_GROWTH:g} x the float32 residual and "
              f"{REFINED_RESIDUAL_FLOORS} floors eps_f32 * "
              f"{float(lam_max):.4g} / theta, at most {XL_RESIDUAL_CAP:g}); "
              f"raw-vs-refined "
              f"eigenvalue rtol {rtol:.3e}; refined eigenvalues "
              f"{[f'{v:.6g}' for v in ref_vals[:wanted].tolist()]}; "
              f"{count} ordered pairs ({8 * count / 1e6:.1f} MB); seconds: "
              + ", ".join(f"{key} {value:.3f}" for key, value in
                          stages.items())
              + f"; peak device memory {solve_peak:.2f} GiB (solve), "
              f"{refine_peak:.2f} GiB (refinement) on [{card}]", flush=True)
        check(worst <= 1.0, f"{path}: a refined residual exceeds its limit "
              f"({worst:.3f} of it)")
        del vecs, csr
        torch.cuda.empty_cache()
        gen = torch.Generator(DEVICE).manual_seed(XL_SEED)
        name = "hessian_apply_sparse" if anm else "kirchhoff_apply_sparse"
        x = torch.randn((3 if anm else 1) * n, MATFREE_BLOCK, device=DEVICE,
                        generator=gen)
        library = (sparse_hessian if anm else sparse_kirchhoff)(coord_s,
                                                               pairs)
        gather_parity(results, coord_s, pairs, {name: (x, library)},
                      f" xl n={n}")
        del x, library, pairs, coord_s, params_s
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# The large-structure path: BinaryCIF / mmCIF files -> structure ->
# checkpointed, resumed matrix-free modes -> results on disk
# ---------------------------------------------------------------------------

#: BinaryCIF ByteArray type codes (BinaryCIF 0.3).
_BCIF_TYPES = {"i1": 1, "i2": 2, "i4": 3, "u1": 4, "u2": 5, "u4": 6,
               "f4": 32, "f8": 33}
#: The mmCIF ``atom_site`` columns the writers emit, in order.
CIF_COLUMNS = ("group_PDB", "id", "type_symbol", "label_atom_id",
               "label_alt_id", "label_comp_id", "label_asym_id",
               "label_seq_id", "Cartn_x", "Cartn_y", "Cartn_z", "occupancy",
               "B_iso_or_equiv", "auth_seq_id", "auth_asym_id",
               "pdbx_PDB_model_num")
#: Chains of the large structure: four of equal length, one with a
#: two-character ID (PDB's chain column holds one).
LARGE_CHAINS = ("A", "B", "C", "AA")
#: Outer iteration after which the checkpointed solves are interrupted.
INTERRUPT_AFTER = 3


def large_structure(n, seed=XL_SEED, chains=LARGE_CHAINS):
    """The matrix-free-xl ANM atoms (``matfree_coord(n, seed)``: the first
    draw of ``matfree_xl_paths``), rounded to 3 decimals, as a CA trace of
    ``len(chains)`` equal chains numbered from 1 (residue IDs past 9,999
    at 100,000 atoms), residue types cycling through AA20.  Returns
    ``(atoms, drawn float32 coordinates, written float64 coordinates)``."""
    import numpy as np

    from springcraft_tpu_torch.structure import AtomArray

    drawn = matfree_coord(n, seed)
    written = np.round(drawn.astype(np.float64), 3)
    per_chain = n // len(chains)
    atoms = AtomArray(n)
    atoms.coord = written
    atoms.chain_id = np.repeat(np.array(chains), per_chain)
    atoms.res_id = np.tile(np.arange(1, per_chain + 1), len(chains))
    atoms.res_name = np.array(AA20)[np.arange(n) % len(AA20)]
    atoms.atom_name = np.full(n, "CA")
    atoms.element = np.full(n, "C")
    return atoms, drawn, written


def write_mmcif(path, atoms, coord_models=None):
    """`atoms` as an mmCIF ``atom_site`` loop (gzipped for a ``.gz``
    path), one model per entry of `coord_models` ``(m, n, 3)``
    (``atoms.coord`` alone by default); coordinates to 3 decimals."""
    import gzip

    import numpy as np

    models = (np.asarray(atoms.coord)[None] if coord_models is None
              else np.asarray(coord_models))
    n = atoms.array_length()
    rows = list(zip(*(np.asarray(getattr(atoms, name)).tolist() for name in (
        "element", "atom_name", "res_name", "chain_id", "res_id"))))
    lines = ["data_LARGE", "#", "loop_"]
    lines += [f"_atom_site.{name}" for name in CIF_COLUMNS]
    for m, coord in enumerate(models, start=1):
        for i, ((element, name, res, chain, seq), (x, y, z)) in enumerate(
                zip(rows, coord.tolist())):
            lines.append(
                f"ATOM {(m - 1) * n + i + 1} {element} {name} . {res} "
                f"{chain} {seq} {x:.3f} {y:.3f} {z:.3f} 1.00 0.00 {seq} "
                f"{chain} {m}")
    text = "\n".join(lines + ["#", ""])
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wt") as fh:
        fh.write(text)


def _bcif_byte_array(values, dtype):
    import numpy as np

    data = np.asarray(values).astype(np.dtype(dtype).newbyteorder("<"))
    return data.tobytes(), {"kind": "ByteArray", "type": _BCIF_TYPES[dtype]}


def _bcif_fixed_point(values, factor=1000):
    import numpy as np

    ints = np.round(np.asarray(values, np.float64) * factor).astype(np.int64)
    return ints, {"kind": "FixedPoint", "factor": factor, "srcType": 33}


def _bcif_delta(values):
    import numpy as np

    values = np.asarray(values, np.int64)
    diffs = np.diff(values, prepend=values[:1])
    return diffs, {"kind": "Delta", "origin": int(values[0]), "srcType": 3}


def _bcif_run_length(values):
    import numpy as np

    values = np.asarray(values, np.int64)
    starts = np.flatnonzero(np.r_[True, values[1:] != values[:-1]])
    counts = np.diff(np.r_[starts, len(values)])
    pairs = np.stack([values[starts], counts], axis=1).reshape(-1)
    return pairs, {"kind": "RunLength", "srcType": 3,
                   "srcSize": len(values)}


def _bcif_integer_packing(values, byte_count):
    """Signed upper-limit packing: a value past the limit becomes runs of
    the limit and a remainder (the inverse of ``bcif``'s decoder)."""
    import numpy as np

    values = np.asarray(values, np.int64)
    upper = (1 << (8 * byte_count - 1)) - 1
    lower = -(1 << (8 * byte_count - 1))
    limit = np.where(values >= 0, upper, lower)
    runs = values // limit
    rest = values - runs * limit
    packed = np.repeat(limit, runs + 1)
    packed[np.cumsum(runs + 1) - 1] = rest
    return packed, {"kind": "IntegerPacking", "byteCount": byte_count,
                    "isUnsigned": False, "srcSize": len(values)}


def _bcif_column(name, data, encodings, mask=None):
    column = {"name": name, "data": {"data": data, "encoding": encodings},
              "mask": None}
    if mask is not None:
        mdata, menc = _bcif_byte_array(mask, "u1")
        column["mask"] = {"data": mdata, "encoding": [menc]}
    return column


def _bcif_integers(name, values, byte_count=1):
    """An integer column as the PDB's encoder writes ``atom_site``'s:
    Delta, RunLength, IntegerPacking, ByteArray."""
    diffs, delta = _bcif_delta(values)
    pairs, run_length = _bcif_run_length(diffs)
    packed, packing = _bcif_integer_packing(pairs, byte_count)
    data, byte_array = _bcif_byte_array(packed, f"i{byte_count}")
    return _bcif_column(name, data, [delta, run_length, packing,
                                     byte_array])


def _bcif_strings(name, values, mask=None):
    """A string column: StringArray over the distinct strings, indices as
    RunLength + ByteArray."""
    import numpy as np

    values = np.asarray(values).astype(str)
    unique, index = np.unique(values, return_inverse=True)
    offsets = np.r_[0, np.cumsum([len(s) for s in unique])]
    pairs, run_length = _bcif_run_length(index)
    idx_data, idx_enc = _bcif_byte_array(pairs, "i4")
    off_data, off_enc = _bcif_byte_array(offsets, "i4")
    return _bcif_column(name, idx_data, [{
        "kind": "StringArray", "dataEncoding": [run_length, idx_enc],
        "stringData": "".join(unique), "offsetEncoding": [off_enc],
        "offsets": off_data}], mask)


def _bcif_coords(name, values):
    """A coordinate column: FixedPoint (1/1000 A), ByteArray int32."""
    ints, fixed = _bcif_fixed_point(values)
    data, byte_array = _bcif_byte_array(ints, "i4")
    return _bcif_column(name, data, [fixed, byte_array])


def write_bcif(path, atoms, coord_models=None):
    """`atoms` as a BinaryCIF file (gzipped for a ``.gz`` path) with the
    columns of :func:`write_mmcif`, encoded as the PDB's BinaryCIF encoder
    encodes ``atom_site``: FixedPoint coordinates, Delta / RunLength /
    IntegerPacking integers, StringArray strings, a mask of ``.`` on the
    alternate locations; MessagePack through the port's ``bcif._pack``."""
    import gzip

    import numpy as np

    from springcraft_tpu_torch.structure.bcif import _pack

    models = (np.asarray(atoms.coord)[None] if coord_models is None
              else np.asarray(coord_models))
    m, n = models.shape[:2]

    def tile(annotation):
        return np.tile(np.asarray(annotation), m)

    coord = models.reshape(-1, 3)
    columns = [
        _bcif_strings("group_PDB", np.full(m * n, "ATOM")),
        _bcif_integers("id", np.arange(1, m * n + 1)),
        _bcif_strings("type_symbol", tile(atoms.element)),
        _bcif_strings("label_atom_id", tile(atoms.atom_name)),
        _bcif_strings("label_alt_id", np.full(m * n, ""),
                      mask=np.ones(m * n, np.uint8)),
        _bcif_strings("label_comp_id", tile(atoms.res_name)),
        _bcif_strings("label_asym_id", tile(atoms.chain_id)),
        _bcif_integers("label_seq_id", tile(atoms.res_id)),
        *(_bcif_coords(f"Cartn_{axis}", coord[:, a])
          for a, axis in enumerate("xyz")),
        _bcif_coords("occupancy", np.ones(m * n)),
        _bcif_coords("B_iso_or_equiv", np.zeros(m * n)),
        _bcif_integers("auth_seq_id", tile(atoms.res_id)),
        _bcif_strings("auth_asym_id", tile(atoms.chain_id)),
        _bcif_integers("pdbx_PDB_model_num",
                       np.repeat(np.arange(1, m + 1), n)),
    ]
    doc = _pack({"version": "0.3.0", "encoder": "chip_smoke.py",
                 "dataBlocks": [{"header": "LARGE", "categories": [{
                     "name": "_atom_site", "rowCount": m * n,
                     "columns": columns}]}]})
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as fh:
        fh.write(doc)


class Interrupted(Exception):
    """The non-device exception that interrupts a checkpointed solve."""


def _device_failure():
    """A transient device failure as torch raises it (``AcceleratorError``
    where torch has it, else the ``RuntimeError`` of older versions)."""
    import torch

    return getattr(torch, "AcceleratorError", RuntimeError)(
        "CUDA error: unspecified launch failure (injected by chip_smoke.py)")


@contextlib.contextmanager
def injected(module, name, fail_at=None, exc=None):
    """Wrap ``module.name`` for the block: count its calls in the yielded
    ``[count]`` and raise `exc` instead of call number `fail_at`."""
    original = getattr(module, name)
    calls = [0]

    def call(*args, **kwargs):
        calls[0] += 1
        if calls[0] == fail_at:
            raise exc
        return original(*args, **kwargs)

    setattr(module, name, call)
    try:
        yield calls
    finally:
        setattr(module, name, original)


def _spread(out, ref):
    """Max |a - b| of each tensor of `out` against `ref`."""
    return [float((a.double() - b.double()).abs().max())
            for a, b in zip(out, ref)]


def _large_files(atoms, drawn, written, tmp, card):
    """Write the large structure as gzipped mmCIF and as BinaryCIF, read
    both back with ``load_structure`` and the BinaryCIF with
    ``load_ensemble``; returns the BinaryCIF's coordinates."""
    import numpy as np

    from springcraft_tpu_torch.structure import (load_ensemble,
                                                 load_structure, write_pdb)

    n = atoms.array_length()
    spacing = float(np.spacing(np.float32(np.abs(written).max())))
    read, notes = {}, []
    for fmt, name, writer in (("mmCIF", "large.cif.gz", write_mmcif),
                              ("BinaryCIF", "large.bcif", write_bcif)):
        path = os.path.join(tmp, name)
        t0 = time.perf_counter()
        writer(path, atoms)
        t1 = time.perf_counter()
        got = load_structure(path)
        t2 = time.perf_counter()
        check(got.array_length() == n, f"{fmt}: {got.array_length()} atoms")
        for annotation in ("chain_id", "res_id", "res_name", "atom_name",
                           "element"):
            check(np.array_equal(getattr(got, annotation),
                                 getattr(atoms, annotation)),
                  f"{fmt}: {annotation} differs from what was written")
        check(not got.hetero.any(), f"{fmt}: hetero atoms")
        check(got.coord.dtype == np.float32, f"{fmt}: coordinate dtype")
        written_err = float(np.abs(got.coord - written).max())
        drawn_err = float(np.abs(got.coord - drawn).max())
        check(written_err <= spacing / 2,
              f"{fmt}: {written_err:.3e} A from the written coordinates")
        check(drawn_err <= 5e-4 + spacing,
              f"{fmt}: {drawn_err:.3e} A from the drawn coordinates")
        read[fmt] = got.coord
        notes.append(f"{fmt} {os.path.getsize(path) / 1e6:.2f} MB, write "
                     f"{t1 - t0:.3f} s, read {t2 - t1:.3f} s, "
                     f"{drawn_err:.3e} A from the drawn coordinates")
    t0 = time.perf_counter()
    first, models = load_ensemble(os.path.join(tmp, "large.bcif"))
    ensemble_s = time.perf_counter() - t0
    check(models.shape == (1, n, 3)
          and np.array_equal(models[0], read["BinaryCIF"])
          and np.array_equal(first.chain_id, atoms.chain_id),
          "load_ensemble of the BinaryCIF")
    apart = float(np.abs(read["mmCIF"] - read["BinaryCIF"]).max())
    check(apart <= spacing, f"mmCIF and BinaryCIF {apart:.3e} A apart")
    try:
        write_pdb(os.path.join(tmp, "large.pdb"), atoms)
    except ValueError as exc:
        refusal = str(exc)
    else:
        raise RuntimeError("chip_smoke: check failed: write_pdb wrote "
                           f"{n} atoms")
    print(f"large_structure files: n={n}, chains {'/'.join(LARGE_CHAINS)}, "
          f"residue IDs 1-{int(atoms.res_id.max())}: " + "; ".join(notes)
          + f"; load_ensemble (BinaryCIF) {ensemble_s:.3f} s; the two "
          f"formats {apart:.3e} A apart (one float32 spacing "
          f"{spacing:.3e}); write_pdb refused: {refusal} [{card}]",
          flush=True)
    return read["BinaryCIF"]


def _large_solves(coord, tmp, card):
    """The xl ANM and GNM solves on the large structure's coordinates
    (the GNM without `tol`, so that it runs past the interruption: its
    6 outer iterations are few enough, and its residuals are held to
    XL_TOL as the ANM's), (a) two uninterrupted calls, then with
    ``checkpoint=`` uninterrupted (ANM), (b) interrupted after outer iteration INTERRUPT_AFTER by a
    non-device exception and resumed, (c) ``retries=1`` through one
    injected device failure (ANM); (b) and (c) held to (a) bit for bit, or
    within (a)'s own spread if (a) has one.  Returns ``({path:
    launches}, the resumed ANM modes)``."""
    import numpy as np
    import torch

    import springcraft_tpu_torch as sct
    from springcraft_tpu_torch.ops import matfree

    params = sct.invariant_params(MATFREE_CUTOFF)
    snapshot = os.path.join(tmp, "modes.npz")
    launches, kept = {}, None
    for family, solver, k, n_outer, tol in (
            ("anm", sct.lowest_modes_matfree, XL_ANM_MODES, XL_ANM_OUTER,
             XL_TOL),
            ("gnm", sct.lowest_modes_matfree_gnm, XL_GNM_MODES,
             XL_GNM_OUTER, None)):
        torch.cuda.empty_cache()
        runs = {"plain": {}, "repeat": {}}
        if family == "anm":
            runs["checkpointed"] = {"checkpoint": snapshot}
        runs["interrupted"] = {"checkpoint": snapshot}
        runs["resumed"] = {"checkpoint": snapshot}
        if family == "anm":
            runs["retried"] = {"retries": 1}
        out, seconds, steps, notes = {}, {}, {}, []
        for run, options in runs.items():
            fail_at, exc = {
                "interrupted": (INTERRUPT_AFTER + 1, Interrupted()),
                "retried": (2, _device_failure())}.get(run, (None, None))
            path = f"{family}_large_{run}"

            def call(options=options):
                try:
                    return solver(coord, params, k, degree=96,
                                  n_outer=n_outer, tol=tol, **options)
                except Interrupted:
                    return None

            with injected(matfree, "_chebfsi_outer", fail_at, exc) as calls:
                out[run], seconds[run], launches[path] = drive(path, call)
            steps[run] = calls[0]
            if run == "interrupted":
                check(out[run] is None and os.path.exists(snapshot),
                      f"{path}: no snapshot after the interruption")
                with np.load(snapshot) as data:
                    at = int(data["__iteration__"])
                    held = {key: (str(data[key].dtype), data[key].shape)
                            for key in data.files}
                check(at == INTERRUPT_AFTER, f"{path}: snapshot at {at}")
                notes.append(f"snapshot at outer iteration {at}: "
                             f"{os.path.getsize(snapshot)} bytes {held}")
            elif run != "plain":
                check(not os.path.exists(snapshot),
                      f"{path}: snapshot left behind")
        plain = out["plain"]
        spread = _spread(out["repeat"], plain)
        for run in runs:
            if run in ("plain", "interrupted"):
                continue
            apart = _spread(out[run], plain)
            check(all(d <= s for d, s in zip(apart, spread)),
                  f"{family}_large_{run}: {apart} from the plain call "
                  f"(spread of two plain calls {spread})")
        check(steps["plain"] > INTERRUPT_AFTER,
              f"{family}: converged in {steps['plain']} outer iterations, "
              f"before the interruption")
        check(steps["resumed"] == steps["plain"] - INTERRUPT_AFTER,
              f"{family}_large_resumed ran {steps['resumed']} steps")
        if family == "anm":
            check(steps["retried"] == steps["plain"] + 1,
                  f"anm_large_retried ran {steps['retried']} steps")
        check(bool(torch.isfinite(plain[0]).all()
                   and torch.isfinite(plain[1]).all()),
              f"{family}: non-finite modes")
        # both families held to the xl tolerance, the GNM too although it
        # runs without `tol` (its iterations fixed): equal but wrong modes
        # on every run would pass the comparisons above
        check(float(plain[2].max()) < XL_TOL,
              f"{family}_large: residual {float(plain[2].max()):.3e} "
              f"(tol {XL_TOL:g})")
        x_bytes = 4 * (3 if family == "anm" else 1) * coord.shape[0] * (
            k + max(k, 8, 48 - k))
        print(f"{family}_large: n={coord.shape[0]}, {k} modes, degree 96, "
              f"up to {n_outer} outer iterations, tol {tol}: "
              f"{steps['plain']} outer iterations, residuals <= "
              f"{float(plain[2].max()):.3e} (tol {XL_TOL:g}); two plain "
              f"calls "
              + ("bit for bit equal" if not any(spread)
                 else f"apart by {spread} (values, vectors, residuals)")
              + "; seconds " + ", ".join(f"{run} {s:.3f}" for run, s in
                                         seconds.items())
              + f"; resumed ran {steps['resumed']} steps"
              + (f", retried {steps['retried']} (one retry)"
                 if family == "anm" else "")
              + f"; the carried block x {x_bytes / 1e6:.1f} MB; "
              + "; ".join(notes) + f" [{card}]", flush=True)
        if family == "anm":
            kept = out["resumed"]
        del out, plain
    return launches, kept


def _large_results_and_shift_invert(modes, ca_7cal, e_anm, tmp, card):
    """``save_results`` / ``load_results`` of `modes` bit for bit; the
    staged shift-invert of 7cal's float64 eANM Hessian interrupted after
    step INTERRUPT_AFTER and resumed, against ``engine="chol"``."""
    import numpy as np
    import torch

    from springcraft_tpu_torch import io as sio
    from springcraft_tpu_torch.ops import assembly, rigid
    from springcraft_tpu_torch.ops import modes as modes_ops

    path = os.path.join(tmp, "modes_results.npz")
    names = ("values", "vectors", "residuals")
    t0 = time.perf_counter()
    sio.save_results(path, dict(zip(names, modes)))
    back = sio.load_results(path)
    results_s = time.perf_counter() - t0
    check(sorted(back) == sorted(names)
          and all(np.array_equal(back[name], t.cpu().numpy())
                  for name, t in zip(names, modes)),
          "load_results differs from what save_results was given")
    results_mb = os.path.getsize(path) / 1e6

    c64 = torch.as_tensor(ca_7cal.coord, dtype=torch.float64, device="cuda")
    h = assembly.hessian_matrix(c64, e_anm, layout="xyz")
    t = rigid.rigid_modes_anm(c64)
    k = N_MODES + MODE_BUFFER
    snapshot = os.path.join(tmp, "shift_invert.npz")
    t0 = time.perf_counter()
    plain = modes_ops.lowest_modes_shift_invert(h, t, k=k, engine="chol")
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    with injected(modes_ops, "_shift_invert_step", INTERRUPT_AFTER + 1,
                  Interrupted()):
        try:
            modes_ops.lowest_modes_shift_invert_staged(h, t, k=k,
                                                       checkpoint=snapshot)
        except Interrupted:
            pass
    check(os.path.exists(snapshot), "shift-invert: no snapshot")
    snapshot_bytes = os.path.getsize(snapshot)
    t0 = time.perf_counter()
    with injected(modes_ops, "_shift_invert_step") as calls:
        got = modes_ops.lowest_modes_shift_invert_staged(h, t, k=k,
                                                         checkpoint=snapshot)
    torch.cuda.synchronize()
    resumed_s = time.perf_counter() - t0
    check(calls[0] == 24 - INTERRUPT_AFTER,
          f"shift-invert resumed ran {calls[0]} steps")
    check(torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1]),
          "shift-invert: the resumed staged solve differs from chol")
    check(not os.path.exists(snapshot), "shift-invert: snapshot left")
    print(f"large_structure results: save_results + load_results of the "
          f"resumed ANM modes {results_s:.3f} s ({results_mb:.1f} MB), bit "
          f"for bit; staged shift-invert on 7cal's float64 eANM Hessian "
          f"({h.shape[0]} dims, {k} modes, 24 steps): interrupted after step "
          f"{INTERRUPT_AFTER} (snapshot {snapshot_bytes} bytes), resumed "
          f"{calls[0]} steps in {resumed_s:.3f} s (chol engine "
          f"{plain_s:.3f} s), bit for bit equal [{card}]", flush=True)


def _large_models(ca_7cal, tmp, card):
    """``save_model`` / ``load_model`` on the card: 7cal's GNM (invariant
    7 A) and its chain A's eANM ANM with masses, covariance computed,
    observables of the restored models bit for bit; the refusal without a
    force field; a normal-mode trajectory of 7cal's eANM ANM through
    ``write_pdb`` and ``load_ensemble``."""
    import numpy as np

    import springcraft_tpu_torch as sct
    from springcraft_tpu_torch import io as sio
    from springcraft_tpu_torch.structure import load_ensemble, write_pdb

    def same(a, b):
        if isinstance(a, tuple):
            return all(same(x, y) for x, y in zip(a, b))
        return np.array_equal(a, b)

    notes = []
    chain_a = ca_7cal[ca_7cal.chain_id == "A"]
    for label, model, observables in (
            ("GNM 7cal invariant 7 A",
             sct.GNM(ca_7cal, sct.InvariantForceField(7.0)),
             ("mean_square_fluctuation", "dcc")),
            ("ANM 7cal chain A eANM, masses",
             sct.ANM(chain_a, sct.TabulatedForceField.e_anm(chain_a),
                     masses=True),
             ("mean_square_fluctuation", "dcc", "prs_effector_sensor"))):
        _ = model.covariance  # computed before the save
        path = os.path.join(tmp, "model.npz")
        t0 = time.perf_counter()
        sio.save_model(path, model)
        restored = sio.load_model(path)
        seconds = time.perf_counter() - t0
        check(restored._covariance.device.type == "cuda",
              f"{label}: restored off the card")
        for name in observables:
            check(same(getattr(restored, name)(), getattr(model, name)()),
                  f"{label}: restored {name} differs")
        try:
            restored.lowest_modes(4, matrix_free=True)
        except RuntimeError as exc:
            check("force_field=" in str(exc), f"{label}: {exc}")
        else:
            raise RuntimeError(f"chip_smoke: check failed: {label} "
                               f"restored without a force field rebuilt")
        notes.append(f"{label}: {os.path.getsize(path) / 1e6:.1f} MB, save "
                     f"+ load {seconds:.3f} s, {', '.join(observables)} bit "
                     f"for bit, rebuilding refused")

    anm = sct.ANM(ca_7cal, sct.TabulatedForceField.e_anm(ca_7cal),
                  masses=True)
    traj = ca_7cal.coord[None] + anm.normal_mode(6, amplitude=2.0, frames=8)
    path = os.path.join(tmp, "mode.pdb")
    t0 = time.perf_counter()
    write_pdb(path, ca_7cal, coord_models=traj)
    first, models = load_ensemble(path)
    seconds = time.perf_counter() - t0
    spacing = float(np.spacing(np.float32(np.abs(traj).max())))
    err = float(np.abs(models - traj).max())
    check(models.shape == traj.shape, f"trajectory {models.shape}")
    check(err <= 5e-4 + spacing, f"trajectory {err:.3e} A off")
    check(all(np.array_equal(getattr(first, a), getattr(ca_7cal, a))
              for a in ("chain_id", "res_id", "res_name", "atom_name")),
          "trajectory annotations")
    print("large_structure models: " + "; ".join(notes)
          + f"; normal-mode trajectory of 7cal's eANM ANM ({traj.shape[0]} "
          f"models) through write_pdb and load_ensemble {seconds:.3f} s, "
          f"{err:.3e} A off [{card}]", flush=True)


def large_structure_paths(ca_7cal, e_anm, card):
    """The large-structure path: N_XL_ANM atoms (the xl ANM draw, four
    chains of 25,000 residues, one chain "AA") written as gzipped mmCIF and
    BinaryCIF and read back; from the BinaryCIF coordinates the xl ANM and
    GNM solves, uninterrupted, checkpointed, interrupted and resumed,
    retried; ``save_results`` of the resumed modes; the staged
    shift-invert interrupted and resumed; model files and a PDB
    trajectory.  Files live in a temporary directory under ``build/``.
    Returns ``{path: launches}``."""
    import tempfile

    atoms, drawn, written = large_structure(N_XL_ANM)
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "large_structure")
    os.makedirs(base, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=base) as tmp:
        coord = _large_files(atoms, drawn, written, tmp, card)
        launches, modes = _large_solves(coord, tmp, card)
        _large_results_and_shift_invert(modes, ca_7cal, e_anm, tmp, card)
        _large_models(ca_7cal, tmp, card)
    return launches


def power_norm(h, steps=30):
    """A lower bound of ``||h||_2`` for a symmetric PSD `h`: the Rayleigh
    quotient after `steps` power iterations from a seeded start."""
    import torch

    x = torch.randn(h.shape[0], 1, device=h.device, dtype=h.dtype,
                    generator=torch.Generator(h.device).manual_seed(1))
    for _ in range(steps):
        x = h @ x
        x = x / torch.linalg.vector_norm(x)
    return float((x.T @ (h @ x)).squeeze())


def mode_observables(vals, vecs, n):
    """Mode-sum MSF ``(n,)`` and the DCC rows of the first MEGA_DCC_SITES
    atoms over all atoms, float64, from N_MODES modes in xyz layout
    (``bench.py:525-535``)."""
    import torch

    vals = vals[:N_MODES].double()
    planes = vecs[:N_MODES].double().reshape(N_MODES, 3, n)
    weighted = planes / vals[:, None, None]
    msf = torch.einsum("kai,kai->i", weighted, planes)
    rows = torch.einsum("kai,kaj->ij", weighted[:, :, :MEGA_DCC_SITES],
                        planes)
    return msf, rows / torch.sqrt(msf[:MEGA_DCC_SITES, None]
                                  * msf[None, :])


def mega_north_star(results, card):
    """The north star (``bench.py::bench_mega_tpu``) on the card: K5 at
    (1, N_MEGA) sdENM against its plain version; then from zero launch
    counts the 30,000-dimensional float32 Hessian built through
    ``pallas_kernels.hessian_pallas``, ``lowest_modes_anm`` (N_MODES +
    MODE_BUFFER modes, ``engine="auto"``: ``"chol"`` past 8,192
    dimensions) with ``mode_residuals``, and ``refine_modes_f64`` on the
    card (its host pair search and its float64 applies clocked apart),
    each stage timed by :class:`Timer` to a synchronize on its first and
    second call; the raw residuals, the mode-sum MSF and DCC block of the
    raw modes against the refined ones; the proof at N_PROOF atoms
    against float64 ``eigvalsh``.  Returns ``{path: launches}``."""
    import torch

    import springcraft_tpu_torch as sct
    from springcraft_tpu_torch.ops import assembly, pallas_kernels, rigid
    from springcraft_tpu_torch.ops import modes as modes_ops
    from springcraft_tpu_torch.ops import pairs as pairs_ops
    from springcraft_tpu_torch.utils import Timer, synchronize

    torch.cuda.empty_cache()
    atoms = make_ca_atoms(N_MEGA, seed=MEGA_SEED)
    params = sct.TabulatedForceField.sd_enm(atoms).to_compact_params()
    coord = torch.as_tensor(atoms.coord, device=DEVICE)
    n, k = N_MEGA, N_MODES + MODE_BUFFER
    record(results, "hessian_xyz",
           lambda: pallas_kernels.hessian_pallas(coord, params)[None],
           lambda: assembly.hessian_xyz_plain(coord[None], params),
           (4 * (3 * n + 9 * n * n), 30 * n * n), reps=5, plain_reps=2,
           label=" sdENM, the north star's input")
    torch.cuda.empty_cache()

    timer, stages = Timer(), {}

    def run(call):
        clocks = stages.setdefault(call, {})
        with timer(f"build {call}"):
            h = synchronize(pallas_kernels.hessian_pallas(coord, params))
        with stage_clock(rigid, ("_regularize_equilibrated",
                                 "_cholesky_factor"), clocks, {}), \
                stage_clock(modes_ops, ("_shift_invert_iterate",), clocks,
                            {}), timer(f"modes {call}"):
            vals, vecs = synchronize(modes_ops.lowest_modes_anm(h, coord, k))
        with timer(f"residuals {call}"):
            res = synchronize(modes_ops.mode_residuals(h, vals, vecs))
        with stage_clock(pairs_ops, ("neighbor_pairs", "hessian_apply_pairs"),
                         clocks, {}), timer(f"refine {call}"):
            refined = synchronize(modes_ops.refine_modes_f64(
                coord, params, vecs, layout="xyz"))
        return h, vals, vecs, res, refined

    torch.cuda.reset_peak_memory_stats()
    path = "mega_north_star"
    (h, vals, vecs, res, (theta, ref_vecs, ref_res)), _, launches = drive(
        path, lambda: run("first"))
    del h, vecs, ref_vecs
    torch.cuda.empty_cache()
    h, vals, vecs, res, (theta, ref_vecs, ref_res) = run("second")
    peak = torch.cuda.max_memory_allocated() / 2**30
    norm = power_norm(h)
    abs_res = (res[:N_MODES].double() * vals[:N_MODES].double().abs()
               / norm)
    worst = float(abs_res.max())
    del h
    torch.cuda.empty_cache()
    raw_vs_ref = float(((vals[:N_MODES].double() - theta[:N_MODES]).abs()
                        / theta[:N_MODES]).max())
    msf32, dcc32 = mode_observables(vals, vecs, n)
    msf64, dcc64 = mode_observables(theta, ref_vecs, n)
    msf_err = rel_rmse(msf32, msf64)
    dcc_err = float((dcc32 - dcc64).abs().max())
    del vecs, ref_vecs, dcc32, dcc64
    torch.cuda.empty_cache()
    seconds = timer.totals
    clause = ("build", "modes", "residuals", "refine")
    total = {call: sum(seconds[f"{stage} {call}"] for stage in clause)
             for call in ("first", "second")}
    inner = {"_regularize_equilibrated": "regularization",
             "_cholesky_factor": "Cholesky",
             "_shift_invert_iterate": "sweeps and Rayleigh-Ritz",
             "neighbor_pairs": "pair search (host)",
             "hessian_apply_pairs": "float64 applies"}
    print(f"{path}: n={n} ({3 * n} dimensions) sdENM float32, {N_MODES}"
          f"(+{MODE_BUFFER}) modes; seconds, first / second call: "
          + ", ".join(f"{stage} {seconds[stage + ' first']:.3f} / "
                      f"{seconds[stage + ' second']:.3f}" for stage in clause)
          + "; inside them: "
          + ", ".join(f"{label} {stages['first'][name]:.3f} / "
                      f"{stages['second'][name]:.3f}"
                      for name, label in inner.items())
          + f"; total {total['first']:.3f} / {total['second']:.3f} s "
          f"(< {MEGA_CLAUSE_S:g} s clause: "
          f"{'ok' if total['second'] < MEGA_CLAUSE_S else 'over'}); raw "
          f"residuals |H u - lambda u| / lambda max "
          f"{float(res[:N_MODES].max()):.3e}, / ||H||_2 (>= {norm:.6g}) max "
          f"{worst:.3e} (tol {RESIDUAL_TOL:g}); refined float64 residuals "
          f"max {float(ref_res[:N_MODES].max()):.3e}; raw-vs-refined "
          f"eigenvalue rtol {raw_vs_ref:.3e}; mode-sum MSF rel RMSE "
          f"{msf_err:.3e} (tol {MEGA_MSF_TOL:g}), DCC {MEGA_DCC_SITES}-row "
          f"block max abs err {dcc_err:.3e} (tol {MEGA_DCC_TOL:g}); peak "
          f"device memory {peak:.2f} GiB on [{card}]", flush=True)
    check(bool(torch.isfinite(vals).all() and torch.isfinite(theta).all()),
          f"{path}: non-finite modes")
    check(worst <= RESIDUAL_TOL, f"{path}: raw residual {worst:.3e}")
    check(msf_err <= MEGA_MSF_TOL, f"{path}: MSF rel RMSE {msf_err:.3e}")
    check(dcc_err <= MEGA_DCC_TOL, f"{path}: DCC error {dcc_err:.3e}")

    proof = make_ca_atoms(N_PROOF, seed=PROOF_SEED)
    params_p = sct.TabulatedForceField.sd_enm(proof).to_compact_params()
    coord_p = torch.as_tensor(proof.coord, device=DEVICE)
    with timer("proof"):
        h_p = pallas_kernels.hessian_pallas(coord_p, params_p)
        raw_p, vecs_p = modes_ops.lowest_modes_anm(h_p, coord_p, k)
        theta_p = modes_ops.refine_modes_f64(coord_p, params_p, vecs_p,
                                             layout="xyz", block=512)[0]
        truth = synchronize(torch.linalg.eigvalsh(assembly.hessian_matrix(
            coord_p.double(), params_p, layout="xyz"))[6:6 + N_MODES])
    raw_rtol = float(((raw_p[:N_MODES].double() - truth).abs()
                      / truth).max())
    ref_rtol = float(((theta_p[:N_MODES] - truth).abs() / truth).max())
    print(f"{path} proof: n={N_PROOF} sdENM, float64 eigvalsh on the card: "
          f"raw float32 eigenvalue rtol {raw_rtol:.3e}, refined "
          f"{ref_rtol:.3e} (tol {REFINED_RTOL:g}); {timer.totals['proof']:.3f}"
          f" s with the float64 assembly and eigvalsh", flush=True)
    check(ref_rtol <= REFINED_RTOL,
          f"{path}: refined eigenvalues {ref_rtol:.3e} off float64")
    del h_p, vecs_p
    torch.cuda.empty_cache()
    return {path: launches}


def mega_allmode_msf(results, card):
    """The all-mode MSF at 20,736 dimensions (``bench.py:601-653``): the
    golden's structure (``make_ca_atoms(6912, seed=5)``, sdENM); K5 at
    (1, 6912) against its plain version; then from zero launch counts
    the float32 Hessian through ``pallas_kernels.hessian_pallas`` and
    ``rigid.pinv_diagonal(block_size=MEGA_BLOCK, donate=True)``, the
    three xyz blocks summed and held against the committed float64
    golden.  Returns ``({path: launches}, the all-mode MSF)``."""
    import numpy as np
    import torch

    import springcraft_tpu_torch as sct
    from springcraft_tpu_torch.ops import assembly, pallas_kernels, rigid

    golden = np.load(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), GOLDEN_MSF))
    n = int(golden["n_res"])
    atoms = make_ca_atoms(n, seed=int(golden["seed"]))
    params = sct.TabulatedForceField.sd_enm(atoms).to_compact_params()
    coord = torch.as_tensor(atoms.coord, device=DEVICE)
    torch.cuda.empty_cache()
    record(results, "hessian_xyz",
           lambda: pallas_kernels.hessian_pallas(coord, params)[None],
           lambda: assembly.hessian_xyz_plain(coord[None], params),
           (4 * (3 * n + 9 * n * n), 30 * n * n), reps=5, plain_reps=2,
           label=" sdENM, the golden's input")
    torch.cuda.empty_cache()

    def run():
        h = pallas_kernels.hessian_pallas(coord, params)
        t = rigid.rigid_modes_anm(coord, layout="xyz")
        return rigid.pinv_diagonal(h, t, block_size=MEGA_BLOCK, donate=True)

    path = "mega_allmode_msf"
    diag, seconds, launches = drive(path, run)
    msf = diag.double().reshape(3, n).sum(dim=0)
    truth = torch.as_tensor(golden["msf"], device=DEVICE)
    err = rel_rmse(msf, truth)
    print(f"{path}: n={n} ({3 * n} dimensions) sdENM float32, "
          f"pinv_diagonal(block_size={MEGA_BLOCK}) {seconds:.3f} s with the "
          f"build (first call); all-mode MSF vs the float64 golden rel RMSE "
          f"{err:.3e} (tol {MEGA_ALLMODE_TOL:g}) on [{card}]", flush=True)
    check(bool(torch.isfinite(msf).all()), f"{path}: non-finite MSF")
    check(err <= MEGA_ALLMODE_TOL, f"{path}: MSF rel RMSE {err:.3e}")
    del diag
    torch.cuda.empty_cache()
    return {path: launches}, msf


def dryrun_problem(n_atoms, n_batch, seed=0):
    """``__graft_entry__._example_problem``: one structure of `n_atoms`
    in a 12 A box and `n_batch` conformers 0.05 A around it, float32."""
    import numpy as np

    rng = np.random.RandomState(seed)
    base = rng.rand(n_atoms, 3).astype(np.float32) * 12.0
    batch = base[None] + 0.05 * rng.randn(n_batch, n_atoms, 3).astype(
        np.float32)
    return base, batch


def dryrun_blocks(devices):
    """The port counterparts of the 14 asserted blocks of
    ``__graft_entry__.dryrun_multichip`` (``__graft_entry__.py:95-288``:
    1-9, 2b, 6b, 6c, 8b, 8c) on a mesh over `devices`, at its shapes: the
    row axis 2 where the mesh size is even (else 1), 16 atoms a row index,
    2 conformers a device, the invariant field at 8 A, float32.  Returns
    ``[(block, run), ...]`` in its order; each ``run()`` makes the block's
    call and its checks (shapes, finite values, the engine cross-checks
    at 1e-3) and returns the outputs.  The tabulated cross-check (8c) holds
    the kernels' float32 call against the float64 ``cho_solve`` engine
    over the plain assembly: on CUDA the port runs no plain float32
    assembly to hold them against, as the JAX package holds Pallas
    against XLA."""
    import functools

    import numpy as np
    import torch

    import springcraft_tpu_torch as sct
    from springcraft_tpu_torch import parallel
    from springcraft_tpu_torch.ops import matfree, modes
    from springcraft_tpu_torch.structure import AtomArray

    n_devices = len(devices)
    row_axis = 2 if n_devices % 2 == 0 else 1
    mesh = parallel.make_mesh(n_devices, row_axis=row_axis, devices=devices)
    n_atoms, n_batch = 16 * row_axis, 2 * n_devices
    coord, batch = dryrun_problem(n_atoms, n_batch)
    coord_t = torch.as_tensor(coord, device=mesh.flat[0])
    params = sct.invariant_params(8.0)
    f32 = torch.float32
    state = {}

    def finite(label, *values):
        check(all(bool(torch.isfinite(torch.as_tensor(v)).all())
                  for v in values), f"dryrun {label}: non-finite output")

    def shape(label, value, want):
        check(tuple(value.shape) == want, f"dryrun {label}: shape "
              f"{tuple(value.shape)}, expected {want}")

    def within(label, got, ref):
        got, ref = got.double(), ref.double()
        rel = float((got - ref).abs().max() / ref.abs().max())
        check(rel < 1e-3, f"dryrun {label}: {rel:.3e} of max apart")
        return rel

    def ensemble():
        out = parallel.sharded_ensemble_anm(batch, params, mesh, dtype=f32)
        shape("1", out["msf"], (n_batch, n_atoms))
        return out

    def mean_msf():
        mean = parallel.ensemble_mean_msf(batch, params, mesh, kind="anm")
        shape("2", mean, (n_atoms,))
        return mean

    def fluctuations():
        state["fluct"] = parallel.sharded_ensemble_anm_fluctuations(
            batch, params, mesh, dtype=f32)
        shape("2b", state["fluct"]["msf"], (n_batch, n_atoms))
        return state["fluct"]

    def pipeline():
        mega = parallel.sharded_anm_pipeline(coord, params, mesh, dtype=f32)
        shape("3", mega["msf"], (n_atoms,))
        finite("3", mega["eig_values"])
        return mega

    def all_mode_msf():
        out = parallel.sharded_all_mode_msf(coord, params, mesh, block=16,
                                            dtype=f32)
        shape("4", out["msf"], (n_atoms,))
        finite("4", out["msf"])
        return out

    def modes_matfree():
        vals, vecs, res = parallel.sharded_lowest_modes_matfree(
            coord, params, mesh, 3, degree=24, n_outer=6, block=8,
            dtype=f32)
        shape("5", vals, (3,))
        shape("5", vecs, (3, 3 * n_atoms))
        finite("5", res)
        state["modes"] = (vals, vecs)
        return vals, vecs, res

    def linear_response():
        state["matvec"] = functools.partial(
            parallel.sharded_hessian_apply, coord_t, params=params,
            mesh=mesh, block=8, dtype=f32)
        rhs = np.zeros((3 * n_atoms, 2), dtype=np.float32)
        rhs[0, 0] = 1.0
        rhs[3, 1] = -1.0
        x, n_it, cg_res = matfree.covariance_solve_matfree(
            coord_t, params, rhs, tol=1e-4, max_iter=200,
            matvec=state["matvec"], dtype=f32)
        finite("6", x)
        shape("6", cg_res, (2,))
        return x, n_it, cg_res

    def msf_stochastic():
        out = matfree.msf_stochastic(
            coord_t, params, state["modes"], probes=4, seed=0, tol=1e-4,
            max_iter=200, matvec=state["matvec"], dtype=f32)
        shape("6b", out[0], (n_atoms,))
        finite("6b", out[0], out[1])
        return out

    def effector_sensor():
        prs_diag = matfree.prs_diag_from_modes(*state["modes"],
                                               layout="xyz")
        out = matfree.effector_sensor_stochastic(
            coord_t, params, prs_diag, probes=4, seed=1,
            modes=state["modes"], tol=1e-4, max_iter=200,
            matvec=state["matvec"], dtype=f32)
        for value in out[:2]:
            shape("6c", value, (n_atoms,))
        finite("6c", *out[:4])
        return out

    def banded():
        out = parallel.sharded_ensemble_anm_banded(batch, params, mesh,
                                                   dtype=f32, bandwidth=4)
        shape("7", out["msf"], (n_batch, n_atoms))
        finite("7", out["eig_values"])
        return out

    def blocked_engine():
        out = parallel.sharded_ensemble_anm_fluctuations(
            batch, params, mesh, dtype=f32, inverse="blocked")
        shape("8", out["msf"], (n_batch, n_atoms))
        within("8", out["msf"], state["fluct"]["msf"])
        return out

    def headline_engine():
        out = parallel.sharded_ensemble_anm_fluctuations(
            batch, params, mesh, dtype=f32, inverse="blocked",
            use_pallas=True, with_covariance=False)
        shape("8b", out["msf"], (n_batch, n_atoms))
        within("8b", out["msf"], state["fluct"]["msf"])
        return out

    def tabulated():
        rng = np.random.RandomState(5)
        atoms = AtomArray(n_atoms)
        atoms.coord = coord
        atoms.atom_name = np.full(n_atoms, "CA")
        atoms.element = np.full(n_atoms, "C")
        atoms.chain_id = np.full(n_atoms, "A")
        atoms.res_id = np.arange(1, n_atoms + 1)
        atoms.res_name = np.array(AA20)[rng.randint(0, 20, n_atoms)]
        sd_params = sct.TabulatedForceField.sd_enm(atoms) \
            .to_compact_params()
        ref = parallel.sharded_ensemble_anm_fluctuations(
            batch, sd_params, mesh, dtype=torch.float64)
        out = parallel.sharded_ensemble_anm_fluctuations(
            batch, sd_params, mesh, dtype=f32, use_pallas=True)
        shape("8c", out["msf"], (n_batch, n_atoms))
        within("8c", out["msf"], ref["msf"])
        return out

    def refinement():
        vals, _, res = modes.refine_modes_f64(coord_t, params,
                                              state["modes"][1],
                                              layout="xyz")
        shape("9", vals, (3,))
        finite("9", vals)
        check(float(res.max()) < 1e-2,
              f"dryrun 9: refined residual {float(res.max()):.3e}")
        return vals, res

    return [("1", ensemble), ("2", mean_msf), ("2b", fluctuations),
            ("3", pipeline), ("4", all_mode_msf), ("5", modes_matfree),
            ("6", linear_response), ("6b", msf_stochastic),
            ("6c", effector_sensor), ("7", banded), ("8", blocked_engine),
            ("8b", headline_engine), ("8c", tabulated), ("9", refinement)]


def multi_device_paths(allmode_msf, card):
    """The multi-device layer (``parallel/{mesh,sharded,blocked}.py``) on
    two meshes, every card and four entries over cuda:0 (row axis 2), each
    path from zero launch counts: the headline under sharding against the
    unsharded call (rates beside each other); the all-mode MSF at 20,736
    dimensions by the blocked Cholesky (panels of SHARDED_BLOCK) against
    the golden and `allmode_msf`, ``pinv_diagonal``'s; the Chebyshev solve
    over K12 row ranges at K12's 10,000-atom ``pfenm`` shape against the
    single-device dense-grid solve (the same explicit oversampling) and
    through its float64 residuals; the dryrun's 14 blocks.  Returns
    ``{path: launches}``."""
    import numpy as np
    import torch

    import springcraft_tpu_torch as sct
    from springcraft_tpu_torch import parallel
    from springcraft_tpu_torch.ops import matfree

    cuda0 = torch.device("cuda", 0)
    meshes = {"cards": parallel.make_mesh(),
              "cuda0x4": parallel.make_mesh(4, row_axis=2,
                                            devices=[cuda0] * 4)}
    launches = {}
    params = sct.invariant_params(CUTOFF)
    conformers = make_conformers(N_CONFORMERS, N_RES, SEED)
    headline = dict(inverse="blocked", use_pallas=True,
                    with_covariance=False, chunk=CHUNK)
    plain = sct.ensemble_anm_fluctuations(conformers, params, **headline)
    plain_rates = [len(conformers) / timed(
        lambda: sct.ensemble_anm_fluctuations(conformers, params,
                                              **headline))
        for _ in range(2)]
    golden = np.load(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), GOLDEN_MSF))
    n_all = int(golden["n_res"])
    atoms = make_ca_atoms(n_all, seed=int(golden["seed"]))
    sd_params = sct.TabulatedForceField.sd_enm(atoms).to_compact_params()
    truth = torch.as_tensor(golden["msf"], device=cuda0)
    nd, k = N_MATFREE_DENSE, MATFREE_MODES
    coord_d = matfree_coord(nd)
    cd64 = torch.as_tensor(coord_d, dtype=torch.float64, device=cuda0)
    pfenm = sct.pfenm_params(None)
    modes_options = dict(degree=96, n_outer=10, tol=MATFREE_TOL,
                         oversample=max(k, 8, 48 - k))
    ref_modes = sct.lowest_modes_matfree(coord_d, pfenm, k, sparse=False,
                                         **modes_options)
    for name, mesh in meshes.items():
        at = f"@{name}"
        print(f"mesh {name}: {mesh.shape} over "
              f"{[str(dev) for dev in mesh.flat]}", flush=True)

        def sharded_headline():
            return parallel.sharded_ensemble_anm_fluctuations(
                conformers, params, mesh, **headline)

        path = "sharded_headline" + at
        out, seconds, launches[path] = drive(path, sharded_headline)
        check_outputs(path, out, {key: tuple(value.shape)
                                  for key, value in plain.items()})
        errs = {key: max_errors(out[key], plain[key])[1] for key in plain}
        same = all(torch.equal(out[key], plain[key]) for key in plain)
        rates = [len(conformers) / s for s in
                 [seconds] + [timed(sharded_headline) for _ in range(2)]]
        print(f"{path}: {N_CONFORMERS} x N={N_RES} in chunks of {CHUNK} "
              f"over {mesh.size} shards: "
              + ", ".join(f"{r:.1f}" for r in rates)
              + " solves/s (first run counted), unsharded "
              + ", ".join(f"{r:.1f}" for r in plain_rates)
              + f"; against the unsharded call max rel err "
              f"{max(errs.values()):.3e} (tol {SHARDED_HEADLINE_TOL:g}), "
              f"bit for bit: {same} on [{card}]", flush=True)
        check(max(errs.values()) <= SHARDED_HEADLINE_TOL,
              f"{path}: {errs} against the unsharded call")
        del out

        path = "sharded_allmode_msf" + at
        torch.cuda.empty_cache()
        out, seconds, launches[path] = drive(
            path, lambda: parallel.sharded_all_mode_msf(
                atoms.coord, sd_params, mesh, block=SHARDED_BLOCK))
        peak = torch.cuda.max_memory_allocated() / 2**30
        msf = out["msf"].double()
        err, err_pinv = rel_rmse(msf, truth), rel_rmse(msf, allmode_msf)
        print(f"{path}: n={n_all} ({3 * n_all} dimensions) sdENM float32, "
              f"blocked Cholesky in {3 * n_all // SHARDED_BLOCK} panels of "
              f"{SHARDED_BLOCK}: {seconds:.3f} s, peak device memory "
              f"{peak:.2f} GiB; rel RMSE {err:.3e} of the float64 golden "
              f"(tol {MEGA_ALLMODE_TOL:g}), {err_pinv:.3e} of "
              f"pinv_diagonal's (tol {SHARDED_ALLMODE_TOL:g}) on [{card}]",
              flush=True)
        check(bool(torch.isfinite(msf).all()), f"{path}: non-finite MSF")
        check(err <= MEGA_ALLMODE_TOL, f"{path}: rel RMSE {err:.3e}")
        check(err_pinv <= SHARDED_ALLMODE_TOL,
              f"{path}: {err_pinv:.3e} of pinv_diagonal's")
        del out
        torch.cuda.empty_cache()

        path = "sharded_matfree_modes" + at
        (vals, vecs, res), seconds, launches[path] = drive(
            path, lambda: parallel.sharded_lowest_modes_matfree(
                coord_d, pfenm, mesh, k, **modes_options))
        same = bool(torch.equal(vals, ref_modes[0])
                    and torch.equal(vecs, ref_modes[1]))
        rel = float(((vals.double() - ref_modes[0].double()).abs()
                     / ref_modes[0].double().abs()).max())
        print(f"{path}: pfenm, n={nd}, {k} modes, oversample "
              f"{modes_options['oversample']}, {seconds:.3f} s; eigenvalues "
              f"against the single-device dense-grid solve: max rel "
              f"{rel:.3e} (tol {ANCHOR_RTOL:g}; bit for bit expected), "
              f"modes bit for bit: {same} on [{card}]",
              flush=True)
        check(rel <= ANCHOR_RTOL, f"{path}: eigenvalues {rel:.3e} off")
        mode_checks(path, vals, vecs, res,
                    lambda u: matfree.hessian_apply(cd64, u, pfenm,
                                                    dtype=torch.float64),
                    MATFREE_WANTED, MATFREE_TOL)

        times = []
        for block, run in dryrun_blocks(list(mesh.flat)):
            path = f"dryrun_{block}" + at
            _, seconds, launches[path] = drive(path, run)
            times.append(f"{block} {seconds:.3f}")
        print(f"dryrun blocks{at} (s): {', '.join(times)}", flush=True)
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import springcraft_tpu_torch as sct

    card = card_line()
    print(card, flush=True)
    build_kernels()

    params = sct.invariant_params(CUTOFF)
    conformers = make_conformers(N_CONFORMERS, N_RES, SEED)
    single = make_conformers(1, N_SINGLE, SEED)[0]
    sd_enm = sct.TabulatedForceField.sd_enm(
        make_ca_atoms(N_RES)).to_compact_params()
    ca_7cal = load_7cal_ca()
    e_anm = sct.TabulatedForceField.e_anm(ca_7cal).to_compact_params()
    check(ca_7cal.array_length() == N_SINGLE, "7cal's CA count")
    chunk = torch.as_tensor(conformers[:CHUNK], device="cuda")
    clock = time.perf_counter()

    def phase(label):
        """The host seconds since the last phase ended, for the run's time
        budget."""
        nonlocal clock
        now = time.perf_counter()
        print(f"phase {label}: {now - clock:.1f} s", flush=True)
        clock = now

    parity = kernel_parity(chunk,
                           torch.as_tensor(single[None], device="cuda"),
                           params)
    table_parity(parity, chunk, sd_enm,
                 torch.as_tensor(ca_7cal.coord[None], device="cuda"), e_anm)
    del chunk
    matfree_parity(parity)
    phase("kernel parity")
    launches = paths(conformers, single, params, card)
    launches.update(tabulated_paths(conformers, sd_enm, ca_7cal.coord, e_anm,
                                    card))
    launches.update(direct_paths(conformers, params, card))
    launches.update(panel_function_path(conformers, params))
    phase("ensemble and single-structure paths")
    launches.update(mode_paths(ca_7cal.coord, e_anm, card))
    phase("mode paths")
    launches.update(model_api_paths(ca_7cal, card))
    phase("model API")
    launches.update(overlay_paths(conformers, ca_7cal, e_anm, card))
    launches.update(matfree_paths(card))
    launches.update(matfree_paths(card, tabulated=True))
    matfree_anchor(parity)
    launches.update(matfree_overlay_paths(card))
    launches.update(large_assembly(parity, card))
    phase("overlay, matrix-free and large paths")
    launches.update(matfree_profile_paths(card))
    phase("matfree_profile_paths")
    launches.update(matfree_xl_paths(parity, card))
    phase("matfree_xl_paths")
    launches.update(large_structure_paths(ca_7cal, e_anm, card))
    phase("large_structure_paths")
    launches.update(mega_north_star(parity, card))
    phase("mega_north_star")
    found, allmode_msf = mega_allmode_msf(parity, card)
    launches.update(found)
    phase("mega_allmode_msf")
    launches.update(multi_device_paths(allmode_msf, card))
    phase("multi_device_paths")

    kernels = []
    for name, (source, replaces, _) in KERNELS.items():
        first = parity[name][0]
        line = {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(count[name] for count in launches.values()),
                "max_abs_err": max(r["max_abs_err"] for r in parity[name]),
                **{key: first[key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")},
                "shape": first["shape"]}
        if len(parity[name]) > 1:
            line["shapes"] = parity[name]
        kernels.append(line)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
