"""
Where the float32 error of a single-structure ANM solve comes from, on
one NVIDIA GPU.

Runs ``anm_fluctuations`` (with PRS) of the PyTorch port on the CA trace
of ``tests/data/7cal.pdb`` under the eANM force field and prints, for
every output, the largest error over the largest reference value and the
relative RMSE against the float64 engine on the card, for:

1. the float32 entry point as it is (Hessian kernel, then the
   regularization, factorization and solve in float64, cast back);
2. the blocked engine on the same structure (a batch of one through
   ``ensemble_anm_fluctuations(inverse="blocked")``);
3. the all-float32 Cholesky engine the entry point used before (float32
   ``torch.linalg.cholesky_ex`` and ``cholesky_solve``);
4. the float32 factor with the solve in float64 (what the factorization
   costs);
5. the float32 factor with a float32 triangular solve and Gram product;

each of the first three with its time per structure (host clock to a
synchronize, second and third call), then ``gnm_fluctuations`` the same
way, and the extreme eigenvalues of the equilibrated, regularized matrix
that is factored.

Usage:  python tools/single_structure_precision.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.realpath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import springcraft_tpu_torch as sct  # noqa: E402
from springcraft_tpu_torch.ops import rigid  # noqa: E402
from springcraft_tpu_torch.parallel import pipeline  # noqa: E402


def report(label, out, ref):
    parts = []
    for key, r in ref.items():
        x, r = out[key].double(), r.double()
        worst = float((x - r).abs().max() / r.abs().max())
        rmse = float(((x - r) ** 2).mean().sqrt() / (r ** 2).mean().sqrt())
        parts.append(f"{key} max {worst:.3e} rmse {rmse:.3e}")
    print(f"{label}: " + "; ".join(parts), flush=True)


def timed_twice(fn):
    """Milliseconds of two further calls of `fn`, each to a synchronize."""
    out = []
    for _ in range(2):
        out.append(cs.timed(fn) * 1e3)
    return ", ".join(f"{ms:.1f}" for ms in out) + " ms"


def main():
    if not torch.cuda.is_available():
        print("single_structure_precision: no CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    ca = cs.load_7cal_ca()
    n = ca.array_length()
    params = sct.TabulatedForceField.e_anm(ca).to_compact_params()
    ref = sct.anm_fluctuations(ca.coord.astype(np.float64), params,
                               with_prs=True, dtype=torch.float64)
    coords = torch.as_tensor(ca.coord[None], device="cuda")
    ref1 = {key: value[None] for key, value in ref.items()}

    def entry_point():
        return sct.anm_fluctuations(ca.coord, params, with_prs=True)

    def blocked():
        return sct.ensemble_anm_fluctuations(ca.coord[None], params,
                                             with_prs=True, inverse="blocked")

    def all_float32():
        return pipeline._anm_chunk(coords, params, None, "cho_solve", True,
                                   True, True)

    report("1 float32 entry point (float64 factor and solve)",
           entry_point(), ref)
    print("  time per structure: " + timed_twice(entry_point), flush=True)
    report("2 float32 blocked engine", blocked(), ref1)
    print("  time per structure: " + timed_twice(blocked), flush=True)
    report("3 all-float32 Cholesky engine", all_float32(), ref1)
    print("  time per structure: " + timed_twice(all_float32), flush=True)

    h32 = pipeline._build_hessians_batched(coords, params, None)
    t32 = rigid.rigid_modes_anm(coords)

    def observables(cov):
        return pipeline._anm_cov_observables(cov, n, True, True)

    reg, scale, sigma = rigid._regularize_equilibrated(h32, t32)
    chol = torch.linalg.cholesky_ex(reg)[0]
    eye = torch.eye(3 * n, dtype=torch.float64, device="cuda")[None]
    scale64 = scale.double()
    inv = torch.cholesky_solve(eye, chol.double()) \
        * scale64[..., :, None] * scale64[..., None, :]
    report("4 float32 factor, float64 solve", observables(
        inv - rigid._null_projector(t32.double(), sigma.double())), ref1)

    w = torch.linalg.solve_triangular(chol, eye.float(), upper=False) \
        * scale[..., None, :]
    report("5 float32 factor, float32 triangular solve and Gram",
           observables(w.mT @ w - rigid._null_projector(t32, sigma)), ref1)

    vals = torch.linalg.eigvalsh(reg.double())[0]
    print(f"equilibrated matrix ({3 * n} dimensions): eigenvalues "
          f"{float(vals[0]):.4e} to {float(vals[-1]):.4e}, condition "
          f"{float(vals[-1] / vals[0]):.3e}", flush=True)
    del h32, reg, chol, inv, w, eye

    gref = sct.gnm_fluctuations(ca.coord.astype(np.float64), params,
                                dtype=torch.float64)

    def gnm_entry():
        return sct.gnm_fluctuations(ca.coord, params)

    def gnm_float32():
        return pipeline._gnm_chunk(coords, params, None, "cho_solve", True)

    report("GNM 1 float32 entry point (float64 factor and solve)",
           gnm_entry(), gref)
    print("  time per structure: " + timed_twice(gnm_entry), flush=True)
    report("GNM 3 all-float32 Cholesky engine", gnm_float32(),
           {key: value[None] for key, value in gref.items()})
    print("  time per structure: " + timed_twice(gnm_float32), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
