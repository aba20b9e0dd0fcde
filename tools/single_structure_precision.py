"""
Where the float32 error of a single-structure ANM solve comes from, on
one NVIDIA GPU.

Runs ``anm_fluctuations`` (with PRS) of the PyTorch port on the CA trace
of ``tests/data/7cal.pdb`` under the eANM force field and prints, for
every output, the largest error over the largest reference value and the
relative RMSE against the float64 engine on the card, for:

1. the float32 entry point as it is (Hessian kernel, float32
   ``torch.linalg.cholesky_ex`` and ``cholesky_solve``);
2. the blocked engine on the same structure (a batch of one through
   ``ensemble_anm_fluctuations(inverse="blocked")``);
3. the float32 Hessian and rigid-body basis with the factorization and
   the solve in float64 (what the assembly costs);
4. the float32 factor with the solve in float64 (what the factorization
   costs);
5. the float32 factor with a float32 triangular solve and Gram product;

and the extreme eigenvalues of the equilibrated, regularized matrix that
is factored.

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
    report("1 float32 cho_solve engine",
           sct.anm_fluctuations(ca.coord, params, with_prs=True), ref)
    blocked = sct.ensemble_anm_fluctuations(ca.coord[None], params,
                                            with_prs=True, inverse="blocked")
    report("2 float32 blocked engine",
           {key: value[0] for key, value in blocked.items()}, ref)

    coords = torch.as_tensor(ca.coord[None], device="cuda")
    ref1 = {key: value[None] for key, value in ref.items()}
    h32 = pipeline._build_hessians_batched(coords, params, None)
    t32 = rigid.rigid_modes_anm(coords)

    def observables(cov):
        return pipeline._anm_cov_observables(cov, n, True, True)

    report("3 float32 assembly, float64 factor and solve", observables(
        rigid.covariance_cholesky(h32.double(), t32.double())), ref1)

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
    return 0


if __name__ == "__main__":
    sys.exit(main())
