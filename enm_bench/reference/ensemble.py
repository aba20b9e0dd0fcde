"""
The fluctuation observables of ANM conformers in float64: the covariance
is the pseudo-inverse of the Hessian, whose null space is the six rigid
motions of a connected network,

    pinv(H) = (H + s T T^t)^-1 - T T^t / s   (T orthonormal, any s > 0),

taken by a float64 Cholesky inverse with ``s`` the mean diagonal.  The
observables, in the xyz layout of the covariance ``C``:

* plane traces ``P_ij = sum_a C[a n + i, a n + j]``;
* ``msf_i = P_ii``, ``bfactor = 8 pi^2 msf / 3``;
* ``dcc_ij = P_ij / sqrt(P_ii P_jj)`` (normalized);
* ``prs_ij = sum_ab C[a n + i, b n + j]^2 / prs_ii`` (each row divided by
  its diagonal), ``effector_i`` the mean of row i and ``sensor_j`` the
  mean of column j, the diagonal left out.
"""

from __future__ import annotations

import torch

from .springs import bfactor_from_msf, hessian_xyz, rigid_basis

#: What this reference computes, by the program's output names.
OBSERVABLES = ("msf", "bfactor", "dcc", "covariance", "prs", "effector",
               "sensor")


def pseudo_inverse(h, t):
    """``pinv(h)`` ``(..., m, m)`` of Hessians whose null space is
    spanned by the orthonormal `t` ``(..., m, 6)``; NaN for a Hessian
    with a null space beyond `t` (a disconnected network)."""
    s = torch.diagonal(h, dim1=-2, dim2=-1).mean(dim=-1)[..., None, None]
    ttt = t @ t.transpose(-1, -2)
    chol, info = torch.linalg.cholesky_ex(h + s * ttt)
    cov = torch.cholesky_inverse(chol) - ttt / s
    return torch.where((info == 0)[..., None, None], cov,
                       torch.full_like(cov, float("nan")))


def observables(coords, network, keys, options, block=32):
    """The observables named in `keys` of conformers `coords` ``(S, n,
    3)`` (float32, on the device the reference runs on), as float64
    tensors ``(S, ...)``, computed `block` conformers at a time.
    `options` are the traffic's options of the program's call, which
    these observables do not depend on."""
    unknown = set(keys) - set(OBSERVABLES)
    if unknown:
        raise ValueError(f"no reference for {sorted(unknown)}")
    n = coords.shape[-2]
    parts = {key: [] for key in keys}
    for start in range(0, coords.shape[0], block):
        c = coords[start:start + block]
        cov = pseudo_inverse(hessian_xyz(c, network),
                             rigid_basis(c))
        planes = cov.reshape(cov.shape[:-2] + (3, n, 3, n))
        traces = planes[..., 0, :, 0, :] + planes[..., 1, :, 1, :] \
            + planes[..., 2, :, 2, :]
        msf = torch.diagonal(traces, dim1=-2, dim2=-1)
        out = {"msf": msf, "bfactor": bfactor_from_msf(msf),
               "dcc": traces / torch.sqrt(msf[..., :, None]
                                          * msf[..., None, :]),
               "covariance": cov}
        if {"prs", "effector", "sensor"} & set(keys):
            prs = planes.square().sum(dim=(-4, -2))
            diag = torch.diagonal(prs, dim1=-2, dim2=-1)
            prs = prs / diag[..., :, None]
            diag = torch.diagonal(prs, dim1=-2, dim2=-1)
            out["prs"] = prs
            out["effector"] = (prs.sum(dim=-1) - diag) / (n - 1)
            out["sensor"] = (prs.sum(dim=-2) - diag) / (n - 1)
        for key in keys:
            parts[key].append(out[key])
        del cov, planes, traces, out
    return {key: torch.cat(value) for key, value in parts.items()}
