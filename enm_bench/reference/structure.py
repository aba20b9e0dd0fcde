"""
The lowest non-trivial ANM modes of single structures in float64.

The Hessian is ``springs.py``'s: the network that a float32 program sees
(which pairs interact, and in which sdENM bin, decided on the float32
squared distances of the float32 coordinates), every value float64.  It is
assembled here in row blocks of atoms from the spring constants of
``springs.Network``, without the ``(n, n, 3)`` displacements at once.

Its `modes` lowest non-trivial eigenpairs, with the six rigid-body motions
``T`` (orthonormal, ``springs.rigid_basis``) projected out:

* up to ``EIGH_MAX_DIM`` dimensions, ``torch.linalg.eigh``;
* beyond, subspace iteration on the inverse of ``H + s T T^t`` (``s`` the
  mean diagonal), through its own float64 Cholesky factor, a block of
  ``2 modes + 8`` columns projected off ``T`` every step, with a
  Rayleigh-Ritz on ``H`` after each, until every wanted pair's residual
  ``|H v - theta v| / theta`` is at most ``RESIDUAL`` (or ``MAX_ITER``
  steps: the residual reached is returned beside the pairs and printed).

Observables, by the names the route keys the program's outputs:

* ``eig_values``: the `modes` lowest non-trivial eigenvalues;
* ``msf``: the mode-sum MSF over them, ``msf_i = sum_k sum_a v_k[a n +
  i]^2 / lambda_k`` (xyz layout), blind to the modes' signs and to
  rotations within a degenerate pair.
"""

from __future__ import annotations

import sys

import torch

from .springs import _sq32, rigid_basis

#: What this reference computes, by the names of the route's outputs.
OBSERVABLES = ("eig_values", "msf")
#: Largest dimension solved by a dense ``eigh``.
EIGH_MAX_DIM = 6000
#: Residual ``|H v - theta v| / theta`` every wanted pair reaches.
RESIDUAL = 1e-9
MAX_ITER = 200
#: Atom rows of the Hessian assembled at a time.
ROW_BLOCK = 1000


def hessian_xyz(coord, network, rows=ROW_BLOCK):
    """The float64 ANM Hessian ``(3n, 3n)`` (xyz plane layout) of one
    structure's float32 coordinates `coord` ``(n, 3)``, `rows` atom rows
    at a time: the matrix of ``springs.hessian_xyz``."""
    c32 = coord.to(torch.float32)
    c64 = c32.to(torch.float64)
    n = c32.shape[0]
    k = network.constants(_sq32(c32))
    h = torch.zeros((3 * n, 3 * n), dtype=torch.float64, device=c32.device)
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        d = c64[r0:r1, None, :] - c64[None, :, :]
        sq = (d * d).sum(dim=-1)
        g = k[r0:r1] / torch.where(sq == 0, torch.ones_like(sq), sq)
        idx = torch.arange(r0, r1, device=c32.device)
        for a in range(3):
            for b in range(3):
                block = -g * d[..., a] * d[..., b]
                h[a * n + r0:a * n + r1, b * n:(b + 1) * n] = block
                h[a * n + idx, b * n + idx] = -block.sum(dim=-1)
        del d, sq, g
    return h


def _project(t, x):
    return x - t @ (t.T @ x)


def _residuals(hx, x, theta):
    return torch.linalg.vector_norm(hx - x * theta, dim=0) / theta.abs()


def lowest_modes(h, t, modes, residual=RESIDUAL, max_iter=MAX_ITER,
                 eigh_max_dim=EIGH_MAX_DIM):
    """The `modes` lowest eigenpairs of the PSD `h` ``(m, m)`` off the
    span of the orthonormal `t` ``(m, 6)``: ``(values (modes,), vectors
    (m, modes), residual reached)``, float64."""
    m = h.shape[0]
    if m <= eigh_max_dim:
        theta, v = torch.linalg.eigh(h)
        theta, v = theta[6:6 + modes], v[:, 6:6 + modes]
        return theta, v, float(_residuals(h @ v, v, theta).max())
    s = torch.diagonal(h).mean()
    a = torch.addmm(h, t, t.T, alpha=s)
    chol, info = torch.linalg.cholesky_ex(a)
    del a
    if int(info) != 0:
        raise RuntimeError("H + s T T^t is not positive definite: the "
                           "network is not connected")
    p = 2 * modes + 8
    gen = torch.Generator(device=h.device).manual_seed(0)
    x = torch.randn((m, p), dtype=h.dtype, device=h.device, generator=gen)
    reached = float("inf")
    for _ in range(max_iter):
        x = torch.linalg.qr(_project(t, torch.cholesky_solve(
            _project(t, x), chol)))[0]
        hx = h @ x
        small = x.T @ hx
        theta, w = torch.linalg.eigh((small + small.T) / 2)
        x, hx = x @ w, hx @ w
        reached = float(_residuals(hx[:, :modes], x[:, :modes],
                                   theta[:modes]).max())
        if reached <= residual:
            break
    return theta[:modes], x[:, :modes], reached


def mode_msf(values, vectors):
    """Mode-sum MSF ``(n,)`` of modes in columns ``(3n, k)`` (xyz layout)
    with eigenvalues ``(k,)``."""
    n = vectors.shape[0] // 3
    weights = vectors.reshape(3, n, -1).square().sum(dim=0)
    return (weights / values).sum(dim=-1)


def observables(coords, network, keys, options):
    """The observables named in `keys` of the structures `coords` ``(S,
    n, 3)`` (float32, on the device the reference runs on), float64
    ``(S, ...)``; `options` gives ``modes``, the number of lowest
    non-trivial modes."""
    unknown = set(keys) - set(OBSERVABLES)
    if unknown:
        raise ValueError(f"no reference for {sorted(unknown)}")
    modes = int(options["modes"])
    out = {key: [] for key in keys}
    for coord in coords:
        h = hessian_xyz(coord, network)
        theta, v, reached = lowest_modes(h, rigid_basis(coord), modes)
        del h
        print(f"enm_bench: reference modes of {coord.shape[0]} atoms: "
              f"residual {reached:.3e} (stated {RESIDUAL:g})",
              file=sys.stderr)
        found = {"eig_values": theta, "msf": mode_msf(theta, v)}
        for key in keys:
            out[key].append(found[key])
    return {key: torch.stack(value) for key, value in out.items()}
